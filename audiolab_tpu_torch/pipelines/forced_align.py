"""Forced alignment for word-level timestamps (a copy of the JAX package's
host code, audiolab_tpu/pipelines/forced_align.py; no framework is used;
the backtrack keeps its state a Python int, see ``ctc_forced_align``).

1. ``ctc_forced_align`` — the CTC trellis/backtrack WhisperX uses, in
   float64 numpy over any per-frame label log-posteriors (the wav2vec2
   aligner's, models/wav2vec2.py).
2. ``energy_align_words`` — a dependency-free acoustic aligner used when no
   CTC aligner is loaded: word boundaries are placed where cumulative voiced
   energy matches cumulative character mass, then snapped to energy onsets.
"""

from __future__ import annotations

import numpy as np


def ctc_forced_align(
    log_probs: np.ndarray, tokens: np.ndarray, blank: int = 0
) -> list[tuple[int, int]]:
    """Viterbi forced alignment of ``tokens`` through CTC ``log_probs``.

    log_probs: (T, V) per-frame log posteriors; tokens: (L,) target ids.
    Returns per-token (start_frame, end_frame_exclusive).
    """
    lp = np.asarray(log_probs, np.float64)
    toks = np.asarray(tokens, np.int64)
    t_frames, _ = lp.shape
    l = len(toks)
    if l == 0 or t_frames == 0:
        return []
    # extended sequence: blank, t0, blank, t1, ... blank  (2L+1)
    ext = np.full(2 * l + 1, blank, np.int64)
    ext[1::2] = toks
    s = len(ext)
    obs = lp[:, ext]  # (T, S)

    neg = -1e30
    score = np.full((t_frames, s), neg)
    ptr = np.zeros((t_frames, s), np.int8)  # 0 stay, 1 from s-1, 2 from s-2
    score[0, 0] = obs[0, 0]
    if s > 1:
        score[0, 1] = obs[0, 1]
    for t in range(1, t_frames):
        stay = score[t - 1]
        prev1 = np.concatenate([[neg], score[t - 1, :-1]])
        prev2 = np.concatenate([[neg, neg], score[t - 1, :-2]])
        # skip-transition (s-2) is illegal into blanks and repeated labels
        skip_ok = np.zeros(s, bool)
        skip_ok[2::2] = False
        idx = np.arange(3, s, 2)
        skip_ok[idx] = ext[idx] != ext[idx - 2]
        if s > 1:
            skip_ok[1] = False
        prev2 = np.where(skip_ok, prev2, neg)
        best = np.maximum(np.maximum(stay, prev1), prev2)
        choice = np.where(best == prev2, 2, np.where(best == prev1, 1, 0))
        score[t] = best + obs[t]
        ptr[t] = choice
    # end at last blank or last token
    end_s = s - 1 if score[-1, s - 1] >= score[-1, s - 2] else s - 2
    path = np.zeros(t_frames, np.int64)
    cur = end_s
    for t in range(t_frames - 1, -1, -1):
        path[t] = cur
        if t:
            # a Python int: NumPy 2 keeps int - int8 in int8, which overflows
            # past state 127 (64 tokens) where the JAX package's copy raises
            cur -= int(ptr[t, cur])
    spans: list[tuple[int, int]] = []
    for k in range(l):
        sidx = 2 * k + 1
        frames = np.nonzero(path == sidx)[0]
        if len(frames):
            spans.append((int(frames[0]), int(frames[-1]) + 1))
        else:  # degenerate (token squeezed out): reuse neighbor boundary
            prev_end = spans[-1][1] if spans else 0
            spans.append((prev_end, prev_end + 1))
    return spans


def _frame_energy(x: np.ndarray, sr: int, hop_s: float = 0.01) -> tuple[np.ndarray, float]:
    hop = max(1, int(sr * hop_s))
    n_frames = max(1, len(x) // hop)
    e = np.square(x[: n_frames * hop].reshape(n_frames, hop)).mean(axis=1)
    # light smoothing (±2 frames) so single-sample clicks don't count
    k = np.array([0.15, 0.2, 0.3, 0.2, 0.15])
    e = np.convolve(np.pad(e, 2, mode="edge"), k, mode="valid")
    return e, hop / sr


def energy_align_words(
    audio: np.ndarray,
    sr: int,
    start: float,
    end: float,
    words: list[str],
) -> list[dict]:
    """Place word boundaries where cumulative voiced energy matches
    cumulative character mass, then snap starts to energy onsets."""
    if not words:
        return []
    i0, i1 = int(start * sr), min(int(end * sr), len(audio))
    seg = np.asarray(audio[i0:i1], np.float32)
    if len(seg) < sr // 50:
        return _uniform(words, start, end)
    e, dt = _frame_energy(seg, sr)
    thresh = max(e.max() * 0.05, np.median(e) * 0.5)
    voiced = np.where(e > thresh, e, 0.0)
    total = voiced.sum()
    if total <= 0:
        return _uniform(words, start, end)
    cum = np.concatenate([[0.0], np.cumsum(voiced)]) / total
    mass = np.cumsum([0.0] + [max(len(w), 1) for w in words])
    mass = mass / mass[-1]
    # boundary frame for each cumulative char fraction
    bounds = np.searchsorted(cum, mass, side="left").clip(0, len(e))
    onsets = np.nonzero((e[1:] > thresh) & (e[:-1] <= thresh))[0] + 1
    offsets = np.nonzero((e[:-1] > thresh) & (e[1:] <= thresh))[0] + 1

    # pass 1: word starts — cumulative-mass boundary snapped to the nearest
    # energy onset (within 120 ms so long words aren't dragged away)
    starts = []
    for k in range(len(words)):
        b0 = int(bounds[k])
        if len(onsets):
            near = int(onsets[np.argmin(np.abs(onsets - b0))])
            # snap when close (120 ms), or further (250 ms) if the onset's
            # cumulative mass still roughly matches this word's target —
            # keeps word starts on speech onsets without dragging words
            # around inside long continuous runs
            d = abs(near - b0) * dt
            if d <= 0.12 or (d <= 0.25
                             and abs(cum[near] - mass[k]) <= 0.15):
                b0 = near
        starts.append(b0)
    for k in range(1, len(starts)):  # keep ascending
        starts[k] = max(starts[k], starts[k - 1] + 1)

    # pass 2: word ends — the last energy offset before the next word
    # starts (speech stops there), else the next start / segment end
    out = []
    for k, w in enumerate(words):
        limit = starts[k + 1] if k + 1 < len(words) else len(e)
        cands = offsets[(offsets > starts[k]) & (offsets <= limit)]
        b1 = int(cands[-1]) if len(cands) else int(limit)
        b1 = max(b1, starts[k] + 1)
        out.append({
            "word": w,
            "start": round(start + starts[k] * dt, 3),
            "end": round(start + b1 * dt, 3),
        })
    return out


def _uniform(words: list[str], start: float, end: float) -> list[dict]:
    dur = (end - start) / len(words)
    return [{"word": w, "start": round(start + i * dur, 3),
             "end": round(start + (i + 1) * dur, 3)}
            for i, w in enumerate(words)]
