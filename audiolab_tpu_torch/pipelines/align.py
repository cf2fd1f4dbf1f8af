"""Multi-take alignment: warp alternate takes onto a master take
(counterpart of audiolab_tpu/pipelines/align.py; reference layouts/align.py).

  - word JSON -> sentence grouping
  - monotonic sentence matching with Levenshtein + duration cost
  - chroma (and, with an ``RtlaCRNN``, phoneme posteriorgram) OLTW warp path
    per matched region
  - crossfaded reassembly of warped regions + a report

The features are taken on ``device`` (the card unless the caller asks for
the CPU); the matching, the DTW and the warp are the JAX package's host
code, copied.  OLTW's argmins and the rounded warp indices follow the
features exactly, so features that differ by rounding can flip a step where
two paths tie.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.models.rtla import (
    OLTW,
    chroma_features,
    make_path_strictly_monotonic,
    phoneme_features,
)


# ------------------------------------------------------------------ text matching

def levenshtein(a: str, b: str) -> int:
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return max(m, n)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[n]


@dataclass
class Sentence:
    text: str
    start: float
    end: float
    words: list = field(default_factory=list)


def group_sentences(words: list[dict], max_gap: float = 0.6,
                    max_words: int = 12) -> list[Sentence]:
    """Word list [{word,start,end}] -> sentences split at punctuation /
    long gaps (align.py:154 grouping)."""
    out: list[Sentence] = []
    cur: list[dict] = []
    for w in words:
        if cur and (w["start"] - cur[-1]["end"] > max_gap or
                    len(cur) >= max_words or
                    cur[-1]["word"].rstrip().endswith((".", "!", "?", ","))):
            out.append(Sentence(" ".join(x["word"] for x in cur),
                                cur[0]["start"], cur[-1]["end"], cur))
            cur = []
        cur.append(w)
    if cur:
        out.append(Sentence(" ".join(x["word"] for x in cur),
                            cur[0]["start"], cur[-1]["end"], cur))
    return out


def match_sentences(master: list[Sentence], take: list[Sentence],
                    w_text: float = 1.0, w_dur: float = 0.3
                    ) -> list[tuple[int, int]]:
    """Monotonic DP assignment master_i -> take_j minimizing normalized
    Levenshtein + duration mismatch (align.py:226)."""
    m, n = len(master), len(take)
    if m == 0 or n == 0:
        return []
    big = 1e9
    cost = np.zeros((m, n))
    for i, s in enumerate(master):
        for j, t in enumerate(take):
            lv = levenshtein(s.text.lower(), t.text.lower()) / max(
                len(s.text), len(t.text), 1)
            dd = abs((s.end - s.start) - (t.end - t.start)) / max(
                s.end - s.start, 0.1)
            cost[i, j] = w_text * lv + w_dur * dd
    D = np.full((m + 1, n + 1), big)
    D[0, :] = 0.0
    skip = 0.8  # cost of leaving a master sentence unmatched
    choice = np.zeros((m + 1, n + 1), np.int8)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            opts = (D[i - 1, j - 1] + cost[i - 1, j - 1],  # match
                    D[i - 1, j] + skip,                     # skip master
                    D[i, j - 1])                            # skip take
            k = int(np.argmin(opts))
            D[i, j] = opts[k]
            choice[i, j] = k
    pairs = []
    i, j = m, n
    while i > 0 and j > 0:
        k = choice[i, j]
        if k == 0:
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif k == 1:
            i -= 1
        else:
            j -= 1
    return pairs[::-1]


# ------------------------------------------------------------------ warping

def _dual_features(wav: np.ndarray, sr: int, hop: int, phoneme_model,
                   device: torch.device) -> np.ndarray:
    """chroma ++ phoneme posteriorgram feature frames (n, d): the reference's
    default FEATURES=["chroma", "phoneme"] stack
    (modules/rtla/stream_processor.py:27-36, config.py FEATURES)."""
    ch = chroma_features(wav, sr, hop, device=device)                  # (t, 12)
    ph = phoneme_features(wav, sr, phoneme_model, device=device).T     # (t', C)
    t = min(len(ch), len(ph))
    if t == 0:
        return ch
    # nearest-frame resample of the phoneme grid onto the chroma grid
    idx = np.minimum((np.arange(len(ch)) * len(ph)) // max(len(ch), 1),
                     len(ph) - 1)
    return np.concatenate([ch, ph[idx]], axis=-1)


def warp_region(take: np.ndarray, sr: int, target_len: int,
                master_region: np.ndarray | None = None,
                hop: int = 512, phoneme_model=None,
                device: str | torch.device = "cuda") -> np.ndarray:
    """Warp a take region onto a master region via OLTW when a master is
    given: chroma features, plus the CRNN phoneme posteriorgram stream when
    ``phoneme_model`` (an ``RtlaCRNN`` on ``device``) is supplied (the
    reference's dual-feature default); otherwise uniform resample to
    length."""
    if master_region is not None and len(master_region) > hop * 4 and len(take) > hop * 4:
        dev = resolve_device(device)
        if phoneme_model is not None:
            ref = _dual_features(master_region, sr, hop, phoneme_model, dev)
            stream = _dual_features(take, sr, hop, phoneme_model, dev)
        else:
            ref = chroma_features(master_region, sr, hop, device=dev)
            stream = chroma_features(take, sr, hop, device=dev)
        path = OLTW(ref, window=32).align(stream)
        path = make_path_strictly_monotonic(path)
        # map master frame -> take frame, build a per-sample index
        t_idx = path[:, 0].astype(np.float64) * hop   # take samples
        j_idx = path[:, 1].astype(np.float64) * hop   # master samples
        master_samples = np.arange(target_len, dtype=np.float64)
        take_pos = np.interp(master_samples, j_idx, t_idx)
        take_pos = np.clip(take_pos, 0, len(take) - 1)
        return take[np.round(take_pos).astype(int)]
    # uniform time-stretch fallback
    src = np.linspace(0, len(take) - 1, target_len)
    return take[np.round(src).astype(int)]


def crossfade_concat(regions: list[np.ndarray], sr: int,
                     fade_ms: float = 30.0) -> np.ndarray:
    fade = int(sr * fade_ms / 1000.0)
    out = regions[0]
    for r in regions[1:]:
        f = min(fade, len(out), len(r))
        if f > 0:
            ramp = np.linspace(0.0, 1.0, f, dtype=np.float32)
            out = np.concatenate([
                out[: len(out) - f],
                out[len(out) - f :] * (1 - ramp) + r[:f] * ramp,
                r[f:],
            ])
        else:
            out = np.concatenate([out, r])
    return out


# ------------------------------------------------------------------ top level

def align_take(
    master: np.ndarray,
    take: np.ndarray,
    sr: int,
    master_words: list[dict],
    take_words: list[dict],
    phoneme_model=None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, dict]:
    """Warp ``take`` onto the master timeline sentence by sentence; returns
    (aligned_take, report).  Features are taken on ``device`` (default the
    card; raises without one)."""
    dev = resolve_device(device)
    ms = group_sentences(master_words)
    ts = group_sentences(take_words)
    pairs = match_sentences(ms, ts)
    regions = []
    report = {"matched": len(pairs), "master_sentences": len(ms),
              "take_sentences": len(ts), "pairs": []}
    cursor = 0.0
    for i, j in pairs:
        s, t = ms[i], ts[j]
        # silence up to the sentence start on the master timeline
        gap = int((s.start - cursor) * sr)
        if gap > 0:
            regions.append(np.zeros(gap, np.float32))
        m0, m1 = int(s.start * sr), int(s.end * sr)
        t0, t1 = int(t.start * sr), int(t.end * sr)
        warped = warp_region(take[t0:t1], sr, m1 - m0, master[m0:m1],
                             phoneme_model=phoneme_model, device=dev)
        regions.append(warped.astype(np.float32))
        cursor = s.end
        report["pairs"].append({"master": s.text, "take": t.text,
                                "start": s.start, "end": s.end})
    tail = int(len(master) - cursor * sr)
    if tail > 0:
        regions.append(np.zeros(tail, np.float32))
    aligned = crossfade_concat(regions, sr) if regions else np.zeros_like(master)
    # pad/trim to the master length exactly
    if len(aligned) < len(master):
        aligned = np.pad(aligned, (0, len(master) - len(aligned)))
    return aligned[: len(master)], report
