"""f0 estimation of the RVC path (counterpart of audiolab_tpu/dsp/f0.py).

- :func:`f0_autocorr`: YIN by FFT cross-correlation, every frame at once,
  in torch on the input's device (fp32).
- :func:`coarse_f0`: RVC's 1-255 mel-scale pitch bins.
- :func:`merge_f0`: the hybrid merge over methods, voiced frames only.
- The WORLD family (:func:`f0_pm`, :func:`f0_dio`, :func:`f0_harvest`,
  :func:`stonemask`): host numpy, a copy of the JAX package's
  framework-free implementations, so that both packages give the same
  arrays bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def f0_autocorr(x: torch.Tensor, sr: int = 16000, hop: int = 160, fmin: float = 50.0,
                fmax: float = 1100.0, frame_length: int = 1024,
                threshold: float = 0.15) -> tuple[torch.Tensor, torch.Tensor]:
    """YIN f0 of ``(..., n)`` -> (f0 Hz ``(..., T)``, voiced probability
    ``(..., T)``), T = n // hop + 1; unvoiced frames get 0 Hz."""
    tau_min = max(2, int(sr / fmax))
    tau_max = int(np.ceil(sr / fmin))
    w = frame_length
    span = w + tau_max
    dev = x.device
    n = x.shape[-1]
    t_frames = n // hop + 1
    xp = F.pad(x.float(), (w // 2, span))     # tail pad: every frame has full support
    idx = (torch.arange(t_frames, device=dev)[:, None] * hop
           + torch.arange(span, device=dev)[None, :])
    frames = xp[..., idx]                     # (..., T, span)

    # r(tau) = sum_{j<w} x_j x_{j+tau} by FFT cross-correlation
    nfft = int(2 ** np.ceil(np.log2(span + w)))
    f_full = torch.fft.rfft(frames, n=nfft)
    f_head = torch.fft.rfft(frames[..., :w], n=nfft)
    r = torch.fft.irfft(f_full * torch.conj(f_head), n=nfft)[..., : tau_max + 1]

    # energy terms by cumulative sums
    cs = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    e0 = cs[..., w] - cs[..., 0]
    taus = torch.arange(tau_max + 1, device=dev)
    e_tau = cs[..., taus + w] - cs[..., taus]
    d = torch.clamp(e0[..., None] + e_tau - 2.0 * r, min=0.0)   # difference function
    csum = torch.cumsum(d[..., 1:], dim=-1)
    cmnd = torch.cat([torch.ones_like(d[..., :1]), d[..., 1:] * taus[1:] / (csum + 1e-9)],
                     dim=-1)

    inf = torch.full_like(cmnd, float("inf"))
    cmnd_v = torch.where(taus >= tau_min, cmnd, inf)
    # first local minimum under the threshold (YIN step 4), else the global one
    nxt = torch.cat([cmnd_v[..., 1:], inf[..., :1]], dim=-1)
    is_min = (cmnd_v < threshold) & (cmnd_v <= nxt)
    any_below = is_min.any(dim=-1)
    first_below = is_min.to(torch.uint8).argmax(dim=-1)
    global_min = cmnd_v.argmin(dim=-1)
    tau_star = torch.where(any_below, first_below, global_min)

    # parabolic interpolation around tau_star for a sub-sample lag
    tm = torch.clamp(tau_star, tau_min + 1, tau_max - 1)
    dm1 = torch.gather(cmnd, -1, (tm - 1)[..., None])[..., 0]
    d0 = torch.gather(cmnd, -1, tm[..., None])[..., 0]
    dp1 = torch.gather(cmnd, -1, (tm + 1)[..., None])[..., 0]
    denom = dm1 - 2.0 * d0 + dp1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (dm1 - dp1) / denom, torch.zeros_like(denom))
    tau_f = tm.float() + torch.clamp(delta, -1.0, 1.0)

    f0 = sr / torch.clamp(tau_f, min=1.0)
    min_cmnd = cmnd_v.amin(dim=-1)
    has_energy = e0 > 1e-6 * w       # silence gate (zero frames have cmnd 0/0)
    voiced = (min_cmnd < 0.5) & has_energy
    voiced_prob = torch.where(has_energy, torch.clamp(1.0 - min_cmnd, 0.0, 1.0),
                              torch.zeros_like(min_cmnd))
    f0 = torch.where(voiced & (f0 >= fmin) & (f0 <= fmax), f0, torch.zeros_like(f0))
    return f0, voiced_prob


def coarse_f0(f0: torch.Tensor, f0_min: float = 50.0, f0_max: float = 1100.0) -> torch.Tensor:
    """Quantize f0 (Hz) to RVC's 1-255 mel-scale pitch bins (int64)."""
    f0_mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * 254.0 / (f0_mel_max - f0_mel_min) + 1.0
    scaled = torch.where(f0_mel > 0.0, scaled, torch.ones_like(scaled))
    return torch.clamp(torch.round(scaled), 1, 255).long()


def merge_f0(stack: torch.Tensor, merge_type: str = "median") -> torch.Tensor:
    """Merge an (m, ...) stack of f0 tracks over the voiced entries only (a
    plain median over [0, f, f'] would halve the pitch at one method's
    dropout); a frame stays voiced when most methods voice it."""
    voiced = stack > 0.0
    n_voiced = voiced.sum(dim=0)
    m = stack.shape[0]
    if merge_type == "mean":
        s = torch.where(voiced, stack, torch.zeros_like(stack)).sum(dim=0)
        merged = s / torch.clamp(n_voiced, min=1)
    else:
        # median of the voiced prefix after sorting the unvoiced to +inf
        srt = torch.where(voiced, stack, torch.full_like(stack, float("inf"))).sort(dim=0).values
        lo = torch.clamp((n_voiced - 1) // 2, 0, m - 1)
        hi = torch.clamp(n_voiced // 2, 0, m - 1)
        merged = 0.5 * (torch.gather(srt, 0, lo[None])[0] + torch.gather(srt, 0, hi[None])[0])
    return torch.where(n_voiced * 2 > m, merged, torch.zeros_like(merged))


# ---------------------------------------------------------------------------
# WORLD-family estimators (dio / harvest / stonemask)
#
# The reference's dio & harvest methods call the pyworld C++ library and then
# refine with pyworld.stonemask (modules/rvc/pitch_extraction.py:172-191,
# frame_period = 1000*hop/sr).  These are host-numpy implementations of the
# published WORLD algorithms (Morise 2009 DIO, Morise 2017 Harvest, StoneMask
# IF refinement): half/24th-octave filter channels, four-interval candidate
# events, stability scoring, the four contour fix steps, and harmonic
# instantaneous-frequency refinement.  A copy of the JAX package's host code
# (audiolab_tpu/dsp/f0.py), which the port's tests hold bit-identical to it.
# ---------------------------------------------------------------------------


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) * (2.0 * np.pi / max(n - 1, 1))
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _filter_signal(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Zero-phase-ish FFT convolution, trimmed to len(x) with the kernel
    delay removed (WORLD applies its FIRs the same way)."""
    n = len(x)
    m = len(kernel)
    nfft = int(2 ** np.ceil(np.log2(n + m)))
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(kernel, nfft), nfft)
    d = m // 2
    return y[d:d + n]


def _four_interval_candidates(
    y: np.ndarray, sr: int, centers: np.ndarray
) -> tuple[np.ndarray, np.ndarray] | None:
    """The DIO/Harvest event detector: from one filtered channel, build four
    independent f0 contours — negative-going zero crossings, positive-going
    zero crossings, peak intervals and dip intervals — interpolated to frame
    times.  Returns (4, T) f0 tracks or None if any event list is too short.
    """
    tracks = []
    for sig in (y, -y, np.diff(y, prepend=y[:1]),
                -np.diff(y, prepend=y[:1])):
        pos = sig > 0.0
        rise = np.nonzero(~pos[:-1] & pos[1:])[0]
        if len(rise) < 3:
            return None
        frac = sig[rise] / np.maximum(np.abs(sig[rise] - sig[rise + 1]), 1e-12)
        locs = rise + np.clip(frac, 0.0, 1.0)
        periods = np.diff(locs)
        good = periods > 0
        if good.sum() < 2:
            return None
        mids = 0.5 * (locs[:-1] + locs[1:])[good]
        f0s = sr / periods[good]
        tracks.append(np.interp(centers, mids, f0s, left=f0s[0], right=f0s[-1]))
    return np.stack(tracks)


def _channel_candidates(
    x: np.ndarray, sr: int, centers: np.ndarray, boundary_f0: float,
    fmin: float, fmax: float, bandpass: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """One WORLD channel: filter around/below ``boundary_f0`` and score the
    agreement of the four interval contours.  Returns (f0_candidate (T,),
    deviation score (T,) — lower is better, inf = invalid)."""
    half_len = max(2, int(round(sr / boundary_f0 / 2.0)))
    filt = _nuttall(4 * half_len)
    if bandpass:  # Harvest: Nuttall-windowed cosine centred at boundary_f0
        t = (np.arange(4 * half_len) - 2.0 * half_len) / sr
        filt = filt * np.cos(2.0 * np.pi * boundary_f0 * t)
    filt = filt / (np.abs(filt).sum() + 1e-12)
    y = _filter_signal(x, filt)
    tr = _four_interval_candidates(y, sr, centers)
    T = len(centers)
    if tr is None:
        return np.zeros(T), np.full(T, np.inf)
    mean = tr.mean(axis=0)
    dev = np.sqrt(((tr - mean) ** 2).sum(axis=0) / 3.0) / np.maximum(mean, 1e-6)
    lo = boundary_f0 / 2.0 if not bandpass else boundary_f0 * 0.6
    hi = boundary_f0 if not bandpass else boundary_f0 * 1.2
    ok = (mean >= max(lo, fmin)) & (mean <= min(hi, fmax))
    return np.where(ok, mean, 0.0), np.where(ok, dev, np.inf)


def _fix_f0_contour(
    best: np.ndarray, cand_all: np.ndarray, hop_s: float, fmin: float,
    allowed_range: float = 0.1,
) -> np.ndarray:
    """WORLD's FixF0Contour: (1) zero frames that jump more than
    ``allowed_range`` relative to their neighbour, (2) drop voiced islands
    shorter than the minimum voice range, (3)+(4) extend every voiced
    section forward/backward by re-selecting, among ALL channel candidates
    of the neighbouring frame, the one closest to the edge f0."""
    f0 = best.copy()
    T = len(f0)
    vrm = int(0.5 + 1.0 / hop_s / fmin) * 2 + 1  # min voiced run (frames)

    # step 1: rapid-change removal
    prev = np.concatenate([[0.0], f0[:-1]])
    jump = np.abs(f0 - prev) / np.maximum(f0, 1e-6)
    f0 = np.where((prev > 0) & (f0 > 0) & (jump > allowed_range), 0.0, f0)

    # step 2: short-segment removal
    voiced = f0 > 0
    out = f0.copy()
    i = 0
    while i < T:
        if voiced[i]:
            j = i
            while j < T and voiced[j]:
                j += 1
            if j - i < vrm:
                out[i:j] = 0.0
            i = j
        else:
            i += 1
    f0 = out

    # steps 3+4: extend sections using the nearest channel candidate
    def _extend(f0v: np.ndarray, forward: bool) -> np.ndarray:
        g = f0v if forward else f0v[::-1]
        cand = cand_all if forward else cand_all[:, ::-1]
        g = g.copy()
        for t in range(1, T):
            if g[t] == 0.0 and g[t - 1] > 0.0:
                ref = g[t - 1]
                c = cand[:, t]
                d = np.abs(c - ref) / ref
                d = np.where(c > 0, d, np.inf)
                k = int(np.argmin(d))
                if d[k] < allowed_range:
                    g[t] = c[k]
        return g if forward else g[::-1]

    fwd = _extend(f0, True)
    bwd = _extend(f0, False)
    # keep extensions only where both directions agree (WORLD takes the
    # intersection of step-3 and step-4 results)
    agree = (fwd > 0) & (bwd > 0) & \
        (np.abs(fwd - bwd) / np.maximum(fwd, 1e-6) < allowed_range)
    return np.where(f0 > 0, f0, np.where(agree, 0.5 * (fwd + bwd), 0.0))


def stonemask(
    x: np.ndarray,
    f0: np.ndarray,
    sr: int = 16000,
    hop: int = 160,
) -> np.ndarray:
    """WORLD StoneMask refinement (pyworld.stonemask in the reference,
    pitch_extraction.py:180,190): per voiced frame, window ~3 periods,
    estimate instantaneous frequency at each harmonic via Flanagan's
    equation (spectrum + derivative-window spectrum), and replace f0 with
    the amplitude-weighted mean of IF_h / h.  Two passes: 2 harmonics to
    fix the period, then 6 for the final estimate."""
    x = np.asarray(x, np.float64)
    f0 = np.asarray(f0, np.float64)
    n = len(x)
    voiced = f0 > 0.0
    if not voiced.any():
        return f0.copy()
    vt = np.flatnonzero(voiced)
    pos = vt * hop

    # all voiced frames refined in ONE batched pass per iteration: shared
    # max-length window grid, per-frame Blackman window truncated to its
    # own ~3 periods by masking, two batched rFFTs (pyworld's loop is C++;
    # a per-frame python loop here was ~50x slower than the signal)
    max_half = int(1.5 * sr / max(f0[vt].min(), 1.0) + 1)
    nfft = int(2 ** np.ceil(np.log2(2 * max_half + 2) + 1))
    offs = np.arange(-max_half, max_half + 1)
    idx = np.clip(pos[:, None] + offs[None, :], 0, n - 1)
    seg = x[idx]                                    # (V, 2*max_half+1)
    tt = offs / sr
    harm = np.arange(1, 7)

    def _fix(cur: np.ndarray, max_harm: int) -> np.ndarray:
        half = (1.5 * sr / cur + 1).astype(int)
        wlen = (2 * half + 1) / sr                  # (V,)
        inside = np.abs(offs)[None, :] <= half[:, None]
        ph = 2 * np.pi * tt[None, :] / wlen[:, None]
        main = (0.42 + 0.5 * np.cos(ph) + 0.08 * np.cos(2 * ph)) * inside
        diffw = (-(np.pi / wlen[:, None]) * np.sin(ph)
                 - (0.16 * np.pi / wlen[:, None]) * np.sin(2 * ph)) * inside
        S = np.fft.rfft(seg * main, nfft, axis=-1)
        dS = np.fft.rfft(seg * diffw, nfft, axis=-1)
        power = S.real ** 2 + S.imag ** 2
        num_i = S.real * dS.imag - S.imag * dS.real
        freqs = np.arange(S.shape[-1]) * sr / nfft
        inst = freqs[None, :] + np.where(
            power > 1e-12, num_i / np.maximum(power, 1e-12), 0.0) \
            * sr / (2.0 * np.pi)
        hbins = np.clip(np.round(cur[:, None] * harm[None, :] * nfft / sr
                                 ).astype(int), 0, S.shape[-1] - 1)
        rows = np.arange(len(cur))[:, None]
        n_harm = np.clip((sr / 2.0 / cur).astype(int), 1, max_harm)
        hmask = harm[None, :] <= n_harm[:, None]
        amp = np.sqrt(power[rows, hbins]) * hmask
        if_h = inst[rows, hbins] / harm[None, :]
        denom = amp.sum(axis=-1)
        return np.where(denom > 1e-12, (amp * if_h).sum(axis=-1)
                        / np.maximum(denom, 1e-12), 0.0)

    cur = f0[vt]
    tent = _fix(cur, 2)
    tent = np.where(tent > 0.0, tent, cur)
    ref = _fix(tent, 6)
    # reject implausible refinements (WORLD keeps the original there)
    ok = (ref > 0.0) & (np.abs(ref - cur) / cur < 0.2)
    out = f0.copy()
    out[vt] = np.where(ok, ref, cur)
    return out


def f0_dio(
    x: np.ndarray,
    sr: int = 16000,
    hop: int = 160,
    fmin: float = 50.0,
    fmax: float = 1100.0,
    refine: bool = True,
) -> np.ndarray:
    """WORLD DIO (+StoneMask) — the reference's ``dio`` method
    (pitch_extraction.py:182-191: pyworld.dio then pyworld.stonemask).

    Half-octave Nuttall low-pass channels; each channel contributes one
    candidate per frame from the agreement of its four interval event
    trains; the most stable candidate wins; then the four WORLD contour
    fix steps and instantaneous-frequency refinement."""
    x = np.asarray(x, np.float64)
    n = len(x)
    t_frames = n // hop + 1
    centers = np.arange(t_frames) * hop

    n_bands = max(2, int(np.ceil(2.0 * np.log2(fmax / fmin))))
    cands, scores = [], []
    for bi in range(n_bands):
        boundary = fmin * (2.0 ** ((bi + 1) / 2.0))
        c, s = _channel_candidates(x, sr, centers, boundary, fmin, fmax,
                                   bandpass=False)
        cands.append(c)
        scores.append(s)
    cand_all = np.stack(cands)           # (C, T)
    score_all = np.stack(scores)

    best_ch = np.argmin(score_all, axis=0)
    rows = np.arange(t_frames)
    best = cand_all[best_ch, rows]
    best_score = score_all[best_ch, rows]
    # voicing: a stable periodic structure has tiny inter-event deviation
    best = np.where(np.isfinite(best_score) & (best_score < 0.06), best, 0.0)

    best = _fix_f0_contour(best, cand_all, hop / sr, fmin)
    if refine:
        best = stonemask(x, best, sr, hop)
    return np.where((best >= fmin) & (best <= fmax), best, 0.0)


def f0_harvest(
    x: np.ndarray,
    sr: int = 16000,
    hop: int = 160,
    fmin: float = 50.0,
    fmax: float = 1100.0,
    channels_per_octave: float = 12.0,
    refine: bool = True,
) -> np.ndarray:
    """WORLD Harvest (+StoneMask) — the reference's ``harvest`` method
    (pitch_extraction.py:172-180).  Unlike DIO's low-pass half-octave
    banks, Harvest band-passes densely spaced channels (Nuttall-windowed
    cosine), keeps EVERY agreeing channel's candidate, IF-refines each
    candidate, and picks the best per frame by refined stability before
    the shared contour fix steps and a final zero-phase smoothing."""
    x = np.asarray(x, np.float64)
    n = len(x)
    t_frames = n // hop + 1
    centers = np.arange(t_frames) * hop

    n_ch = max(2, int(np.ceil(channels_per_octave * np.log2(fmax / fmin))))
    cands, scores = [], []
    for ci in range(n_ch):
        boundary = fmin * (2.0 ** ((ci + 1) / channels_per_octave))
        c, s = _channel_candidates(x, sr, centers, boundary, fmin, fmax,
                                   bandpass=True)
        cands.append(c)
        scores.append(s)
    cand_all = np.stack(cands)
    score_all = np.stack(scores)

    # Harvest validity is stricter per channel (the band-pass makes each
    # channel ring at its centre, so only near-agreeing events count)
    valid = np.isfinite(score_all) & (score_all < 0.12)
    cand_all = np.where(valid, cand_all, 0.0)
    score_all = np.where(valid, score_all, np.inf)

    best_ch = np.argmin(score_all, axis=0)
    rows = np.arange(t_frames)
    best = cand_all[best_ch, rows]
    best_score = score_all[best_ch, rows]
    best = np.where(np.isfinite(best_score), best, 0.0)

    best = _fix_f0_contour(best, cand_all, hop / sr, fmin,
                           allowed_range=0.18)
    if refine:
        best = stonemask(x, best, sr, hop)

    # final smoothing of voiced runs (Harvest's SmoothF0Contour): short
    # zero-phase moving average applied inside each voiced segment
    sm = best.copy()
    k = 3
    pad = np.pad(best, (k, k), mode="edge")
    win = np.ones(2 * k + 1) / (2 * k + 1)
    avg = np.convolve(pad, win, mode="valid")
    run_ok = np.ones_like(best, bool)
    for off in range(-k, k + 1):
        run_ok &= np.roll(best > 0, off)
    sm = np.where(run_ok, avg, sm)
    return np.where((sm >= fmin) & (sm <= fmax), sm, 0.0)


def f0_pm(
    x: np.ndarray,
    sr: int = 16000,
    hop: int = 160,
    fmin: float = 50.0,
    fmax: float = 1100.0,
    voicing_threshold: float = 0.45,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    vuv_cost: float = 0.14,
    max_candidates: int = 4,
) -> np.ndarray:
    """Praat's autocorrelation pitch algorithm (Boersma 1993) — the
    reference's ``pm`` method (pitch_extraction.py:157-171 via
    parselmouth ``to_pitch_ac``), host-side numpy.

    Per frame: local-mean removal, Hann window, FFT autocorrelation
    normalized by the WINDOW's own autocorrelation (the paper's key
    correction), candidate peaks with octave-cost-penalized strengths and
    an unvoiced candidate from the local/global peak ratio, then a
    Viterbi path with octave-jump and voicing-transition costs.  Peak
    lags get parabolic refinement (Praat uses sinc interpolation — the
    one documented approximation).  Returns f0 (t,) with 0 for unvoiced.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    win_len = int(np.ceil(3.0 / fmin * sr))          # 3 longest periods
    win_len += win_len % 2
    half = win_len // 2
    t_frames = n // hop + 1
    centers = np.arange(t_frames) * hop
    global_peak = np.abs(x - x.mean()).max() + 1e-12

    xp = np.pad(x, (half, half + win_len))
    frames = xp[centers[:, None] + np.arange(win_len)[None, :]]
    frames = frames - frames.mean(axis=1, keepdims=True)
    local_peak = np.abs(frames).max(axis=1)
    win = np.hanning(win_len)
    fw = frames * win

    # autocorrelation via FFT, normalized by the window autocorrelation
    nfft = int(2 ** np.ceil(np.log2(2 * win_len)))
    spec = np.fft.rfft(fw, nfft)
    ac = np.fft.irfft(spec * np.conj(spec), nfft)[:, :win_len]
    ac0 = ac[:, :1] + 1e-12
    wspec = np.fft.rfft(win, nfft)
    wac = np.fft.irfft(wspec * np.conj(wspec), nfft)[:win_len]
    wac = wac / (wac[0] + 1e-12)
    r = (ac / ac0) / np.maximum(wac[None, :], 1e-3)   # (t, win_len)

    lag_min = max(2, int(sr / fmax))
    lag_max = min(win_len - 2, int(np.ceil(sr / fmin)))
    lags = np.arange(lag_min, lag_max)
    seg = r[:, lag_min:lag_max]
    # local maxima of r over the admissible lag range
    is_peak = np.zeros_like(seg, bool)
    is_peak[:, 1:-1] = (seg[:, 1:-1] > seg[:, :-2]) & \
        (seg[:, 1:-1] >= seg[:, 2:])

    # per frame: top-K peak candidates (freq, strength) + unvoiced cand
    k = max_candidates
    cand_f0 = np.zeros((t_frames, k + 1))
    cand_str = np.full((t_frames, k + 1), -1e9)
    peak_vals = np.where(is_peak, seg, -np.inf)
    order = np.argsort(-peak_vals, axis=1)[:, :k]
    rows = np.arange(t_frames)[:, None]
    vals = peak_vals[rows, order]
    lag_sel = lags[order].astype(np.float64)
    # parabolic refinement around each selected peak
    lm = seg[rows, np.maximum(order - 1, 0)]
    lp = seg[rows, np.minimum(order + 1, seg.shape[1] - 1)]
    denom = lm - 2 * vals + lp
    shift = np.where(np.abs(denom) > 1e-12,
                     0.5 * (lm - lp) / np.where(np.abs(denom) > 1e-12,
                                                denom, 1.0), 0.0)
    shift = np.clip(shift, -0.5, 0.5)
    lag_ref = lag_sel + shift
    val_ref = vals - 0.25 * (lm - lp) * shift
    f0s = sr / np.maximum(lag_ref, 1.0)
    ok = np.isfinite(vals) & (f0s >= fmin) & (f0s <= fmax)
    # Boersma: R = r(tau) - OctaveCost * log2(MinimumPitch * tau)
    strength = np.where(
        ok, val_ref - octave_cost * np.log2(
            np.maximum(fmin * lag_ref / sr, 1e-6)), -1e9)
    cand_f0[:, :k] = np.where(ok, f0s, 0.0)
    cand_str[:, :k] = strength
    # unvoiced candidate (Boersma eq. 23)
    ratio = local_peak / global_peak
    cand_str[:, k] = voicing_threshold + np.maximum(
        0.0, 2.0 - (ratio / (silence_threshold
                             / (1.0 + voicing_threshold))))
    cand_f0[:, k] = 0.0

    # Viterbi over candidates
    trans_cost = np.zeros((k + 1, k + 1))
    score = cand_str[0].copy()
    ptr = np.zeros((t_frames, k + 1), np.int64)
    for t in range(1, t_frames):
        f_prev = cand_f0[t - 1]
        f_cur = cand_f0[t]
        pv = f_prev[:, None] > 0
        cv = f_cur[None, :] > 0
        both = pv & cv
        jump = np.where(
            both, octave_jump_cost * np.abs(np.log2(
                np.maximum(f_prev[:, None], 1e-6)
                / np.maximum(f_cur[None, :], 1e-6))), 0.0)
        vuv = np.where(pv ^ cv, vuv_cost, 0.0)
        trans_cost = jump + vuv
        total = score[:, None] - trans_cost
        ptr[t] = np.argmax(total, axis=0)
        score = total[ptr[t], np.arange(k + 1)] + cand_str[t]

    path = np.zeros(t_frames, np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(t_frames - 1, 0, -1):
        path[t - 1] = ptr[t, path[t]]
    return cand_f0[np.arange(t_frames), path]
