"""RVC training data pipeline (counterpart of audiolab_tpu/train/data.py).

Reference behavior (modules/rvc/infer/modules/train/preprocess.py:27-199 and
extract/extract_f0_print.py, extract_feature_print.py, SURVEY §3.4):

  1. Slicer VAD (RMS threshold -42 dB) cuts each source file at silences.
  2. Slices are re-cut to 3.7 s windows with 0.3 s overlap, amplitude-
     normalised (max 0.9, alpha-mix 0.75), and written at BOTH the model
     rate (gt_wavs/) and 16 kHz (16k_wavs/).
  3. f0 (+1-255 coarse) extracted at 100 Hz from the 16 kHz slices.
  4. HuBERT/ContentVec features (50 Hz, 256/768-d) from the 16 kHz slices.
  5. A filelist pairs (gt_wav, feature, f0, f0coarse, speaker_id).

Steps 1, 2 and 5 are the JAX package's host numpy, copied.  Steps 3-4 run on
the device in groups of 8 equal-length slices (HuBERT, YIN and the coarse
bins under ``torch.no_grad``); the loader computes each batch's magnitude
spectrogram on the device and yields dicts of device tensors, in the JAX
loader's order.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.f0 import coarse_f0, f0_autocorr
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.kernels.stft import spectrogram


# ------------------------------------------------------------------ slicer

def slice_silence(
    x: np.ndarray,
    sr: int,
    threshold_db: float = -42.0,
    min_length_ms: float = 1500.0,
    min_interval_ms: float = 400.0,
    hop_ms: float = 15.0,
    max_sil_kept_ms: float = 500.0,
) -> list[np.ndarray]:
    """RMS-threshold silence slicer (reference Slicer semantics,
    preprocess.py:33-40). Returns a list of voiced segments."""
    hop = max(1, int(sr * hop_ms / 1000.0))
    n_frames = max(1, len(x) // hop)
    frames = x[: n_frames * hop].reshape(n_frames, hop)
    rms_db = 20.0 * np.log10(np.sqrt(np.mean(frames**2, axis=1)) + 1e-12)
    voiced = rms_db > threshold_db

    min_frames = int(min_length_ms / hop_ms)
    min_gap = int(min_interval_ms / hop_ms)
    keep = int(max_sil_kept_ms / hop_ms)

    # merge voiced runs separated by short gaps
    segs: list[list[int]] = []
    start = None
    gap = 0
    for i, v in enumerate(voiced):
        if v:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap >= min_gap:
                segs.append([start, i - gap + 1])
                start, gap = None, 0
    if start is not None:
        segs.append([start, n_frames])

    out = []
    for s, e in segs:
        if e - s < min_frames:
            continue
        s = max(0, s - keep)
        e = min(n_frames, e + keep)
        out.append(x[s * hop : e * hop])
    return out if out else ([x] if len(x) else [])


# ------------------------------------------------------------------ preprocess

@dataclass
class PreprocessConfig:
    sr: int = 48000           # model gt rate
    slice_seconds: float = 3.7
    overlap_seconds: float = 0.3
    max_amp: float = 0.9
    alpha: float = 0.75       # normalise mix (preprocess.py norm_write)
    threshold_db: float = -42.0


def _norm_write(seg: np.ndarray, cfg: PreprocessConfig) -> np.ndarray | None:
    peak = np.abs(seg).max() + 1e-9
    if peak > 2.5 or peak < 1e-4:  # reject clipped/silent (preprocess.py:96)
        return None
    y = seg * (cfg.max_amp / peak) * cfg.alpha + (1.0 - cfg.alpha) * seg
    return y.astype(np.float32)


def preprocess_dataset(
    in_dir: str,
    exp_dir: str,
    cfg: PreprocessConfig | None = None,
    src_sr: int | None = None,
) -> int:
    """Slice + normalise + dual-rate write. Returns number of slices."""
    cfg = cfg or PreprocessConfig()
    gt_dir = Path(exp_dir) / "gt_wavs"
    wav16_dir = Path(exp_dir) / "16k_wavs"
    gt_dir.mkdir(parents=True, exist_ok=True)
    wav16_dir.mkdir(parents=True, exist_ok=True)

    files = sorted(
        p for p in Path(in_dir).iterdir()
        if p.suffix.lower() in (".wav", ".flac", ".mp3", ".ogg")
    )
    win = int(cfg.slice_seconds * cfg.sr)
    hop = int((cfg.slice_seconds - cfg.overlap_seconds) * cfg.sr)
    n_out = 0
    for fi, path in enumerate(files):
        audio = read_audio(str(path)).to_mono()
        x = np.asarray(audio.samples[0], np.float32)
        sr0 = src_sr or audio.sample_rate
        if sr0 != cfg.sr:
            x = resample_poly_np(x, sr0, cfg.sr)
        for si, seg in enumerate(
            slice_silence(x, cfg.sr, threshold_db=cfg.threshold_db)
        ):
            windows = []
            for start in range(0, max(1, len(seg) - win + 1), hop):
                chunk = seg[start : start + win]
                if len(chunk) == win:
                    windows.append(chunk)
            # tail (or short segment): reflect-pad to the window length so
            # short clips still contribute (the reference pads at train
            # time; this pads here to keep static shapes)
            covered = (len(windows) - 1) * hop + win if windows else 0
            tail = seg[covered:]
            if len(tail) >= int(0.3 * win):
                pad = win - len(tail)
                windows.append(np.pad(tail, (0, pad), mode="reflect"
                                      if pad < len(tail) else "wrap"))
            for wi, chunk in enumerate(windows):
                y = _norm_write(chunk, cfg)
                if y is None:
                    continue
                name = f"{fi}_{si}_{wi}"
                write_wav(str(gt_dir / f"{name}.wav"), y, cfg.sr)
                y16 = resample_poly_np(y, cfg.sr, 16000)
                write_wav(str(wav16_dir / f"{name}.wav"), y16, 16000)
                n_out += 1
    return n_out


# ------------------------------------------------------------------ features

@torch.no_grad()
def extract_features(
    exp_dir: str,
    hubert_apply,           # callable (wav16 (b, n) device tensor) -> (b, t50, d)
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    batch_size: int = 8,
    device: str | torch.device = "cuda",
) -> int:
    """f0 + HuBERT features of every 16 kHz slice, a group of ``batch_size``
    equal-length slices at a time on ``device`` (default the card; raises
    without one). Writes feats/*.npy, f0/*.npy, f0c/*.npy."""
    dev = resolve_device(device)
    wav16_dir = Path(exp_dir) / "16k_wavs"
    fdir = Path(exp_dir) / "feats"
    f0dir = Path(exp_dir) / "f0"
    f0cdir = Path(exp_dir) / "f0c"
    for d in (fdir, f0dir, f0cdir):
        d.mkdir(parents=True, exist_ok=True)

    paths = sorted(wav16_dir.glob("*.wav"))
    n = 0
    for i in range(0, len(paths), batch_size):
        group = paths[i : i + batch_size]
        wavs = torch.from_numpy(np.stack(
            [np.asarray(read_audio(str(p)).to_mono().samples[0]) for p in group])).to(dev)
        feats = hubert_apply(wavs)
        f0, _ = f0_autocorr(wavs, sr=16000, hop=160, fmin=f0_min, fmax=f0_max)
        f0c = coarse_f0(f0, f0_min, f0_max)
        feats, f0, f0c = feats.float().cpu().numpy(), f0.cpu().numpy(), f0c.cpu().numpy()
        for j, p in enumerate(group):
            np.save(fdir / f"{p.stem}.npy", feats[j])
            np.save(f0dir / f"{p.stem}.npy", f0[j])
            np.save(f0cdir / f"{p.stem}.npy", f0c[j].astype(np.int32))
            n += 1
    return n


def write_filelist(exp_dir: str, sid: int = 0) -> str:
    """filelist.json pairing gt/feature/f0 paths + speaker id."""
    exp = Path(exp_dir)
    entries = []
    for gt in sorted((exp / "gt_wavs").glob("*.wav")):
        stem = gt.stem
        feat = exp / "feats" / f"{stem}.npy"
        if not feat.exists():
            continue
        entries.append(
            dict(
                gt=str(gt),
                feat=str(feat),
                f0=str(exp / "f0" / f"{stem}.npy"),
                f0c=str(exp / "f0c" / f"{stem}.npy"),
                sid=sid,
            )
        )
    out = exp / "filelist.json"
    out.write_text(json.dumps(entries, indent=1))
    return str(out)


# ------------------------------------------------------------------ loader

@dataclass
class LoaderConfig:
    sr: int = 48000
    n_fft: int = 2048
    hop: int = 480
    win_length: int = 2048
    batch_size: int = 4
    seed: int = 0


class RVCDataLoader:
    """Batches of equal-length examples (every slice is 3.7 s), in the JAX
    loader's order (the same seeded numpy permutation per epoch); the
    spectrogram is computed on ``device`` and every value is a tensor
    there (default the card; raises without one)."""

    def __init__(self, filelist: str, cfg: LoaderConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or LoaderConfig()
        self.device = resolve_device(device)
        self.entries = json.loads(Path(filelist).read_text())
        if not self.entries:
            raise ValueError(f"empty filelist {filelist}")
        self.rng = np.random.default_rng(self.cfg.seed)

    def __len__(self) -> int:
        return len(self.entries) // self.cfg.batch_size

    def _load(self, e) -> dict:
        wav = np.asarray(read_audio(e["gt"]).to_mono().samples[0], np.float32)
        feat = np.load(e["feat"]).astype(np.float32)   # (t50, d)
        f0 = np.load(e["f0"]).astype(np.float32)       # (t100,)
        f0c = np.load(e["f0c"]).astype(np.int64)       # (t100,)
        feat = np.repeat(feat, 2, axis=0)              # 50 -> 100 Hz
        c = self.cfg
        frames = min(len(wav) // c.hop, feat.shape[0], len(f0))
        return dict(wav=wav[: frames * c.hop], feat=feat[:frames],
                    f0=f0[:frames], f0c=f0c[:frames], sid=e["sid"], t=frames)

    def batches(self, epochs: int = 1) -> Iterator[dict]:
        c = self.cfg
        dev = self.device

        def put(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        for _ in range(epochs):
            order = self.rng.permutation(len(self.entries))
            for i in range(0, len(order) - c.batch_size + 1, c.batch_size):
                items = [self._load(self.entries[j]) for j in order[i : i + c.batch_size]]
                t = min(it["t"] for it in items)
                wav = put(np.stack([it["wav"][: t * c.hop] for it in items]))
                spec = spectrogram(wav, c.n_fft, c.hop, c.win_length, center=False, power=1.0)
                tf = spec.shape[1]
                lengths = torch.full((c.batch_size,), tf, dtype=torch.long, device=dev)
                yield dict(
                    phone=put(np.stack([it["feat"][:tf] for it in items])),
                    phone_lengths=lengths,
                    pitch=put(np.stack([it["f0c"][:tf] for it in items]), torch.long),
                    pitchf=put(np.stack([it["f0"][:tf] for it in items])),
                    spec=spec,
                    spec_lengths=lengths,
                    wave=wav[:, : tf * c.hop],
                    sid=put(np.array([it["sid"] for it in items]), torch.long),
                )
