"""The one traffic generator: reads ``traffic/<mix>.json`` and makes the
mix's inputs from the run's seed.  Every seed gets the same sizes (lengths
stratified over the mix's range) in the same order, so seeds change the
content and not the amount of work.

Kinds of mix:

- ``"songs"``: a closed loop of stereo songs handed over from the host one
  at a time; each is a synthetic mix of a voiced line (harmonic notes with
  vibrato, gated into phrases), chords and a percussive noise bed, made on
  the device and brought to the host in set-up.
- ``"rvc_dataset"``: a training set of equal-length voiced slices written
  in the layout RVC's ``write_filelist`` reads (``gt_wavs/``, ``feats/``,
  ``f0/``, ``f0c/``): harmonic tones with vibrato at the model rate, their
  f0 at 100 frames/s and its coarse bins, and seeded features at 50
  frames/s.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import dsp

ROOT = Path(__file__).resolve().parent



def stratified(lo: float, hi: float, count: int) -> list[float]:
    """``count`` values at the centres of equal strata of [lo, hi], in one
    shuffled order that every seed shares: the window then holds the same
    sizes in every run, and the seed changes only what they hold."""
    vals = [lo + (hi - lo) * (i + 0.5) / count for i in range(count)]
    return [vals[i] for i in np.random.default_rng(0).permutation(count)]


# ---------------------------------------------------------------- songs

def voice_line(n: int, sr: int, p: dict, gen: torch.Generator, dev) -> torch.Tensor:
    """(n,) a sung line: notes of random pitch and length, harmonics at
    1/k, vibrato, phrases with rests, 20 ms fades at each note's ends."""
    lo, hi = p["note_s"]
    notes = int(n / sr / lo) + 2
    dur = lo + (hi - lo) * torch.rand(notes, generator=gen, device=dev, dtype=torch.float64)
    ends = torch.cumsum(dur, 0)
    t = torch.arange(n, device=dev, dtype=torch.float64) / sr
    k = torch.searchsorted(ends, t).clamp(max=notes - 1)
    start = ends[k] - dur[k]
    f_lo, f_hi = np.log(p["f0_lo"]), np.log(p["f0_hi"])
    note_f0 = torch.exp(f_lo + (f_hi - f_lo) * torch.rand(notes, generator=gen, device=dev,
                                                          dtype=torch.float64))
    voiced = (torch.rand(notes, generator=gen, device=dev) < p["voiced_share"]).double()
    f0 = note_f0[k] * (1 + p["vibrato_depth"] * torch.sin(2 * np.pi * p["vibrato_hz"] * t))
    phase = 2 * np.pi * torch.cumsum(f0 / sr, 0)
    x = sum(torch.sin(h * phase) / h for h in range(1, p["harmonics"] + 1))
    into = t - start
    env = torch.clamp(torch.minimum(into, dur[k] - into) / 0.02, 0, 1) * voiced[k]
    return (p["level"] * env * x).float()


def chords(n: int, sr: int, p: dict, gen: torch.Generator, dev) -> torch.Tensor:
    """(2, n) triads that change every ``change_s``, panned by voice."""
    t = torch.arange(n, device=dev, dtype=torch.float64) / sr
    count = int(n / sr / p["change_s"]) + 1
    k = (t / p["change_s"]).long().clamp(max=count - 1)
    r_lo, r_hi = np.log(p["root_lo"]), np.log(p["root_hi"])
    roots = torch.exp(r_lo + (r_hi - r_lo) * torch.rand(count, generator=gen, device=dev,
                                                        dtype=torch.float64))
    minor = (torch.rand(count, generator=gen, device=dev) < 0.5).double()
    ratios = [torch.ones_like(minor), 1.25 - 0.05 * minor, torch.full_like(minor, 1.5)]
    out = torch.zeros(2, n, device=dev, dtype=torch.float64)
    for i, r in enumerate(ratios):
        f = roots[k] * r[k]
        phase = 2 * np.pi * torch.cumsum(f / sr, 0)
        tone = torch.sin(phase) + 0.3 * torch.sin(2 * phase)
        pan = (i + 1) / (len(ratios) + 1)
        out[0] += (1 - pan) * tone
        out[1] += pan * tone
    return (p["level"] * out).float()


def drums(n: int, sr: int, p: dict, gen: torch.Generator, dev) -> torch.Tensor:
    """(2, n) noise hits on the beat with an exponential decay, a low
    thump under every other one."""
    bpm = p["bpm"][0] + (p["bpm"][1] - p["bpm"][0]) * float(
        torch.rand(1, generator=gen, device=dev))
    beat = 60.0 / bpm
    t = torch.arange(n, device=dev, dtype=torch.float64) / sr
    into = torch.remainder(t, beat)
    env = torch.exp(-into / p["decay_s"])
    noise = torch.randn(2, n, generator=gen, device=dev, dtype=torch.float64)
    kick = torch.sin(2 * np.pi * 55.0 * into) * (torch.remainder(t, 2 * beat) < beat).double()
    return (p["level"] * env * (0.6 * noise + kick)).float()


def song(n: int, sr: int, content: dict, seed: int, dev) -> torch.Tensor:
    """(2, n) float32 on ``dev``, peak 0.8."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = voice_line(n, sr, content["voice"], gen, dev)
    x = chords(n, sr, content["chords"], gen, dev) + drums(n, sr, content["drums"], gen, dev)
    x = x + v[None]
    x = x + content["noise_floor"] * torch.randn(2, n, generator=gen, device=dev)
    return x * (0.8 / x.abs().max().clamp(min=1e-9))


def songs(mix: dict, seed: int, dev) -> list[dict]:
    """The mix's songs: {"audio": (2, n) host float32, "seed": its seed}."""
    out = []
    for i, sec in enumerate(stratified(*mix["length_s"], mix["count"])):
        s = weights.subseed(seed, 3, i)
        x = song(int(round(sec * mix["sr"])), mix["sr"], mix["content"], s, dev)
        out.append({"audio": x.cpu().numpy(), "seed": s % 2 ** 31})
    return out


# ---------------------------------------------------------------- RVC dataset

def write_wav_f32(path: Path, x: np.ndarray, sr: int) -> None:
    """Mono IEEE-float WAV."""
    data = np.asarray(x, "<f4").tobytes()
    head = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
                       3, 1, sr, 4 * sr, 4, 32, b"data", len(data))
    path.write_bytes(head + data)


def read_wav_f32(path: Path) -> np.ndarray:
    """The samples of a file :func:`write_wav_f32` wrote."""
    return np.frombuffer(Path(path).read_bytes()[44:], "<f4").copy()


def rvc_dataset(mix: dict, slices: int, seed: int, out: Path) -> str:
    """Writes the slices and ``filelist.json`` under ``out``; returns the
    filelist's path.  Slice i is a tone of five harmonics with a 5 Hz
    vibrato at a pitch drawn from the mix's range, a little noise, its
    analytic f0 and seeded features."""
    sr, n = mix["sr"], int(round(mix["slice_s"] * mix["sr"]))
    n16 = n * 16000 // sr
    frames100 = 1 + n16 // 160
    frames50 = (n16 - 400) // 320 + 1
    rng = np.random.default_rng(weights.subseed(seed, 4))
    for d in ("gt_wavs", "feats", "f0", "f0c"):
        (out / d).mkdir(parents=True, exist_ok=True)
    entries = []
    f_lo, f_hi = np.log(mix["f0_lo"]), np.log(mix["f0_hi"])
    for i in range(slices):
        f = float(np.exp(rng.uniform(f_lo, f_hi)))
        t = np.arange(n) / sr
        inst = f * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(inst) / sr
        x = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
        x = (x + 0.01 * rng.standard_normal(n)).astype(np.float32)
        tf = np.arange(frames100) * 0.01
        f0 = (f * (1 + 0.02 * np.sin(2 * np.pi * 5 * tf))).astype(np.float32)
        f0c = dsp.coarse_f0(torch.from_numpy(f0)).numpy().astype(np.int32)
        feat = rng.standard_normal((frames50, mix["feat_dim"])).astype(np.float32)
        name = f"0_0_{i}"
        write_wav_f32(out / "gt_wavs" / f"{name}.wav", x, sr)
        np.save(out / "feats" / f"{name}.npy", feat)
        np.save(out / "f0" / f"{name}.npy", f0)
        np.save(out / "f0c" / f"{name}.npy", f0c)
        entries.append(dict(gt=str(out / "gt_wavs" / f"{name}.wav"),
                            feat=str(out / "feats" / f"{name}.npy"),
                            f0=str(out / "f0" / f"{name}.npy"),
                            f0c=str(out / "f0c" / f"{name}.npy"), sid=0))
    path = out / "filelist.json"
    path.write_text(json.dumps(entries, indent=1))
    return str(path)
