"""ctypes bindings for the native host library (counterpart of
audiolab_tpu/native/__init__.py): WAV decode and PCM16 encode, a
polyphase resampler, FNV-1a hashing, peak/RMS levels and the WORLD f0
oracle (DIO / Harvest and StoneMask, ``world_f0.cpp``).

The C++ sources are the port's own copies beside this file.  They are built
with ``g++`` at first use, never at import, into
``build/native/libaudiohost-<hash>.so`` at the repository root; the hash
covers both sources and the command, so an edited source builds anew and an
unchanged one loads the library already built.  The compiler writes to a
file of its own (``<name>.<pid>.<random>.tmp``) that is renamed onto the
final name once it is complete, so processes that build at once each load a
whole library and none reads a half-written one.

Without a compiler (no ``g++`` on the host) the library is unavailable and
every function documents its fallback: ``hash64`` and ``levels`` compute in
Python, the others return None.  A build that fails on a host that has
``g++`` is logged at warning level with the compiler's output, and
:func:`unavailable_reason` returns it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

SOURCES = tuple(Path(__file__).resolve().parent / n for n in ("audiohost.cpp", "world_f0.cpp"))
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LOCK = threading.Lock()
_lib = None
_tried = False
_reason: str | None = None


def compile_command(out: Path, cxx: str = "g++") -> list[str]:
    return [cxx, *CXXFLAGS, "-o", str(out), *map(str, SOURCES)]


def library_path(build_dir: Path | None = None) -> Path:
    """Where the library of these sources and this command lives."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(compile_command(Path("o"))).encode())
    return Path(build_dir or BUILD_DIR) / f"libaudiohost-{digest.hexdigest()[:12]}.so"


def _build(lib: Path) -> bool:
    global _reason
    cxx = shutil.which("g++")
    if cxx is None:
        _reason = "no g++ on this host"
        return False
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{os.urandom(4).hex()}.tmp")
    try:
        proc = subprocess.run(compile_command(tmp, cxx), capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            _reason = f"g++ exit {proc.returncode}:\n{proc.stdout}{proc.stderr}"
            log.warning("native library build failed: %s", _reason)
            return False
        os.replace(tmp, lib)
        return True
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {
        "ah_hash64": (ctypes.c_uint64, [u8p, ctypes.c_uint64]),
        "ah_wav_info": (i32, [u8p, ctypes.c_uint64, ctypes.POINTER(i32), ctypes.POINTER(i32),
                              ctypes.POINTER(i64)]),
        "ah_wav_decode": (i32, [u8p, ctypes.c_uint64, f32p]),
        "ah_wav_encode_pcm16": (i64, [f32p, i64, i32, i32, u8p, i64]),
        "ah_resample_len": (i64, [i64, i32, i32]),
        "ah_resample": (i32, [f32p, i64, i32, i32, f32p]),
        "ah_levels": (None, [f32p, i64, f32p, f32p]),
        "ah_world_f0": (i32, [f32p, i64, i32, i32, ctypes.c_double, ctypes.c_double, i32, i32,
                              f64p]),
        "ah_stonemask": (i32, [f32p, i64, i32, i32, f64p, i64, f64p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load():
    global _lib, _tried, _reason
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except OSError as e:
            _reason = f"loading {path}: {e}"
            log.warning("native library load failed: %s", _reason)
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it on the
    first call); :func:`unavailable_reason` says why not."""
    return _load() is not None


def unavailable_reason() -> str | None:
    """None when the library is loaded; else why not: no compiler on the
    host, or the compiler's (or the loader's) output."""
    _load()
    return _reason


def _u8(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def hash64(data: bytes) -> int:
    """FNV-1a's 64-bit loop over ``data`` from the offset basis
    1469598103934665603 (the JAX package's library's, so both libraries
    hash alike); blake2b's 8 bytes without the library."""
    lib = _load()
    if lib is None:
        return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
    return int(lib.ah_hash64(_u8(data), len(data)))


def wav_decode(data: bytes):
    """WAV bytes -> (samples (channels, n) float32, sr), or None without the
    library or for a format it does not decode (PCM 8, float 64)."""
    lib = _load()
    if lib is None:
        return None
    ch, sr, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    if lib.ah_wav_info(_u8(data), len(data), ctypes.byref(ch), ctypes.byref(sr),
                       ctypes.byref(frames)):
        return None
    out = np.empty(frames.value * ch.value, np.float32)
    if lib.ah_wav_decode(_u8(data), len(data), _f32(out)):
        return None
    return out.reshape(frames.value, ch.value).T.copy(), sr.value


def wav_encode_pcm16(samples: np.ndarray, sr: int) -> bytes | None:
    """(channels, n) or (n,) float32 -> PCM16 WAV bytes, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    s = np.asarray(samples, np.float32)
    if s.ndim == 1:
        s = s[None]
    inter = np.ascontiguousarray(s.T)
    frames, ch = inter.shape
    cap = 44 + frames * ch * 2
    out = np.empty(cap, np.uint8)
    n = lib.ah_wav_encode_pcm16(_f32(inter.reshape(-1)), frames, ch, sr,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def resample(x: np.ndarray, up: int, down: int) -> np.ndarray | None:
    """Polyphase resampling by up/down (``scipy.signal.resample_poly``'s
    semantics, a Kaiser-windowed lowpass), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty(lib.ah_resample_len(len(xin), up, down), np.float32)
    if lib.ah_resample(_f32(xin), len(xin), up, down, _f32(out)):
        return None
    return out


def world_f0(x: np.ndarray, sr: int, hop: int, fmin: float = 50.0, fmax: float = 1100.0,
             mode: str = "dio", refine: bool = True) -> np.ndarray | None:
    """The native WORLD-style f0 oracle (``world_f0.cpp``): an independent
    per-frame C++ transcription of DIO / Harvest (+ StoneMask) that gates
    ``dsp/f0.py``.  Returns (n // hop + 1,) float64 f0 (0 = unvoiced), or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(xin) // hop + 1, np.float64)
    rc = lib.ah_world_f0(_f32(xin), len(xin), sr, hop, fmin, fmax,
                         {"dio": 0, "harvest": 1}[mode], int(refine), _f64(out))
    return out if rc == 0 else None


def world_stonemask(x: np.ndarray, f0: np.ndarray, sr: int, hop: int) -> np.ndarray | None:
    """The native StoneMask refinement of an f0 track, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    xin = np.ascontiguousarray(x, np.float32)
    f0in = np.ascontiguousarray(f0, np.float64)
    out = np.empty(len(f0in), np.float64)
    rc = lib.ah_stonemask(_f32(xin), len(xin), sr, hop, _f64(f0in), len(f0in), _f64(out))
    return out if rc == 0 else None


def levels(x: np.ndarray) -> tuple[float, float]:
    """(peak, RMS) of ``x``; computed in numpy without the library."""
    lib = _load()
    xin = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return float(np.abs(xin).max(initial=0.0)), float(np.sqrt(np.mean(xin ** 2)))
    peak, rms = ctypes.c_float(), ctypes.c_float()
    lib.ah_levels(_f32(xin), len(xin), ctypes.byref(peak), ctypes.byref(rms))
    return float(peak.value), float(rms.value)
