"""Host-side audio I/O (counterpart of audiolab_tpu/core/audio_io.py).

A dependency-free RIFF/WAVE reader and writer (PCM 8/16/24/32-bit and IEEE
float 32/64 in, PCM 16/24 and float 32 out), copied from the JAX package's
framework-free host code so that both packages write the same bytes, and
:func:`read_audio` / :func:`write_audio`, which take every other container
through an ffmpeg subprocess when the host has one.  :func:`read_wav`
takes the native decoder (``audiolab_tpu_torch.native``) first, as the JAX
package's does, and the numpy decoder where the native library is not built
or does not take the format.  Samples are float32 ``(channels, n)`` in
[-1, 1].
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile
from dataclasses import dataclass

import numpy as np

from audiolab_tpu_torch import native

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class AudioData:
    """Decoded audio: ``samples`` is float32 ``(channels, n)`` in [-1, 1]."""

    samples: np.ndarray
    sample_rate: int

    @property
    def channels(self) -> int:
        return self.samples.shape[0]

    @property
    def num_samples(self) -> int:
        return self.samples.shape[1]

    @property
    def duration(self) -> float:
        return self.num_samples / float(self.sample_rate)

    def to_mono(self) -> "AudioData":
        if self.channels == 1:
            return self
        return AudioData(self.samples.mean(axis=0, keepdims=True), self.sample_rate)


def _read_chunks(data: bytes):
    """Yield (chunk_id, payload) pairs from a RIFF body."""
    pos = 12  # skip 'RIFF'<size>'WAVE'
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        payload = data[pos + 8 : pos + 8 + size]
        yield cid, payload
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_wav(path: str | os.PathLike) -> AudioData:
    """Decode a RIFF/WAVE file (PCM 8/16/24/32, float 32/64, extensible):
    by the native library where it is built and takes the format (PCM
    16/24/32, float 32; the same samples bit for bit), else in numpy."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    decoded = native.wav_decode(data)
    if decoded is not None:
        return AudioData(*decoded)

    fmt = None
    pcm = None
    for cid, payload in _read_chunks(data):
        if cid == b"fmt ":
            fmt = payload
        elif cid == b"data":
            pcm = payload
        if fmt is not None and pcm is not None:
            break
    if fmt is None or pcm is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    (audio_format, channels, sample_rate, _byte_rate, _block_align, bits) = (
        struct.unpack_from("<HHIIHH", fmt, 0)
    )
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # the real format tag lives in the first 2 bytes of the subformat GUID
        (audio_format,) = struct.unpack_from("<H", fmt, 24)

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(pcm, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            # sign-extend 24 -> 32 bit
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int8).astype(np.int32) << 16)
            ).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(pcm, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(pcm, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAVE format tag {audio_format:#x}")

    x = x[: (len(x) // channels) * channels].reshape(-1, channels).T
    return AudioData(np.ascontiguousarray(x), sample_rate)


def write_wav(
    path: str | os.PathLike,
    samples: np.ndarray,
    sample_rate: int,
    subtype: str = "PCM_16",
) -> None:
    """Encode float samples ``(channels, n)`` or ``(n,)`` to a WAVE file."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, _n = samples.shape
    interleaved = np.ascontiguousarray(samples.T)

    if subtype == "PCM_16":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
        pcm = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    elif subtype == "PCM_24":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 24
        ints = (np.clip(interleaved, -1.0, 1.0) * 8388607.0).astype("<i4")
        raw = np.empty((ints.size, 3), dtype=np.uint8)
        flat = ints.reshape(-1)
        raw[:, 0] = flat & 0xFF
        raw[:, 1] = (flat >> 8) & 0xFF
        raw[:, 2] = (flat >> 16) & 0xFF
        pcm = raw.tobytes()
    elif subtype == "FLOAT":
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        pcm = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt = struct.pack(
        "<HHIIHH", fmt_tag, channels, sample_rate, byte_rate, block_align, bits
    )
    body = (
        b"WAVE"
        + b"fmt "
        + struct.pack("<I", len(fmt))
        + fmt
        + b"data"
        + struct.pack("<I", len(pcm))
        + pcm
    )
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def read_audio(
    path: str | os.PathLike,
    sample_rate: int | None = None,
    mono: bool = False,
) -> AudioData:
    """Read any audio file; non-WAV formats need ffmpeg on the host.  With
    ``sample_rate`` the samples are resampled on the host
    (:func:`resample_poly_np`)."""
    path = os.fspath(path)
    if path.lower().endswith(".wav"):
        audio = read_wav(path)
    elif have_ffmpeg():
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            tmp_path = tmp.name
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-i", path, "-f", "wav", "-c:a", "pcm_f32le", tmp_path],
                check=True,
                capture_output=True,
            )
            audio = read_wav(tmp_path)
        finally:
            os.unlink(tmp_path)
    else:
        raise RuntimeError(f"cannot decode {path}: not a WAV and ffmpeg unavailable")

    if mono:
        audio = audio.to_mono()
    if sample_rate is not None and sample_rate != audio.sample_rate:
        from audiolab_tpu_torch.kernels.resample import resample_poly_np

        audio = AudioData(
            resample_poly_np(audio.samples, audio.sample_rate, sample_rate),
            sample_rate,
        )
    return audio


def write_audio(
    path: str | os.PathLike,
    samples: np.ndarray,
    sample_rate: int,
    fmt: str | None = None,
    bitrate: str = "320k",
) -> None:
    """Write audio: WAV (PCM 16) here, other containers through ffmpeg
    (MP3 at 320k by default)."""
    path = os.fspath(path)
    ext = (fmt or os.path.splitext(path)[1].lstrip(".")).lower() or "wav"
    if ext == "wav":
        write_wav(path, samples, sample_rate)
        return
    if not have_ffmpeg():
        raise RuntimeError(f"writing .{ext} requires ffmpeg")
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        write_wav(tmp_path, samples, sample_rate, subtype="FLOAT")
        subprocess.run(
            ["ffmpeg", "-y", "-i", tmp_path, "-b:a", bitrate, path],
            check=True,
            capture_output=True,
        )
    finally:
        os.unlink(tmp_path)
