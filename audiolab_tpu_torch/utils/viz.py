"""Visualization: minimal PNG writer + F0 curve / spectrogram renderers
(a copy of audiolab_tpu/utils/viz.py, host numpy only).

Reference behavior (handlers/spectrogram.py:37-102): an ``F0Visualizer``
singleton accumulates labeled f0 curves and renders them stacked into one
PNG; wrappers/compare.py:42-166 renders RMS-normalized waveform diffs and
STFT magnitude-difference spectrograms.

No matplotlib in this image — PNGs are encoded directly (zlib + stdlib),
rendering is pure numpy rasterization."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> str:
    """(h, w, 3) uint8 -> PNG file."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


_PALETTE = [(122, 162, 247), (158, 206, 106), (247, 118, 142),
            (224, 175, 104), (187, 154, 247), (125, 207, 255)]


def _draw_curve(img: np.ndarray, ys: np.ndarray, color, lo: float, hi: float):
    h, w, _ = img.shape
    n = len(ys)
    if n < 2:
        return
    xs = np.linspace(0, w - 1, n).astype(int)
    norm = np.clip((ys - lo) / max(hi - lo, 1e-9), 0, 1)
    py = ((1.0 - norm) * (h - 1)).astype(int)
    valid = ys > 0
    for i in range(n - 1):
        if not (valid[i] and valid[i + 1]):
            continue
        x0, x1 = xs[i], xs[i + 1]
        y0, y1 = py[i], py[i + 1]
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for s in range(steps + 1):
            x = x0 + (x1 - x0) * s // steps
            y = y0 + (y1 - y0) * s // steps
            img[max(0, y - 1) : y + 1, x] = color


class F0Visualizer:
    """Accumulate labeled f0 curves; render stacked into one PNG
    (handlers/spectrogram.py F0Visualizer semantics)."""

    def __init__(self, width: int = 1024, row_height: int = 160):
        self.width = width
        self.row_height = row_height
        self.curves: list[tuple[str, np.ndarray]] = []

    def add_curve(self, label: str, f0: np.ndarray) -> None:
        self.curves.append((label, np.asarray(f0, np.float32)))

    def clear(self) -> None:
        self.curves.clear()

    def render(self, path: str) -> str:
        n = max(1, len(self.curves))
        h = n * self.row_height
        img = np.full((h, self.width, 3), 18, np.uint8)
        for r, (label, f0) in enumerate(self.curves):
            top = r * self.row_height
            img[top : top + 1] = 60  # separator line
            voiced = f0[f0 > 0]
            lo = float(voiced.min()) * 0.9 if len(voiced) else 0.0
            hi = float(voiced.max()) * 1.1 if len(voiced) else 1.0
            sub = img[top + 8 : top + self.row_height - 8]
            _draw_curve(sub, f0, _PALETTE[r % len(_PALETTE)], lo, hi)
        return write_png(path, img)


def spectrogram_png(path: str, mag: np.ndarray, gain: float = 20.0) -> str:
    """(t, bins) magnitude -> log-scaled grayscale-blue spectrogram PNG
    (compare.py spectrogram rendering role)."""
    db = 20.0 * np.log10(np.maximum(np.asarray(mag, np.float64), 1e-8))
    db -= db.max()
    v = np.clip(1.0 + db / max(gain * 4, 1.0), 0, 1)  # top ~80 dB
    vt = v.T[::-1]  # freq up
    img = np.zeros(vt.shape + (3,), np.uint8)
    img[..., 0] = (vt * 120).astype(np.uint8)
    img[..., 1] = (vt * 170).astype(np.uint8)
    img[..., 2] = (vt * 255).astype(np.uint8)
    return write_png(path, img)


def waveform_diff_png(path: str, a: np.ndarray, b: np.ndarray,
                      width: int = 1024, height: int = 240) -> str:
    """RMS-normalized overlay of two waveforms (compare.py:42-166 role)."""
    img = np.full((height, width, 3), 18, np.uint8)

    def norm(x):
        x = np.asarray(x, np.float32)
        r = np.sqrt(np.mean(x**2)) + 1e-9
        return x / (4 * r)

    for x, color in ((norm(a), _PALETTE[0]), (norm(b), _PALETTE[2])):
        n = len(x)
        step = max(1, n // width)
        env = np.asarray([np.abs(x[i : i + step]).max(initial=0.0)
                          for i in range(0, n, step)])[:width]
        mid = height // 2
        for i, e in enumerate(env):
            half = int(np.clip(e, 0, 1) * (height // 2 - 2))
            img[mid - half : mid + half + 1, i] = (
                (img[mid - half : mid + half + 1, i].astype(int) + color) // 2
            ).astype(np.uint8)
    return write_png(path, img)
