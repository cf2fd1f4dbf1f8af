"""Compare processor (counterpart of
audiolab_tpu/pipelines/processors/compare.py; reference:
wrappers/compare.py:42-166): RMS-normalized waveform difference + STFT
magnitude-difference spectrograms rendered to PNG.

The two spectrograms run on the processor's device; the metrics and the
image are host work (matplotlib when it imports, else the stdlib PNG
encoder of utils/viz.py).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.kernels.stft import spectrogram
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    null_progress,
    register_processor,
)


def compare_tracks(a: np.ndarray, b: np.ndarray, sr: int, out_png: str,
                   device: str | torch.device = "cuda") -> dict:
    """Diff metrics of two tracks and the comparison image at ``out_png``;
    the spectrograms run on ``device`` (default the card; raises without
    one)."""
    dev = resolve_device(device)
    n = min(a.shape[-1], b.shape[-1])
    am = a[..., :n].mean(axis=0) if a.ndim == 2 else a[:n]
    bm = b[..., :n].mean(axis=0) if b.ndim == 2 else b[:n]
    # RMS normalize both (wrappers/compare.py)
    am = am / (np.sqrt(np.mean(am**2)) + 1e-9)
    bm = bm / (np.sqrt(np.mean(bm**2)) + 1e-9)
    wave_diff = am - bm

    def spec(x):
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        return spectrogram(t, n_fft=2048, hop=512, power=1.0).cpu().numpy()

    sa, sb = spec(am), spec(bm)
    spec_diff = np.abs(sa - sb)

    metrics = {
        "rms_diff": float(np.sqrt(np.mean(wave_diff**2))),
        "spec_l1": float(spec_diff.mean()),
        "spec_max": float(spec_diff.max()),
    }

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 1, figsize=(12, 9))
        t = np.arange(n) / sr
        step = max(1, n // 20000)
        axes[0].plot(t[::step], wave_diff[::step], lw=0.5)
        axes[0].set_title("RMS-normalized waveform difference")
        for ax, s, title in (
            (axes[1], np.log10(sa.T + 1e-6), "Track A"),
            (axes[2], np.log10(spec_diff.T + 1e-6), "|A - B| spectrogram"),
        ):
            ax.imshow(s, aspect="auto", origin="lower", cmap="magma")
            ax.set_title(title)
        fig.tight_layout()
        fig.savefig(out_png, dpi=100)
        plt.close(fig)
        metrics["image"] = out_png
    except Exception:
        # matplotlib absent: render with the stdlib PNG encoder instead
        from audiolab_tpu_torch.utils.viz import spectrogram_png, waveform_diff_png

        waveform_diff_png(out_png, a[:n], b[:n])
        spec_path = out_png.replace(".png", "_spec.png")
        spectrogram_png(spec_path, spec_diff)
        metrics["image"] = out_png
        metrics["spec_image"] = spec_path
    return metrics


class Compare(BaseProcessor):
    title = "Compare"
    priority = 1_000_000  # always last (wrappers/compare.py priority)
    description = "Render a waveform/spectrogram diff between source and result."
    allowed_kwargs = {}

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        for proj in inputs:
            if not proj.last_outputs:
                continue
            src = read_audio(proj.src_file)
            result = read_audio(proj.last_outputs[-1])
            stage = proj.stage_dir("compare")
            out_png = os.path.join(stage, "comparison.png")
            metrics = compare_tracks(src.samples, result.samples, src.sample_rate, out_png,
                                     device=device)
            out_json = os.path.join(stage, "comparison.json")
            with open(out_json, "w") as f:
                json.dump(metrics, f, indent=2)
            files = [out_json] + ([out_png] if os.path.exists(out_png) else [])
            proj.add_output("compare", files)
        return inputs


register_processor(Compare())
