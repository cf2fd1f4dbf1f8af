"""Merge processor (counterpart of audiolab_tpu/pipelines/processors/merge.py;
reference: wrappers/merge.py).

Overlays stems sample-accurately (the reference uses pydub overlay :103),
re-applies a stored reverb IR to cloned vocals (:103-120), optionally
pitch-shifts non-cloned stems to match the Clone transpose, and normalizes
clip-safe (:15-45).  The reverb convolution and the pitch shift run on the
processor's device; the mix on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio, write_audio
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.dsp.pitch import pitch_shift
from audiolab_tpu_torch.dsp.reverb import apply_reverb
from audiolab_tpu_torch.pipelines.base import (
    audio_inputs,
    BaseProcessor,
    ProgressFn,
    TypedInput,
    null_progress,
    register_processor,
)


def _mix(tracks: list[np.ndarray]) -> np.ndarray:
    n = max(t.shape[-1] for t in tracks)
    c = max(t.shape[0] for t in tracks)
    out = np.zeros((c, n), dtype=np.float32)
    for t in tracks:
        tt = np.broadcast_to(t, (c, t.shape[-1])) if t.shape[0] == 1 else t
        out[:, : tt.shape[-1]] += tt
    return out


def clip_safe_normalize(x: np.ndarray, headroom_db: float = 1.0) -> np.ndarray:
    """wrappers/merge.py:15-45 — normalize only if clipping."""
    peak = np.abs(x).max() if x.size else 0.0
    limit = 10.0 ** (-headroom_db / 20.0)
    if peak > limit:
        x = x * (limit / peak)
    return x


class Merge(BaseProcessor):
    title = "Merge"
    priority = 6
    description = "Mix processed stems back into a single track."
    allowed_kwargs = {
        "pitch_shift": TypedInput(
            default=0, description="Semitones applied to non-cloned stems", type=int,
            ge=-24, le=24,
        ),
        "reapply_reverb": TypedInput(
            default=True, description="Re-apply captured reverb IR to cloned vocals",
            type=bool,
        ),
        "prevent_clipping": TypedInput(
            default=True,
            description="Normalize the mix only if it would clip"
                        " (wrappers/merge.py:15-45)",
            type=bool,
        ),
        "selected_voice": TypedInput(
            default=None,
            description="Voice model name (metadata propagated from Clone"
                        " for output naming)", type=str,
        ),
        "pitch_extraction_method": TypedInput(
            default=None,
            description="Pitch method metadata propagated from Clone",
            type=str,
        ),
    }

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        shift = int(kw.get("pitch_shift", 0) or 0)
        reapply = kw.get("reapply_reverb", True)
        for proj in inputs:
            stems = audio_inputs(proj.last_outputs)
            if not stems:
                continue
            sr = None
            tracks = []
            for i, f in enumerate(stems):
                callback(i, f"Merging {os.path.basename(f)}", len(stems))
                a = read_audio(f)
                sr = sr or a.sample_rate
                x = a.samples
                is_cloned = "(Cloned)" in f or "cloned" in f.lower()
                if is_cloned and reapply:
                    params_path = os.path.join(proj.project_dir, "reverb_params.json")
                    if os.path.exists(params_path):
                        with open(params_path) as fh:
                            params = json.load(fh)
                        x = apply_reverb(x, params, device=device)
                elif shift and not is_cloned and "(Vocals)" not in f:
                    x = np.stack([
                        pitch_shift(torch.from_numpy(ch).to(device), sr, float(shift)).cpu().numpy()
                        for ch in x])
                tracks.append(np.asarray(x, dtype=np.float32))
            mixed = _mix(tracks)
            if kw.get("prevent_clipping", True):
                mixed = clip_safe_normalize(mixed)
            stage = proj.stage_dir("merged")
            base = os.path.splitext(os.path.basename(proj.src_file))[0]
            out = os.path.join(stage, f"{base}_merged.wav")
            write_audio(out, mixed, sr)
            outputs = [out]
            # video input: mux the merged audio back onto the source video
            # (merge.py:165-180 rebuild)
            video_src = getattr(proj, "video_source", None)
            if video_src and os.path.exists(video_src):
                try:
                    from audiolab_tpu_torch.core.video import recombine

                    vout = os.path.join(
                        stage, base + "_merged" + os.path.splitext(video_src)[1])
                    recombine(video_src, out, vout)
                    outputs.append(vout)
                except Exception:  # ffmpeg absent/failed: audio-only output
                    pass
            proj.add_output("merged", outputs)
        return inputs


register_processor(Merge())
