"""Super Resolution processor (counterpart of
audiolab_tpu/pipelines/processors/super_res.py; reference:
wrappers/super_res.py).

Without ``configure`` the processor runs the DSP enhancer of
pipelines/super_res.py.  ``configure(enhancer_fn=...)`` plugs in a neural
enhancer (any callable: ``train/super_res.py::load_enhancer``'s WaveGrad),
called on the ``(count, ch, n)`` chunk tensor on the processor's device;
``ckpt_pipeline`` is the slot of an AudioSR checkpoint pipeline (an object
with ``guidance_scale`` and ``enhance_chunks(chunks, steps=, seed=)``:
pipelines/super_res.py's ``AudioSRCheckpointPipeline``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio, write_audio
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.kernels.resample import resample
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    TypedInput,
    audio_inputs,
    null_progress,
    register_processor,
)
from audiolab_tpu_torch.pipelines.super_res import crossover_splice, super_resolve


class SuperResolution(BaseProcessor):
    title = "Super Resolution"
    priority = 8
    description = "Upscale audio to 48 kHz with high-band enhancement."
    # full reference field set (wrappers/super_res.py:57-115)
    allowed_kwargs = {
        "ddim_steps": TypedInput(
            default=50, ge=10, le=500, type=int,
            description=("The number of diffusion steps used during"
                         " inference. A higher number provides better"
                         " quality results but increases processing"
                         " time.")),
        "guidance_scale": TypedInput(
            default=3.5, ge=1.0, le=20.0, type=float,
            description=("The strength of classifier-free guidance"
                         " applied during processing.")),
        "overlap": TypedInput(
            default=0.04, ge=0.0, le=0.5, type=float,
            description=("The proportion of overlap between audio chunks"
                         " during processing.")),
        "chunk_size": TypedInput(
            default=10.24, ge=5.0, le=20.0, type=float,
            description=("The length of each audio chunk (in seconds)"
                         " used for processing.")),
        "seed": TypedInput(
            default=-1, ge=-1, le=10000, type=int,
            description=("The random seed for reproducibility. Set to -1"
                         " for a randomized seed.")),
        "output_folder": TypedInput(
            default=None, type=str,
            description=("The directory where the processed audio files"
                         " will be saved.")),
        "tgt_ensemble": TypedInput(
            default=False, type=bool,
            description=("When enabled, combines the output with a"
                         " low-pass filtered version of the original"
                         " audio.")),
        "tgt_cutoff": TypedInput(
            default=12000, ge=500, le=24000, type=int,
            description=("Cutoff frequency (in Hz) for the target audio"
                         " ensemble's low-pass filter.")),
        "crossover_hz": TypedInput(
            default=0.0, description="Crossover frequency (0 = auto)",
            type=float, ge=0.0, le=24000.0),
    }

    enhancer_fn = None      # slot for a neural enhancer (WaveGrad)
    ckpt_pipeline = None    # slot for AudioSRCheckpointPipeline

    @classmethod
    def configure(cls, enhancer_fn=None, ckpt_pipeline=None) -> None:
        # a plain function stored on the class would bind as a method (the
        # JAX processor's fault: ROADMAP queue 3); kept as a static slot
        cls.enhancer_fn = None if enhancer_fn is None else staticmethod(enhancer_fn)
        cls.ckpt_pipeline = ckpt_pipeline

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        s = {k: kw.get(k, ti.default) for k, ti in self.allowed_kwargs.items()}
        chunk_s = float(s["chunk_size"])
        fc = float(s["crossover_hz"]) or None
        seed = int(s["seed"])
        if seed < 0:
            seed = int.from_bytes(os.urandom(2), "little")
        enhancer = self.enhancer_fn
        if self.ckpt_pipeline is not None:
            # converted AudioSR stack: steps/guidance/seed flow through
            pipe = self.ckpt_pipeline
            pipe.guidance_scale = float(s["guidance_scale"])
            enhancer = lambda chunks: pipe.enhance_chunks(  # noqa: E731
                chunks, steps=int(s["ddim_steps"]), seed=seed)
        for proj in inputs:
            outputs = []
            stage = s["output_folder"] or proj.stage_dir("super_res")
            os.makedirs(stage, exist_ok=True)
            targets = audio_inputs(proj.last_outputs)
            for i, f in enumerate(targets):
                callback(i, f"Upscaling {os.path.basename(f)}", len(targets))
                a = read_audio(f)
                y, sr = super_resolve(
                    a.samples, a.sample_rate,
                    enhancer_fn=enhancer,
                    chunk_seconds=chunk_s,
                    overlap_seconds=float(s["overlap"]) * chunk_s,
                    crossover_hz=fc,
                    device=device,
                )
                if s["tgt_ensemble"]:
                    # blend with the low-passed original (super_res.py
                    # tgt_ensemble): keeps the source's character below
                    # tgt_cutoff
                    x = torch.from_numpy(np.ascontiguousarray(a.samples, np.float32))
                    x48 = resample(x.to(device), a.sample_rate, sr).cpu().numpy()
                    n = min(x48.shape[-1], y.shape[-1])
                    y = crossover_splice(x48[..., :n], y[..., :n], sr,
                                         fc=float(s["tgt_cutoff"]))
                base = os.path.splitext(os.path.basename(f))[0]
                out = os.path.join(stage, f"{base}_48k.wav")
                write_audio(out, y, sr)
                outputs.append(out)
            proj.add_output("super_res", outputs)
        return inputs


register_processor(SuperResolution())
