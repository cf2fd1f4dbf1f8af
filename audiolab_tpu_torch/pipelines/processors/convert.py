"""Convert processor (counterpart of
audiolab_tpu/pipelines/processors/convert.py; reference: wrappers/convert.py
— ffmpeg format conversion, default MP3 320k; WAV path native).

Host work only: WAV is written by the port's codec, other containers go
through ``write_audio(fmt=, bitrate=)``, which needs ffmpeg on the host.
Input already in the target format is copied.
"""

from __future__ import annotations

import os
import shutil

import torch

from audiolab_tpu_torch.core.audio_io import read_audio, write_audio
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    TypedInput,
    audio_inputs,
    null_progress,
    register_processor,
)


class Convert(BaseProcessor):
    title = "Convert"
    priority = 10
    description = "Convert audio to a target container format."
    allowed_kwargs = {
        "format": TypedInput(
            default="wav",
            description="Output format",
            choices=["wav", "mp3", "flac", "ogg", "m4a"],
            type=str,
        ),
        "bitrate": TypedInput(
            default="320k", description="Bitrate for lossy formats", type=str
        ),
    }

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        fmt = kw.get("format", "wav")
        bitrate = kw.get("bitrate", "320k")
        for proj in inputs:
            outputs = []
            stage = proj.stage_dir("converted")
            targets = audio_inputs(proj.last_outputs)
            for i, f in enumerate(targets):
                callback(i, f"Converting {os.path.basename(f)}", len(targets))
                base = os.path.splitext(os.path.basename(f))[0]
                out = os.path.join(stage, f"{base}.{fmt}")
                if f.lower().endswith(f".{fmt}"):
                    if os.path.abspath(f) != os.path.abspath(out):
                        shutil.copy2(f, out)
                else:
                    audio = read_audio(f)
                    write_audio(out, audio.samples, audio.sample_rate, fmt=fmt, bitrate=bitrate)
                outputs.append(out)
            proj.add_output("converted", outputs)
        return inputs


register_processor(Convert())
