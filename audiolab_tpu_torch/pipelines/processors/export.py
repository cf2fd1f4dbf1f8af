"""Export processor (counterpart of audiolab_tpu/pipelines/processors/export.py;
reference: wrappers/export.py + handlers/ableton.py, handlers/reaper.py): BPM detect, write an Ableton .als or Reaper .rpp
referencing the current stems, zip the bundle."""

from __future__ import annotations

import os

import torch

from audiolab_tpu_torch.core.audio_io import read_audio
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    TypedInput,
    null_progress,
    register_processor,
)
from audiolab_tpu_torch.utils.daw import (
    detect_bpm,
    write_ableton_project,
    write_reaper_project,
    zip_project,
)


class Export(BaseProcessor):
    title = "Export"
    priority = 5
    description = "Export stems as an Ableton or Reaper project."
    allowed_kwargs = {
        "project_format": TypedInput(
            default="ableton", description="DAW project format",
            choices=["ableton", "reaper"], type=str,
        ),
        "pitch_shift": TypedInput(
            default=0, description="Pitch shift metadata from Clone", type=int,
            ge=-24, le=24,
        ),
        "export_all_stems": TypedInput(
            default=True,
            description="Include every produced stem as a DAW track, not"
                        " just the last stage's outputs", type=bool,
        ),
        "export_videos": TypedInput(
            default=False,
            description="Copy the source video next to the project and"
                        " add a video track", type=bool,
        ),
    }

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        """Host work only: ``device`` is unused."""
        fmt = kw.get("project_format", "ableton")
        all_stems = kw.get("export_all_stems", True)
        for proj in inputs:
            stems = (proj.all_outputs() if all_stems
                     else proj.last_outputs)
            stems = [s for s in stems
                     if s.lower().endswith((".wav", ".flac", ".mp3"))]
            if not stems:
                continue
            callback(0, "Detecting BPM", 2)
            first = read_audio(stems[0])
            bpm = detect_bpm(first.samples, first.sample_rate)

            stage = proj.stage_dir("export")
            base = os.path.splitext(os.path.basename(proj.src_file))[0]
            callback(1, f"Writing {fmt} project", 2)
            # video inputs get a video track in the DAW project
            # (reference util/video_track.py via wrappers/export.py)
            video = getattr(proj, "video_source", None)
            if video and not os.path.exists(video):
                video = None
            if not kw.get("export_videos", False):
                video = None
            if fmt == "ableton":
                dur = first.samples.shape[-1] / first.sample_rate
                proj_file = write_ableton_project(
                    os.path.join(stage, f"{base}.als"), stems, bpm,
                    first.sample_rate, video_file=video, video_duration_s=dur
                )
            else:
                proj_file = write_reaper_project(
                    os.path.join(stage, f"{base}.rpp"), stems, bpm,
                    first.sample_rate, video_file=video
                )
            bundle = zip_project(os.path.join(stage, f"{base}_project.zip"), [proj_file] + stems)
            # the reference APPENDS the bundle to last_outputs so the
            # audio stems stay visible to later wrappers in the chain
            # (wrappers/export.py:346-357)
            proj.add_output("export", list(proj.last_outputs) + [bundle])
        return inputs


register_processor(Export())
