"""Chain executor — the product's core loop (counterpart of
audiolab_tpu/pipelines/chain.py; reference: layouts/process.py:312-494
``process``).

Runs selected processors in priority order; each processor's output projects
feed the next.  Failures break the chain but return partial outputs, same as
the reference (:454-459).
"""

from __future__ import annotations

import logging
import time

import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.pipelines.base import (
    ProgressFn,
    get_processor,
    null_progress,
)

logger = logging.getLogger(__name__)


def run_chain(
    processor_titles: list[str],
    input_files: list[str],
    settings: dict[str, dict] | None = None,
    callback: ProgressFn = null_progress,
    output_root: str = "outputs/process",
    device: str | torch.device = "cuda",
) -> list[ProjectFiles]:
    """Execute the processor chain over the given input files.

    settings: {processor_title: {option: value}} — the ArgHandler snapshot
    equivalent (process.py:314).
    device: where the processors' DSP runs (default the card; raises
    without one).
    """
    dev = resolve_device(device)
    settings = settings or {}

    # video inputs: extract the audio track first; remember the source video
    # so Merge/Convert outputs can be re-muxed (process.py:132-236)
    from audiolab_tpu_torch.core.video import extract_audio, is_video

    video_sources: dict[str, str] = {}
    resolved = []
    for f in input_files:
        if is_video(f):
            wav = extract_audio(f)
            video_sources[wav] = f
            resolved.append(wav)
        else:
            resolved.append(f)
    input_files = resolved

    projects = []
    for f in input_files:
        proj = ProjectFiles(f, output_root=output_root)
        if f in video_sources:
            proj.video_source = video_sources[f]
        projects.append(proj)

    procs = sorted(
        (get_processor(t) for t in processor_titles), key=lambda p: p.priority
    )

    # input heuristics (process.py:355-401): generated/pre-separated inputs
    # skip Separate — TTS/StableAudio outputs and *(Vocals)/(Instrumental)*
    # stems have nothing to separate
    def _skip_separate(files: list[str]) -> bool:
        markers = ("(Vocals)", "(Instrumental)", "(BG_Vocals)", "_tts", "TTS_",
                   "zonos_", "stable_audio_", "acestep_", "yue_")
        import os as _os

        return all(any(m in _os.path.basename(f) for m in markers)
                   for f in files)

    if input_files and _skip_separate(input_files):
        procs = [p for p in procs if p.title != "Separate"]
        logger.info("skipping Separate: inputs are generated/pre-separated")

    # cross-processor setting propagation (process.py:403-432): pitch shift
    # chosen on Clone flows into Merge/Export so stems stay in tune
    clone_cfg = settings.get("Clone", {})
    if "pitch_shift" in clone_cfg:
        for dep in ("Merge", "Export"):
            settings.setdefault(dep, {}).setdefault(
                "pitch_shift", clone_cfg["pitch_shift"]
            )

    t0 = time.time()
    for i, proc in enumerate(procs):
        cfg = proc.validate_kwargs(settings.get(proc.title, {}))
        callback(i, f"Running {proc.title}", len(procs))
        try:
            projects = proc.process_audio(projects, callback, device=dev, **cfg)
        except Exception:
            logger.exception("processor %s failed; returning partial outputs", proc.title)
            break
    logger.info("chain finished in %.1fs", time.time() - t0)
    return projects
