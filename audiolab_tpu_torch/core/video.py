"""Video ⇄ audio handling (counterpart of audiolab_tpu/core/video.py;
reference: wrappers/base_wrapper.py:137-246 — ffmpeg extract of the audio
track from video inputs, and recombination of processed audio with the
original video stream; layouts/process.py:132-236 handle_video_input).

Host-side ffmpeg subprocess, gated on availability."""

from __future__ import annotations

import os
import subprocess

from audiolab_tpu_torch.core.audio_io import have_ffmpeg

VIDEO_EXTS = (".mp4", ".mkv", ".mov", ".webm", ".avi")


def is_video(path: str) -> bool:
    return path.lower().endswith(VIDEO_EXTS)


def extract_audio(video_path: str, out_wav: str | None = None,
                  sr: int | None = None) -> str:
    """Video file -> WAV path (base_wrapper.py:157-171)."""
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg not available for video input")
    out_wav = out_wav or os.path.splitext(video_path)[0] + ".wav"
    cmd = ["ffmpeg", "-y", "-i", video_path, "-vn", "-c:a", "pcm_f32le"]
    if sr:
        cmd += ["-ar", str(sr)]
    cmd.append(out_wav)
    subprocess.run(cmd, check=True, capture_output=True)
    return out_wav


def recombine(video_path: str, audio_path: str, out_path: str) -> str:
    """Mux processed audio back onto the original video stream
    (base_wrapper.py:219-228; merge.py:165-180 rebuild)."""
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg not available for video output")
    subprocess.run(
        ["ffmpeg", "-y", "-i", video_path, "-i", audio_path,
         "-map", "0:v:0", "-map", "1:a:0", "-c:v", "copy", "-shortest",
         out_path],
        check=True, capture_output=True,
    )
    return out_path
