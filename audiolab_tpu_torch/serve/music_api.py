"""Music generation endpoints (counterpart of audiolab_tpu/serve/music_api.py;
reference layouts/stable_audio.py /api/v1/audio/generate, layouts/acestep.py
/api/v1/acestep/*).

Backends are objects with ``.generate(prompt, **settings) -> (samples,
sr)``, registered by name ("stable_audio", "acestep").  A request's
generation knobs may sit at the top level of the body or under
``settings``; the two are merged and, unless the backend's ``generate``
takes ``**kwargs``, filtered to the parameters it names.  A backend that is
not loaded answers 501.  Generation holds the inference lock.  The YuE and
ACE-Step LoRA routes are not served yet (404).
"""

from __future__ import annotations

import base64
import inspect
import os
import tempfile

import numpy as np

from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.serve.files import file_response, register_file
from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK

_BACKENDS: dict[str, object] = {}
_TASKS = ("retake", "repaint", "edit", "extend")


def register_backend(name: str, backend) -> None:
    """backend: .generate(prompt, **kw) -> (samples, sr)."""
    _BACKENDS[name] = backend


def _backend(name: str, method: str = "generate"):
    be = _BACKENDS.get(name)
    if be is None or not hasattr(be, method):
        raise NotImplementedError(
            f"generation backend {name!r} not loaded or lacks {method!r}; "
            f"available: {sorted(_BACKENDS)}")
    return be


def generation_settings(backend, body: dict) -> dict:
    """The body's ``settings`` with its other top-level keys (but ``prompt``,
    ``tags``, ``settings``, ``model``) merged in, filtered to the parameters
    ``backend.generate`` names unless it takes ``**kwargs``."""
    settings = dict(body.get("settings", {}))
    for k, v in body.items():
        if k not in ("prompt", "tags", "settings", "model") and k not in settings:
            settings[k] = v
    try:
        params = inspect.signature(backend.generate).parameters
    except (TypeError, ValueError):
        return settings
    if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
        settings = {k: v for k, v in settings.items() if k in params}
    return settings


def _answer(samples, sr: int, name: str, **extra) -> dict:
    with tempfile.NamedTemporaryFile(prefix=f"{name}_", suffix=".wav", delete=False) as tmp:
        path = tmp.name
    try:
        write_wav(path, samples, sr)
        with open(path, "rb") as f:
            data = f.read()
        fid = register_file(path)
    except Exception:
        os.unlink(path)
        raise
    return {"audio": base64.b64encode(data).decode(), "format": "wav", "sample_rate": sr,
            **extra, "file_id": fid}


def _generate(name: str, body: dict) -> dict:
    be = _backend(name)
    prompt = body.get("prompt") or body.get("tags") or ""
    settings = generation_settings(be, body)
    with INFERENCE_LOCK:
        samples, sr = be.generate(prompt, **settings)
    return _answer(samples, sr, name)


def _mono_clip(body: dict) -> np.ndarray:
    files = body.get("files", [])
    if not files:
        raise ValueError("no input clip")
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "in.wav")
        with open(p, "wb") as fh:
            fh.write(base64.b64decode(files[0]["content"]))
        return np.asarray(read_audio(p).to_mono().samples[0])


def register(router) -> None:
    @router.post("/api/v1/acestep/generate", "ACE-Step text-to-music")
    def acestep(_params, body):
        return _generate("acestep", body)

    @router.post("/api/v1/acestep/task", "ACE-Step retake/repaint/edit/extend on an input clip")
    def acestep_task(_params, body):
        """Task-specific regeneration anchored to an uploaded clip
        (layouts/acestep.py's Retake, Repaint, Edit and Extend tabs)."""
        task = body.get("task", "retake")
        if task not in _TASKS:
            raise ValueError(f"unknown acestep task {task!r}")
        be = _backend("acestep", task)
        audio = _mono_clip(body)
        s = dict(body.get("settings", {}))
        prompt = body.get("prompt") or body.get("tags") or ""
        lyrics = s.pop("lyrics", "")
        seed = int(s.pop("seed", 0))
        with INFERENCE_LOCK:
            if task == "retake":
                y, sr = be.retake(audio, prompt, lyrics, variance=float(s.get("variance", 0.5)),
                                  seed=seed)
            elif task == "repaint":
                y, sr = be.repaint(audio, prompt, float(s.get("start_s", 0.0)),
                                   float(s.get("end_s", 5.0)), lyrics, seed=seed)
            elif task == "edit":
                y, sr = be.edit(audio, prompt, lyrics, strength=float(s.get("strength", 0.7)),
                                seed=seed)
            else:
                y, sr = be.extend(audio, prompt, left_s=float(s.get("left_s", 0.0)),
                                  right_s=float(s.get("right_s", 10.0)), lyrics=lyrics,
                                  seed=seed)
        return _answer(y, sr, f"acestep_{task}", task=task)

    @router.post("/api/v1/audio/generate", "Stable-Audio text-to-audio")
    def stable_audio(_params, body):
        return _generate("stable_audio", body)

    @router.get("/api/v1/audio/models", "List generation backends")
    def models(_params, _body):
        return {"models": sorted(_BACKENDS)}

    @router.get("/api/v1/audio/formats", "List output formats")
    def formats(_params, _body):
        return {"formats": ["wav", "mp3", "flac"]}

    @router.post("/api/v1/audio/continue", "Extend an existing clip (stable-audio)")
    def continue_audio(_params, body):
        be = _backend("stable_audio", "continue_audio")
        audio = _mono_clip(body)
        with INFERENCE_LOCK:
            y, sr = be.continue_audio(audio, body.get("prompt", ""), **body.get("settings", {}))
        return _answer(y, sr, "continue")

    @router.get("/api/v1/audio/download/{file_id}", "Download a generated file")
    def download(params, _body):
        return file_response(params["file_id"])
