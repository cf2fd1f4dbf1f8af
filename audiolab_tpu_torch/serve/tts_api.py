"""TTS endpoints, the OpenAI-compatible speech API (counterpart of
audiolab_tpu/serve/tts_api.py; reference layouts/tts.py:840
/api/v1/audio/speech and friends).

Backends are objects with ``.generate(text, voice=, speed=) -> (samples,
sr)``, registered by name.  A request for a backend that is not loaded
answers 501; synthesis holds the inference lock.
"""

from __future__ import annotations

import base64
import os
import tempfile

from audiolab_tpu_torch.core.audio_io import write_wav
from audiolab_tpu_torch.serve.files import file_response, register_file
from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK

_BACKENDS: dict[str, object] = {}


def register_backend(name: str, backend) -> None:
    """backend: object with .generate(text, voice, **kw) -> (samples, sr)."""
    _BACKENDS[name] = backend


def register(router) -> None:
    @router.get("/api/v1/audio/speech/models", "List TTS engines")
    def models(_params, _body):
        notes = {}
        for name, be in _BACKENDS.items():
            note = getattr(be, "engine_note", None)
            if note:
                notes[name] = note
        return {"models": sorted(_BACKENDS) or ["zonos", "dia"],
                "loaded": sorted(_BACKENDS), "notes": notes}

    @router.get("/api/v1/audio/speech/voices", "List available voices")
    def voices(_params, _body):
        return {"voices": {name: getattr(be, "voices", ["default"])
                           for name, be in _BACKENDS.items()}}

    @router.get("/api/v1/audio/speech/formats", "List output formats")
    def formats(_params, _body):
        return {"formats": ["wav", "mp3", "flac"]}

    @router.post("/api/v1/audio/speech", "Synthesize speech (OpenAI-compatible)")
    def speech(_params, body):
        model = body.get("model", next(iter(_BACKENDS), None))
        if model not in _BACKENDS:
            raise NotImplementedError(
                f"TTS backend {model!r} not loaded; available: {sorted(_BACKENDS)}")
        text = body.get("input") or body.get("text")
        if not text:
            raise ValueError("missing 'input' text")
        with INFERENCE_LOCK:
            samples, sr = _BACKENDS[model].generate(
                text, voice=body.get("voice", "default"), speed=body.get("speed", 1.0))
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            path = tmp.name
        try:
            write_wav(path, samples, sr)
            with open(path, "rb") as f:
                data = f.read()
            fid = register_file(path)
        except Exception:
            os.unlink(path)
            raise
        return {"audio": base64.b64encode(data).decode(), "format": "wav",
                "sample_rate": sr, "file_id": fid}

    @router.get("/api/v1/audio/speech/download/{file_id}", "Download generated speech")
    def download(params, _body):
        return file_response(params["file_id"])
