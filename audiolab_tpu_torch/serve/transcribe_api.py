"""Transcription endpoints (counterpart of audiolab_tpu/serve/transcribe_api.py;
reference layouts/transcribe.py /api/v1/audio/transcriptions, WhisperX-style
word timing JSON).

Backends are objects with ``.transcribe(path, **settings) -> dict``,
registered by name; a request for a backend that is not loaded answers
501.  Transcription holds the inference lock.
"""

from __future__ import annotations

import base64
import os
import tempfile

from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK

_BACKENDS: dict[str, object] = {}


def register_backend(name: str, backend) -> None:
    """backend: .transcribe(path, **kw) -> dict with text/segments."""
    _BACKENDS[name] = backend


def register(router) -> None:
    @router.post("/api/v1/audio/transcriptions", "Transcribe audio to text")
    def transcriptions(_params, body):
        name = body.get("model", next(iter(_BACKENDS), None))
        if name not in _BACKENDS:
            raise NotImplementedError(
                f"transcription backend {name!r} not loaded; available: {sorted(_BACKENDS)}")
        files = body.get("files", [])
        if not files:
            raise ValueError("no input files")
        results = []
        with tempfile.TemporaryDirectory() as tmp:
            for f in files:
                p = os.path.join(tmp, os.path.basename(f.get("filename", "in.wav")))
                with open(p, "wb") as fh:
                    fh.write(base64.b64decode(f["content"]))
                with INFERENCE_LOCK:
                    results.append(_BACKENDS[name].transcribe(p, **body.get("settings", {})))
        return {"results": results}

    @router.post("/api/v1/audio/translations", "Transcribe+translate to English")
    def translations(_params, body):
        body.setdefault("settings", {})["task"] = "translate"
        return transcriptions(_params, body)
