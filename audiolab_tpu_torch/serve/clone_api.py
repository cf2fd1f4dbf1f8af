"""Clone endpoints (counterpart of audiolab_tpu/serve/clone_api.py;
reference: wrappers/clone.py:615,637 /api/v1/clone/{voices,methods}).

The port has no CloningFacade yet (its OpenVoice and TTS models come with
later items), so both routes answer as the JAX package's do without one."""

from __future__ import annotations


def register(router) -> None:
    @router.get("/api/v1/clone/methods", "List cloning methods")
    def methods(_params, _body):
        return {"methods": ["openvoice", "tts"], "loaded": False}

    @router.get("/api/v1/clone/voices", "List registered reference voices")
    def voices(_params, _body):
        return {"voices": []}
