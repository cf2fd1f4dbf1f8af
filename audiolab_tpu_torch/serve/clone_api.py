"""Clone endpoints (counterpart of audiolab_tpu/serve/clone_api.py;
reference: wrappers/clone.py:615,637 /api/v1/clone/{voices,methods}).

``set_facade`` installs a CloningFacade (pipelines/cloning.py); without one
both routes answer as the JAX package's do without one."""

from __future__ import annotations

_FACADE = [None]


def set_facade(facade) -> None:
    _FACADE[0] = facade


def register(router) -> None:
    @router.get("/api/v1/clone/methods", "List cloning methods")
    def methods(_params, _body):
        fac = _FACADE[0]
        return {"methods": fac.methods if fac else ["openvoice", "tts"],
                "loaded": bool(fac)}

    @router.get("/api/v1/clone/voices", "List registered reference voices")
    def voices(_params, _body):
        fac = _FACADE[0]
        names = sorted(k for k in (fac.voices if fac else {})
                       if not k.endswith("__sr"))
        return {"voices": names}
