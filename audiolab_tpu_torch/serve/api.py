"""REST API surface (counterpart of audiolab_tpu/serve/api.py; reference
endpoint table: SURVEY §2.4).

The same base64-file-in/base64-file-out JSON convention as the reference
(wrappers/base_wrapper.py:427-509): POST bodies carry
``{"files": [{"filename": ..., "content": <b64>}], "settings": {...}}`` and
responses return the produced files the same way.

One endpoint per registered processor is generated from its TypedInput
schema (the reference's register_api_endpoint codegen, base_wrapper.py:
248-339), plus /chain, /processors, /projects, /load_project, the RVC and
clone endpoints the port has (RVC training among them), the TTS and
transcription routes (serve/tts_api.py, serve/transcribe_api.py: a backend
that is not loaded answers 501), multi-take alignment (serve/align_api.py),
WaveTransfer projects, training and generation (serve/wavetransfer_api.py),
music generation by Stable Audio and ACE-Step (serve/music_api.py),
/openapi.json and the web UI.  Routes whose models the port does not have
yet (YuE, ACE-Step's LoRA) are not registered and answer 404.  Processor,
TTS, transcription, alignment, WaveTransfer and music runs hold the
inference lock: one request at a time on the card.
"""

from __future__ import annotations

import base64
import os
import tempfile

import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.pipelines.base import all_processors
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.serve import (
    align_api,
    clone_api,
    music_api,
    rvc_api,
    transcribe_api,
    tts_api,
    wavetransfer_api,
)
from audiolab_tpu_torch.serve.http import RawResponse, Router
from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK


def _decode_files(body: dict, workdir: str) -> list[str]:
    paths = []
    for f in body.get("files", []):
        name = os.path.basename(f.get("filename", "input.wav"))
        path = os.path.join(workdir, name)
        with open(path, "wb") as fh:
            fh.write(base64.b64decode(f["content"]))
        paths.append(path)
    if not paths:
        raise ValueError("no input files provided")
    return paths


def _encode_files(paths: list[str]) -> dict:
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(
                {
                    "filename": os.path.basename(p),
                    "content": base64.b64encode(fh.read()).decode(),
                }
            )
    return {"files": out}


def create_app(output_root: str = "outputs/process",
               device: str | torch.device = "cuda") -> Router:
    """The port's router; processors run their DSP on ``device`` (default
    the card; raises without one)."""
    dev = resolve_device(device)
    router = Router()

    def _run(titles: list[str], body: dict, settings: dict) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            inputs = _decode_files(body, tmp)
            with INFERENCE_LOCK:
                projs = run_chain(titles, inputs, settings, output_root=output_root,
                                  device=dev)
            outs = []
            for proj in projs:
                outs.extend(proj.last_outputs)
            return _encode_files(outs)

    @router.get("/api/v1/process/processors", "List processors and their option schemas")
    def processors(_params, _body):
        return {
            "processors": [p.json_schema() | {"priority": p.priority} for p in all_processors()]
        }

    @router.get("/api/v1/process/projects", "List existing project directories")
    def projects(_params, _body):
        if not os.path.isdir(output_root):
            return {"projects": []}
        return {"projects": sorted(os.listdir(output_root))}

    @router.post("/api/v1/process/chain", "Run a processor chain")
    def chain(_params, body):
        return _run(body.get("processors", ["Separate"]), body, body.get("settings", {}))

    def _make_single(title: str):
        def single(_params, body, _title=title):
            return _run([_title], body, {_title: body.get("settings", {})})

        return single

    for proc in all_processors():
        slug = proc.title.lower().replace(" ", "_")
        router.add(
            "POST",
            f"/api/v1/process/{slug}",
            _make_single(proc.title),
            f"Run the {proc.title} processor",
        )

    # RVC models and analysis (layouts/rvc_train.py REST surface)
    rvc_api.register(router, output_root, dev)
    # clone voices/methods (wrappers/clone.py:615,637)
    clone_api.register(router)
    # TTS (OpenAI-compatible /api/v1/audio/speech, layouts/tts.py:840)
    tts_api.register(router)
    # transcription (OpenAI-compatible /api/v1/audio/transcriptions)
    transcribe_api.register(router)
    # multi-take alignment (layouts/align.py)
    align_api.register(router, dev)
    # music generation: Stable Audio and ACE-Step (layouts/stable_audio.py,
    # layouts/acestep.py)
    music_api.register(router)
    # WaveTransfer project training and inference (layouts/wavetransfer.py)
    wavetransfer_api.register(
        router, os.path.join(os.path.dirname(output_root), "wavetransfer"), dev)

    @router.post("/api/v1/process/load_project", "Re-enumerate an existing project")
    def load_project(_params, body):
        """Reference: layouts/process.py:502-530 project reload."""
        name = body.get("project")
        if not name:
            raise ValueError("missing 'project'")
        path = os.path.join(output_root, os.path.basename(name))
        if not os.path.isdir(path):
            raise FileNotFoundError(name)
        files = []
        for root, _dirs, fnames in os.walk(path):
            for fn in sorted(fnames):
                files.append(os.path.relpath(os.path.join(root, fn), path))
        return {"project": name, "files": files}

    @router.get("/openapi.json", "OpenAPI document")
    def openapi(_params, _body):
        return router.openapi()

    @router.get("/", "Web UI")
    def index(_params, _body):
        ui = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "ui", "index.html")
        with open(ui, "rb") as f:
            return RawResponse(f.read(), "text/html; charset=utf-8")

    return router
