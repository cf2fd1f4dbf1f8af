"""RVC REST endpoints (counterpart of audiolab_tpu/serve/rvc_api.py;
reference: layouts/rvc_train.py /api/v1/rvc/* including the async in-memory
job store :1537-1568).

The model list, upload, download, the job store's poll route, the
pitch-range analysis and training: ``rvc/train`` and ``rvc/resume`` run
``train_from_request`` as a job on the app's device, ``rvc/build_index``
builds an experiment's retrieval index.  Their device work holds the
inference lock, as the chain routes do.
"""

from __future__ import annotations

import base64
import os
import tempfile
import threading
import uuid

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio
from audiolab_tpu_torch.dsp.f0 import f0_autocorr
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.serve.http import RawResponse
from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK

_JOBS: dict[str, dict] = {}
_JOBS_LOCK = threading.Lock()


def submit_job(fn, *args, **kwargs) -> str:
    job_id = uuid.uuid4().hex[:12]
    with _JOBS_LOCK:
        _JOBS[job_id] = {"status": "running", "progress": 0.0, "message": "started"}

    def run():
        try:
            result = fn(*args, job_id=job_id, **kwargs)
            with _JOBS_LOCK:
                _JOBS[job_id].update(status="done", progress=1.0, result=result)
        except Exception as e:  # noqa: BLE001
            with _JOBS_LOCK:
                _JOBS[job_id].update(status="error", message=str(e))

    threading.Thread(target=run, daemon=True).start()
    return job_id


def update_job(job_id: str, progress: float, message: str) -> None:
    with _JOBS_LOCK:
        if job_id in _JOBS:
            _JOBS[job_id].update(progress=progress, message=message)


def _safe_settings(body: dict) -> dict:
    """SECURITY: request settings never control filesystem paths (a
    client-supplied path reaching ``torch.load`` is code execution);
    weights resolve server-side through ``AUDIOLAB_WEIGHTS_DIR``."""
    return {k: v for k, v in dict(body.get("settings", {})).items()
            if not k.endswith(("_path", "_dir"))}


def _voice_name(body: dict) -> str:
    """The request's voice name as one path component (the JAX routes join
    it unchecked, so ``..`` in it leaves the server's directories)."""
    name = os.path.basename(str(body.get("name", "voice")))
    if name in ("", ".", ".."):
        raise ValueError(f"bad voice name {body.get('name')!r}")
    return name


def register(router, output_root: str, device: torch.device) -> None:
    models_dir = os.path.join(os.path.dirname(output_root), "models", "rvc")

    @router.get("/api/v1/rvc/models", "List trained voice models")
    def models(_params, _body):
        if not os.path.isdir(models_dir):
            return {"models": []}
        return {
            "models": sorted(
                f for f in os.listdir(models_dir) if f.endswith((".npz", ".msgpack"))
            )
        }

    @router.get("/api/v1/rvc/job/{job_id}", "Poll an async training job")
    def job(params, _body):
        with _JOBS_LOCK:
            info = _JOBS.get(params["job_id"])
        if info is None:
            raise FileNotFoundError(f"unknown job {params['job_id']}")
        return info

    @router.post("/api/v1/rvc/train", "Start RVC training (async job)")
    def train(_params, body):
        from audiolab_tpu_torch.train.rvc_train import train_from_request

        name = _voice_name(body)
        # the dataset stays for rvc/resume
        dataset_dir = os.path.join(os.path.dirname(output_root), "datasets", name)
        os.makedirs(dataset_dir, exist_ok=True)
        persisted = []
        for f in body.get("files", []):
            dst = os.path.join(dataset_dir, os.path.basename(f.get("filename", "in.wav")))
            with open(dst, "wb") as fh:
                fh.write(base64.b64decode(f["content"]))
            persisted.append(dst)
        job_id = submit_job(train_from_request, persisted, name, models_dir,
                            _safe_settings(body), device=device)
        return {"job_id": job_id}

    @router.post("/api/v1/rvc/resume", "Resume training an existing voice")
    def resume(_params, body):
        """Reference layouts/rvc_train.py: training restarts from the latest
        checkpoint in the experiment dir (train/trainer.py
        restore_train_state), re-run with the persisted dataset and more
        epochs, no re-upload."""
        from audiolab_tpu_torch.train.rvc_train import train_from_request

        name = _voice_name(body)
        dataset_dir = os.path.join(os.path.dirname(output_root), "datasets", name)
        if not os.path.isdir(dataset_dir) or not os.listdir(dataset_dir):
            raise FileNotFoundError(f"no persisted dataset for {name!r}; train first")
        files = [os.path.join(dataset_dir, f) for f in sorted(os.listdir(dataset_dir))]
        job_id = submit_job(train_from_request, files, name, models_dir,
                            _safe_settings(body), device=device)
        return {"job_id": job_id, "resumed": True}

    @router.post("/api/v1/rvc/build_index", "Build a retrieval index from an exp dir")
    def build_index(_params, body):
        from audiolab_tpu_torch.train.trainer import build_index as _build

        # the experiment directory train_from_request writes (the JAX route
        # looks in <root>/exp, where no trainer writes); as in the JAX
        # package the body may name it instead: a path chosen by the client,
        # a known fault of both
        exp = body.get("exp_dir") or os.path.join(
            os.path.dirname(models_dir), "exp", _voice_name(body))
        with INFERENCE_LOCK:
            return {"index": _build(exp, device=device)}

    @router.post("/api/v1/rvc/upload", "Upload a trained voice model (.npz)")
    def upload(_params, body):
        os.makedirs(models_dir, exist_ok=True)
        saved = []
        for f in body.get("files", []):
            name = os.path.basename(f.get("filename", "model.npz"))
            p = os.path.join(models_dir, name)
            with open(p, "wb") as fh:
                fh.write(base64.b64decode(f["content"]))
            saved.append(name)
        if not saved:
            raise ValueError("no files")
        return {"saved": saved}

    @router.get("/api/v1/rvc/download/{name}", "Download a trained voice model")
    def download(params, _body):
        p = os.path.join(models_dir, os.path.basename(params["name"]))
        if not os.path.exists(p):
            raise FileNotFoundError(params["name"])
        with open(p, "rb") as fh:
            # raw bytes, like the reference's FileResponse download routes
            return RawResponse(
                fh.read(), content_type="application/octet-stream",
                headers={"Content-Disposition":
                         f'attachment; filename="{params["name"]}"'})

    @router.post("/api/v1/rvc/analyze", "Pitch-range analysis of uploaded audio")
    def analyze(_params, body):
        """Reference: layouts/rvc_train.py:233 pitch-range analysis — median
        f0 + range so the UI can suggest a transpose (YIN on the device)."""
        files = body.get("files", [])
        if not files:
            raise ValueError("no files")
        stats = []
        with tempfile.TemporaryDirectory() as tmp:
            for f in files:
                p = os.path.join(tmp, os.path.basename(f.get("filename", "a.wav")))
                with open(p, "wb") as fh:
                    fh.write(base64.b64decode(f["content"]))
                a = read_audio(p).to_mono()
                x = np.asarray(a.samples[0], np.float32)
                if a.sample_rate != 16000:
                    x = resample_poly_np(x, a.sample_rate, 16000)
                f0, voiced = f0_autocorr(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                                         sr=16000, hop=160)
                f0, voiced = f0.cpu().numpy(), voiced.cpu().numpy()
                f0 = f0[voiced > 0] if voiced.any() else f0
                f0 = f0[f0 > 0]
                if len(f0):
                    stats.append(
                        {"file": f.get("filename"),
                         "median_hz": float(np.median(f0)),
                         "min_hz": float(np.percentile(f0, 5)),
                         "max_hz": float(np.percentile(f0, 95))})
        return {"analysis": stats}
