"""RVC REST endpoints (counterpart of audiolab_tpu/serve/rvc_api.py;
reference: layouts/rvc_train.py /api/v1/rvc/* including the async in-memory
job store :1537-1568).

The model list, upload, download, the job store's poll route and the
pitch-range analysis.  Training (``rvc/train``, ``rvc/resume``,
``rvc/build_index``) comes with the port's trainer; until then those routes
are not registered and answer 404.
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
