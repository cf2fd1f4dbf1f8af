"""WaveTransfer endpoints (counterpart of audiolab_tpu/serve/wavetransfer_api.py;
reference layouts/wavetransfer.py /api/v1/wavetransfer/{train, generate,
schedule, projects} with threaded training and cancellation).

Training is an async job (serve/rvc_api.py's ``submit_job`` /
``update_job``) whose device stages hold the inference lock, as ``generate``
does.  The project name is kept to one path component (the JAX routes join
the client's ``project`` unchecked, so ``..`` in it leaves the project
root).
"""

from __future__ import annotations

import base64
import os
import tempfile

import numpy as np
import torch

from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK


def _project_name(body: dict) -> str:
    name = os.path.basename(str(body.get("project", "default")))
    if name in ("", ".", ".."):
        raise ValueError(f"bad project name {body.get('project')!r}")
    return name


def register(router, project_root: str, device: torch.device) -> None:
    """The five WaveTransfer routes over projects under ``project_root``,
    run on ``device``."""
    from audiolab_tpu_torch.serve.rvc_api import submit_job, update_job

    tokens: dict[str, object] = {}

    @router.get("/api/v1/wavetransfer/projects", "List WaveTransfer projects")
    def projects(_params, _body):
        if not os.path.isdir(project_root):
            return {"projects": []}
        return {"projects": sorted(
            d for d in os.listdir(project_root)
            if os.path.isdir(os.path.join(project_root, d)))}

    @router.get("/api/v1/wavetransfer/schedule", "List inference noise schedules")
    def schedule(_params, _body):
        from audiolab_tpu_torch.models import wavegrad as WG

        return {"schedules": {
            "fast6": [float(b) for b in WG.FAST_6.betas],
            "fast12": [float(b) for b in WG.FAST_12.betas],
            "train1000": {"steps": len(WG.TRAIN_SCHEDULE.betas)},
        }}

    @router.post("/api/v1/wavetransfer/train", "Start training (async job)")
    def train(_params, body):
        from audiolab_tpu_torch.train import wavetransfer as WT

        name = _project_name(body)
        proj = os.path.join(project_root, name)
        os.makedirs(os.path.join(proj, "data"), exist_ok=True)
        for f in body.get("files", []):
            p = os.path.join(proj, "data", os.path.basename(f.get("filename", "clip.wav")))
            with open(p, "wb") as fh:
                fh.write(base64.b64decode(f["content"]))

        s = body.get("settings", {})
        cfg = WT.WTConfig(
            sr=int(s.get("sr", 24000)),
            steps=int(s.get("steps", 1000)),
            batch_size=int(s.get("batch_size", 8)),
            ckpt_every=int(s.get("ckpt_every", 500)),
        )
        token = WT.CancellationToken()
        tokens[name] = token

        def run(job_id=None):
            WT.preprocess_project(proj, cfg)
            return WT.train_model(
                proj, cfg, token=token, device=device, lock=INFERENCE_LOCK,
                callback=lambda i, msg, total: update_job(
                    job_id, min(0.99, i / max(total, 1)), msg),
            )

        return {"job_id": submit_job(run), "project": name}

    @router.post("/api/v1/wavetransfer/cancel", "Cancel a running training")
    def cancel(_params, body):
        name = _project_name(body)
        token = tokens.get(name)
        if token is None:
            raise FileNotFoundError(f"no running training for {name}")
        token.cancel()
        return {"cancelled": name}

    @router.post("/api/v1/wavetransfer/generate", "Timbre transfer inference")
    def generate(_params, body):
        from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
        from audiolab_tpu_torch.models import wavegrad as WG
        from audiolab_tpu_torch.train import wavetransfer as WT

        proj = os.path.join(project_root, _project_name(body))
        files = body.get("files", [])
        if not files:
            raise ValueError("no source file")
        with tempfile.TemporaryDirectory() as tmp:
            p = os.path.join(tmp, "src.wav")
            with open(p, "wb") as fh:
                fh.write(base64.b64decode(files[0]["content"]))
            a = read_audio(p).to_mono()
            s = body.get("settings", {})
            sched = {"fast6": WG.FAST_6, "fast12": WG.FAST_12}.get(
                s.get("schedule", "fast6"), WG.FAST_6)
            cfg = WT.WTConfig(sr=int(s.get("sr", 24000)))
            with INFERENCE_LOCK:
                y, sr = WT.generate(proj, np.asarray(a.samples[0]), a.sample_rate, cfg, sched,
                                    device=device)
            out = os.path.join(tmp, "out.wav")
            write_wav(out, y, sr)
            with open(out, "rb") as fh:
                data = fh.read()
        return {"audio": base64.b64encode(data).decode(), "format": "wav",
                "sample_rate": sr}
