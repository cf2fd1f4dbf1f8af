"""REST-facing RVC training adapter (counterpart of
audiolab_tpu/train/rvc_train.py; reference: layouts/rvc_train.py train1key
:524-727 behind /api/v1/rvc/train with the async job store).

Bridges uploaded dataset files -> preprocess -> features -> train_rvc ->
deployable export + retrieval index, reporting progress into the job store.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor


def hubert_weights_path() -> str | None:
    """Server-side HuBERT checkpoint location.  SECURITY: never taken from
    request bodies — a client-controlled path fed to ``torch.load`` is an
    arbitrary-code-execution primitive (pickle), and /api/v1/rvc/upload lets
    clients write bytes into a predictable models dir.  Weights are resolved
    only from the ``AUDIOLAB_WEIGHTS_DIR`` env var (set by the operator)."""
    wdir = os.environ.get("AUDIOLAB_WEIGHTS_DIR")
    if not wdir:
        return None
    for name in ("hubert_base.pt", "hubert_base.npz", "contentvec.pt"):
        p = os.path.join(wdir, name)
        if os.path.exists(p):
            return p
    return None


def _hubert_apply_for(settings: dict,
                      device: str | torch.device = "cuda") -> HubertFeatureExtractor:
    """The feature extractor of a training request on ``device``, a module
    called as ``wav16 (b, n) -> (b, t50, d)``: HuBERT with
    the checkpoint of :func:`hubert_weights_path` when there is one (fairseq
    names; loaded with ``weights_only=True``, so a fairseq pickle that it
    refuses raises), else torch's default initialisers drawn from seed 0
    (features are still a stable embedding: fine for the pipeline's wiring,
    not for a production voice).  ``small_hubert`` (default) keeps 2 layers
    of ``feat_channels`` width, as the JAX adapter does."""
    dev = resolve_device(device)
    dim = int(settings.get("feat_channels", 768))
    cfg = (HubertConfig(dim=dim, ffn_dim=dim * 4, heads=max(1, dim // 64), layers=2,
                        final_dim=256)
           if settings.get("small_hubert", True) else HubertConfig())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = HubertFeatureExtractor(settings.get("version", "v2"), cfg)
    path = hubert_weights_path()
    if path:
        if path.endswith(".npz"):
            sd = {k: torch.from_numpy(v) for k, v in np.load(path, allow_pickle=False).items()}
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = sd.get("model", sd)
        model.load_state_dict({k: v.float() for k, v in sd.items() if torch.is_tensor(v)},
                              strict=False)
    return model.to(dev).eval()


def train_from_request(files: list[str], name: str, models_dir: str, settings: dict,
                       job_id: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Train a voice on ``files`` on ``device`` (default the card; raises
    without one); the model and its index land in ``models_dir``.  The
    result carries each stage's host-clock seconds beside the metrics (an
    epoch's include building or restoring the train state before it)."""
    from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK
    from audiolab_tpu_torch.serve.rvc_api import update_job
    from audiolab_tpu_torch.train.data import PreprocessConfig
    from audiolab_tpu_torch.train.trainer import (
        TrainRVCConfig,
        build_index,
        prepare_dataset,
        train_rvc,
    )

    dev = resolve_device(device)

    def progress(step, msg, total):
        if job_id:
            update_job(job_id, min(0.99, step / max(total, 1)), msg)

    seconds: dict[str, float] = {}
    last = [time.perf_counter()]

    def lap(stage: str) -> None:
        now = time.perf_counter()
        seconds[stage] = now - last[0]
        last[0] = now

    def epoch_done(epoch, msg, total):
        lap(f"epoch {epoch}")
        progress(epoch, msg, total)

    dataset_dir = os.path.dirname(files[0])
    exp_dir = os.path.join(os.path.dirname(models_dir), "exp", name)
    os.makedirs(exp_dir, exist_ok=True)
    sr = int(settings.get("sr", 48000))

    # the device stages hold the server's inference lock: the card's TF32
    # flags (which a chain request's bf16 policy turns on for its
    # convolutions) and the seeded initialisers are process-wide
    progress(1, "extracting features", 10)
    pre = PreprocessConfig(sr=sr, slice_seconds=float(settings.get("slice_seconds", 3.7)))
    with INFERENCE_LOCK:
        hubert = _hubert_apply_for(settings, dev)
        lap("hubert")
        prepare_dataset(dataset_dir, exp_dir, hubert, pre, spk_id=int(settings.get("spk_id", 0)),
                        device=dev, lap=lap)
    progress(3, "building retrieval index", 10)
    with INFERENCE_LOCK:
        index_path = build_index(exp_dir, device=dev)
    lap("index")

    progress(4, "training", 10)
    overrides = dict(settings.get("synth_overrides", {}))
    overrides.setdefault("feat_channels", int(settings.get("feat_channels", 768)))
    cfg = TrainRVCConfig(
        sr=sr,
        batch_size=int(settings.get("batch_size", 4)),
        epochs=int(settings.get("epochs", 10)),
        lr=float(settings.get("lr", 1e-4)),
        save_every_epoch=int(settings.get("save_every_epoch", 5)),
        synth_overrides=overrides,
    )
    metrics = train_rvc(exp_dir, cfg, callback=epoch_done, device=dev, lock=INFERENCE_LOCK)

    os.makedirs(models_dir, exist_ok=True)
    model_path = os.path.join(models_dir, f"{name}.npz")
    shutil.copy2(os.path.join(exp_dir, "model_final.npz"), model_path)
    shutil.copy2(index_path, os.path.join(models_dir, f"{name}.index.npz"))
    lap("export")
    return {"model": os.path.basename(model_path), "metrics": metrics, "seconds": seconds}
