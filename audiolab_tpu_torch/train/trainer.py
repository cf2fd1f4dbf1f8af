"""RVC training orchestrator (counterpart of audiolab_tpu/train/trainer.py;
reference: layouts/rvc_train.py:524-727 ``train1key`` and
modules/rvc/infer/modules/train/train.py:254-788).

One process on one card, or (under ``torchrun``, the default process
group started by ``core.distributed.init_distributed``) one rank per card
with the data-parallel step: every rank reads the same loader batches,
takes its shard of each, and rank 0 alone writes the checkpoints, the
exported voice and the state file while the others wait at a barrier.  The
reference's LossTracker EMA smoothing and best-checkpoint / early-stop
logic (train.py:57-239) is the JAX package's small pure-python class,
copied.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.distributed import init_distributed, rank_device, rows, world_size
from audiolab_tpu_torch.core.mesh import get_mesh
from audiolab_tpu_torch.models.rvc.synthesizer import config_for
from audiolab_tpu_torch.retrieval.index import FeatureIndex
from audiolab_tpu_torch.train.checkpoint import (
    checkpoint_manager,
    export_generator,
    restore_train_state,
    save_train_state,
)
from audiolab_tpu_torch.train.data import (
    LoaderConfig,
    PreprocessConfig,
    RVCDataLoader,
    extract_features,
    preprocess_dataset,
    write_filelist,
)
from audiolab_tpu_torch.train.rvc import MEL_CFG, create_train_state, make_train_step

log = logging.getLogger(__name__)


class LossTracker:
    """EMA loss smoothing + plateau / upslope early-stop
    (train.py:57-239 semantics: smoothed gen-total; 'best' tracked; stop on
    sustained upslope or long plateau)."""

    def __init__(self, ema: float = 0.95, patience: int = 25, min_delta: float = 1e-3):
        self.ema_w = ema
        self.patience = patience
        self.min_delta = min_delta
        self.ema: float | None = None
        self.best = float("inf")
        self.best_step = 0
        self.stale = 0

    def update(self, loss: float, step: int) -> None:
        self.ema = loss if self.ema is None else self.ema_w * self.ema + (1 - self.ema_w) * loss
        if self.ema < self.best - self.min_delta:
            self.best = self.ema
            self.best_step = step
            self.stale = 0
        else:
            self.stale += 1

    @property
    def is_best(self) -> bool:
        return self.stale == 0

    def should_early_stop(self) -> bool:
        return self.stale >= self.patience


@dataclass
class TrainRVCConfig:
    sr: int = 48000
    version: str = "v2"
    batch_size: int = 4
    epochs: int = 20
    lr: float = 1e-4
    save_every_epoch: int = 5
    spk_id: int = 0
    # under a process group of more than one rank: shard each batch over the
    # ranks (the batch size must divide by their count)
    use_mesh: bool = True
    early_stop: bool = True
    synth_overrides: dict = field(default_factory=dict)


def prepare_dataset(dataset_dir: str, exp_dir: str, hubert_apply,
                    pre: PreprocessConfig | None = None, spk_id: int = 0,
                    device: str | torch.device = "cuda", lap=None) -> str:
    """preprocess -> feature/f0 extract -> filelist (train1key steps 1-3).
    ``lap(stage)``, when given, is called after the preprocess and after
    the features.  Raises when the dataset gives no slice."""
    n = preprocess_dataset(dataset_dir, exp_dir, pre or PreprocessConfig())
    if n == 0:
        raise ValueError("dataset produced no training slices (clips too short or silent)")
    log.info("preprocess: %d slices", n)
    if lap:
        lap("preprocess")
    m = extract_features(exp_dir, hubert_apply, device=device)
    log.info("features: %d", m)
    out = write_filelist(exp_dir, sid=spk_id)
    if lap:
        lap("features")
    return out


def build_index(exp_dir: str, n_clusters: int | None = None,
                device: str | torch.device = "cuda") -> str:
    """Retrieval index from the extracted features (k-means on ``device``
    past 200k rows — layouts/rvc_train.py:448-524 equivalent)."""
    feats = [np.load(p) for p in sorted((Path(exp_dir) / "feats").glob("*.npy"))]
    if not feats:
        raise ValueError(f"no features in {exp_dir}/feats")
    rows = np.concatenate(feats, axis=0).astype(np.float32)
    idx = FeatureIndex.build(rows, device=device,
                             **({"n_clusters": n_clusters} if n_clusters else {}))
    out = str(Path(exp_dir) / "index.npz")
    idx.save(out)
    return out


def train_rvc(exp_dir: str, cfg: TrainRVCConfig | None = None, callback=None,
              device: str | torch.device = "cuda", lock=None) -> dict:
    """Epoch loop on ``device`` (default the card; raises without one) with
    resume from ``exp_dir/ckpt``, periodic + best checkpointing and the
    small export.  ``lock``, when given, is held around building the state
    and around each step: a server passes its inference lock, because the
    card's TF32 flags and the seeded initialisers are process-wide.
    Under a process group of more than one rank, ``device`` is the rank's
    card and every rank returns the same metrics.
    Returns the last step's metrics."""
    dev = resolve_device(device)
    lock = lock or contextlib.nullcontext()
    cfg = cfg or TrainRVCConfig()
    exp = Path(exp_dir)
    synth_cfg = config_for(cfg.sr, cfg.version)
    if cfg.synth_overrides:
        synth_cfg = replace(synth_cfg, **cfg.synth_overrides)

    mel = MEL_CFG[cfg.sr]
    loader = RVCDataLoader(
        str(exp / "filelist.json"),
        LoaderConfig(sr=cfg.sr, n_fft=mel["n_fft"], hop=mel["hop"],
                     win_length=mel["n_fft"], batch_size=cfg.batch_size), device=dev)
    steps_per_epoch = max(1, len(loader))
    mgr = checkpoint_manager(str(exp / "ckpt"))
    with lock:
        state, _, _ = create_train_state(synth_cfg, seed=0, lr=cfg.lr,
                                         steps_per_epoch=steps_per_epoch, device=dev)
        if restore_train_state(mgr, state) is not None:
            log.info("resumed from step %d", state.step)
    world = world_size()
    if world > 1 and not (cfg.use_mesh and cfg.batch_size % world == 0):
        raise ValueError(f"{world} ranks need use_mesh and a batch size that divides by "
                         f"them, not {cfg.batch_size}")
    mesh = get_mesh() if world > 1 else None
    shard = mesh.coordinate("dp") if mesh else 0
    writer = shard == 0
    step_fn = make_train_step(synth_cfg, mesh=mesh)

    def wait() -> None:
        if mesh:
            dist.barrier()

    tracker = LossTracker()
    metrics: dict = {}
    t_start = time.time()
    start_epoch = state.step // steps_per_epoch
    for epoch in range(start_epoch, cfg.epochs):
        for batch in loader.batches():
            if mesh:
                batch = {k: rows(v, shard, world) for k, v in batch.items()}
            with lock:
                state, metrics = step_fn(state, batch, 1)
        vals = {k: float(v) for k, v in metrics.items()}
        gen_total = vals["loss_gen_total"]
        tracker.update(gen_total, state.step)
        if callback and writer:
            callback(epoch + 1, f"epoch {epoch + 1}: gen {gen_total:.3f} "
                     f"disc {vals['loss_disc']:.3f}", cfg.epochs)
        if writer:
            log.info("epoch %d step %d gen %.3f disc %.3f mel %.3f (%.1fs)",
                     epoch + 1, state.step, gen_total, vals["loss_disc"], vals["loss_mel"],
                     time.time() - t_start)
        if tracker.is_best and writer:
            export_generator(str(exp / "model_best.npz"), state.gen, synth_cfg)
        if ((epoch + 1) % cfg.save_every_epoch == 0 or epoch + 1 == cfg.epochs) and writer:
            save_train_state(mgr, state.step, state)
        wait()
        if cfg.early_stop and tracker.should_early_stop():
            log.info("early stop at epoch %d", epoch + 1)
            break
    final = {k: float(v) for k, v in metrics.items()}
    if writer:
        mgr.wait_until_finished()
        export_generator(str(exp / "model_final.npz"), state.gen, synth_cfg)
        (exp / "train_state.json").write_text(json.dumps({"step": state.step,
                                                          "metrics": final}))
    wait()
    return final


def main(argv=None) -> int:
    """Train a prepared experiment directory (its ``filelist.json``, from
    :func:`prepare_dataset`), one rank per card under torchrun:

        torchrun --nproc_per_node=4 -m audiolab_tpu_torch.train.trainer EXP_DIR \\
            --batch-size 8 --epochs 20

    or ``python -m audiolab_tpu_torch.train.trainer EXP_DIR`` on one card.
    The process group comes from torchrun's environment
    (``init_distributed``); rank 0 prints the last step's metrics as JSON."""
    ap = argparse.ArgumentParser(prog="python -m audiolab_tpu_torch.train.trainer")
    ap.add_argument("exp_dir")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--version", default="v2")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--save-every-epoch", type=int, default=5)
    ap.add_argument("--no-early-stop", action="store_true")
    ap.add_argument("--synth-overrides", default="{}", help="JSON of SynthesizerConfig fields")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)
    started = not dist.is_initialized()
    info = init_distributed(device=args.device)
    device = rank_device() if info["process_count"] > 1 else args.device
    cfg = TrainRVCConfig(sr=args.sr, version=args.version, batch_size=args.batch_size,
                         epochs=args.epochs, save_every_epoch=args.save_every_epoch,
                         early_stop=not args.no_early_stop,
                         synth_overrides=json.loads(args.synth_overrides))
    metrics = train_rvc(args.exp_dir, cfg, device=device)
    if info["process_index"] == 0:
        print(json.dumps(metrics))
    if started and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
