"""Checkpoints (counterpart of audiolab_tpu/train/checkpoint.py; reference:
modules/rvc/infer/lib/train/utils.py:71-165 save/load of G/D + optimizer +
step, and process_ckpt.py:13-56 ``savee``, the deployable weight-only export).

The full train state (the resume path) is one ``torch.save`` file per step,
loaded with ``torch.load(weights_only=True)``; the JAX package's Orbax
checkpoints are not read.  The deployable export is the JAX package's own
``.npz``: generator parameters under their flax names joined by ``/``,
``enc_q`` dropped, the config as JSON in ``__config__``, so that a model
trained by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig
from audiolab_tpu_torch.utils.weights import synthesizer_to_jax


class CheckpointManager:
    """``ckpt_{step}.pt`` files in one directory, the newest ``max_to_keep``
    kept.  Saves are synchronous: ``wait_until_finished`` has nothing to
    wait for."""

    _NAME = re.compile(r"ckpt_(\d+)\.pt$")

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.dir = Path(ckpt_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.dir.iterdir()
                      if (m := self._NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: dict) -> None:
        tmp = self.dir / f"ckpt_{step}.pt.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.dir / f"ckpt_{step}.pt")
        for old in self.all_steps()[:-self.max_to_keep]:
            (self.dir / f"ckpt_{old}.pt").unlink()

    def restore(self, step: int, map_location=None) -> dict:
        return torch.load(self.dir / f"ckpt_{step}.pt", map_location=map_location,
                          weights_only=True)

    def wait_until_finished(self) -> None:
        pass


def checkpoint_manager(ckpt_dir: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(ckpt_dir, max_to_keep)


def save_train_state(mgr: CheckpointManager, step: int, state) -> None:
    mgr.save(step, {"step": state.step, "gen": state.gen.state_dict(),
                    "disc": state.disc.state_dict(), "g_opt": state.g_opt.state_dict(),
                    "d_opt": state.d_opt.state_dict()})


def restore_train_state(mgr: CheckpointManager, template):
    """Load the latest checkpoint into ``template`` (an RVCTrainState) in
    place and return it, or None when there is none."""
    step = mgr.latest_step()
    if step is None:
        return None
    dev = next(template.gen.parameters()).device
    payload = mgr.restore(step, map_location=dev)
    template.gen.load_state_dict(payload["gen"])
    template.disc.load_state_dict(payload["disc"])
    template.g_opt.load_state_dict(payload["g_opt"])
    template.d_opt.load_state_dict(payload["d_opt"])
    template.step = int(payload["step"])
    return template


def _flatten(params: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def export_generator(path: str, gen, cfg: SynthesizerConfig) -> str:
    """Deployable weight-only export (``savee``): the generator (a module,
    its state_dict, or a flax-named tree) without ``enc_q``, the train-only
    posterior encoder (process_ckpt.py:21), with its config embedded."""
    if isinstance(gen, torch.nn.Module):
        gen = gen.state_dict()
    tree = gen if "enc_p" in gen else synthesizer_to_jax(gen)
    flat = _flatten({k: v for k, v in tree.items() if k != "enc_q"})
    cfg_json = json.dumps(
        {k: (list(v) if isinstance(v, tuple) else v) for k, v in asdict(cfg).items()},
        default=lambda o: list(o))
    np.savez(path, __config__=cfg_json, **flat)
    return path


def load_generator(path: str) -> tuple[dict, SynthesizerConfig]:
    """(flax-named parameter tree, config) of an exported ``.npz``; the port
    module's state_dict is ``synthesizer_from_jax(tree)``."""
    data = np.load(path, allow_pickle=False)
    raw = json.loads(str(data["__config__"]))
    for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
        raw[k] = tuple(raw[k])
    raw["resblock_dilation_sizes"] = tuple(tuple(d) for d in raw["resblock_dilation_sizes"])
    cfg = SynthesizerConfig(**raw)
    flat = {k: data[k] for k in data.files if k != "__config__"}
    return _unflatten(flat), cfg


def extract_small_model(ckpt_dir: str, out_path: str, cfg: SynthesizerConfig) -> str:
    """Deployable export from the latest full training checkpoint
    (process_ckpt.py:70 ``extract_small_model``)."""
    mgr = checkpoint_manager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return export_generator(out_path, mgr.restore(step, map_location="cpu")["gen"], cfg)


def merge_models(path_a: str, path_b: str, out_path: str, alpha: float = 0.5) -> str:
    """Weighted merge of two exported generators with matching configs
    (process_ckpt.py:212 ckpt merge): w = alpha * a + (1 - alpha) * b."""
    pa, cfg_a = load_generator(path_a)
    pb, cfg_b = load_generator(path_b)
    if cfg_a != cfg_b:
        raise ValueError("cannot merge: configs differ")
    fa, fb = _flatten(pa), _flatten(pb)
    merged = {k: alpha * fa[k] + (1.0 - alpha) * fb[k] for k in fa}
    return export_generator(out_path, _unflatten(merged), cfg_a)
