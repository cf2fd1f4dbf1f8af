"""Model FLOPs: the products the plain reference performs on one item of a
cell's input (matrix products, convolutions, attention), counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device, so nothing
is computed and nothing of the program is involved.  The GRU of RMVPE,
which the counter does not see, is added by its formula."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness


def count(fn) -> float:
    """FLOPs of ``fn()``, run on meta tensors by the caller."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def gru_flops(steps: int, n_in: int, hidden: int, directions: int = 2) -> float:
    """Three gates, each an input and a hidden product, per step and
    direction."""
    return 2.0 * steps * directions * 3 * hidden * (n_in + hidden)


def _ref(name: str):
    return harness.load_module(harness.ROOT / "reference" / name / "reference.py",
                               "benchmark_reference_" + name.replace("-", "_"))


@functools.lru_cache(maxsize=None)
def _per_item(model: str, cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    meta = torch.device("meta")
    if model in ("roformer", "converter"):
        ref = _ref(cfg["name"])
        sep, conv = cfg["separator"], cfg["converter"]
        if model == "roformer":
            from benchmark.reference import roformer

            with meta:
                m = roformer.BSRoformer(ref.roformer_config(sep))
            x = torch.zeros(1, sep["channels"], int(sep["chunk_s"] * sep["sr"]), device=meta)
            return count(lambda: m(x))
        index = torch.zeros(cfg["index"]["rows"], conv["hubert"]["dim"], device=meta)
        chain = ref.Chain.__new__(ref.Chain)
        from benchmark.reference import hubert, rmvpe, vits

        chain.cfg, chain.dev, chain.lower, chain.index = cfg, meta, None, index
        with meta:
            chain.hubert = hubert.Hubert(**conv["hubert"])
            chain.rmvpe = rmvpe.RMVPE()
            chain.synth = vits.Synthesizer(ref.synth_config(conv))
        chunk = int(conv["chunk_s"] * 16000)
        chunk -= chunk % 320
        x = torch.zeros(1, chunk, device=meta)
        flops = count(lambda: chain.convert_group(x, None))
        return flops + gru_flops(1 + chunk // 160, 3 * 128, 256)
    raise KeyError(model)


def per_item(model: str, cfg: dict) -> float:
    """FLOPs of one item: a chunk through one separator member
    (``"roformer"``), or one 8 s row of a converter group (``"converter"``)."""
    return _per_item(model, json.dumps(cfg, sort_keys=True))
