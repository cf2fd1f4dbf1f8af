"""Tensor-parallel placement of the shared TransformerLM core
(counterpart of audiolab_tpu/parallel/tp.py).

Megatron's layout over the mesh axis ``tp``, under the port's LLaMA names:

  - ``q_proj``, ``k_proj``, ``v_proj``, ``gate_proj``, ``up_proj``:
    column-parallel, each rank holding a slice of the output features
    (``Shard(0)`` of the (out, in) weight);
  - ``o_proj``, ``down_proj``: row-parallel, each rank holding the matching
    slice of the input features (``Shard(1)``), the partial outputs summed
    by an ``all_reduce`` over ``tp`` after each;
  - the embedding, the norms and the head: replicated.

The JAX package leaves the collectives to XLA, which shards any width.
Here a rank computes whole heads, so ``n_heads`` and ``n_kv_heads`` (and
``ffn_dim``) must divide by ``tp``; the sharded attention carries its own
local head counts.  The uncached forward still takes ``flash_attention``:
each rank launches K2 on its own heads.  The sharded model serves that
forward; the all-reduce carries no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from audiolab_tpu_torch.core.mesh import Mesh

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")


def _spec_for(name: str):
    """The placement over ``tp`` of the parameter ``name``."""
    from torch.distributed.tensor import Replicate, Shard

    parts = name.split(".")
    if len(parts) >= 2 and parts[-1] == "weight":
        if parts[-2] in COLUMN_PARALLEL:
            return Shard(0)
        if parts[-2] in ROW_PARALLEL:
            return Shard(1)
    return Replicate()


def lm_tp_shardings(model: nn.Module, mesh: Mesh) -> dict:
    """Parameter name -> its placement over the mesh's ``tp`` axis."""
    return {name: _spec_for(name) for name, _ in model.named_parameters()}


class RowParallelLinear(nn.Module):
    """A rank's slice of a bias-free Linear's input features; the outputs
    of the tp group's ranks are summed (``all_reduce``) after the product,
    in fp32 for a 16-bit layer (one rounding of the sum, as the unsharded
    product's fp32 accumulation has)."""

    def __init__(self, weight: torch.Tensor, group):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.group = group

    def forward(self, x):
        y = nn.functional.linear(x, self.weight)
        if y.dtype in (torch.bfloat16, torch.float16):
            total = y.float()
            dist.all_reduce(total, group=self.group)
            return total.to(y.dtype)
        dist.all_reduce(y, group=self.group)
        return y


def _column(lin: nn.Linear, index: int, count: int) -> nn.Linear:
    out = lin.out_features // count
    new = nn.Linear(lin.in_features, out, bias=False, dtype=lin.weight.dtype,
                    device=lin.weight.device)
    with torch.no_grad():
        new.weight.copy_(lin.weight[index * out:(index + 1) * out])
    return new


def _row(lin: nn.Linear, index: int, count: int, group) -> RowParallelLinear:
    width = lin.in_features // count
    return RowParallelLinear(lin.weight.detach()[:, index * width:(index + 1) * width].clone(),
                             group)


def shard_lm_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """This rank's tensor-parallel share of a ``TransformerLM`` (every rank
    holding the same replicated weights), made in place and returned: each
    ``Linear`` cut as :func:`lm_tp_shardings` places its weight (``Shard(0)``
    column-parallel, ``Shard(1)`` row-parallel) and each attention given
    the local head counts.  A mesh of tp 1 leaves the model as it is.  Raises
    ``ValueError`` when a head count or ``ffn_dim`` does not divide by tp,
    and for a one-process mesh, whose slots no rank can reach."""
    tp = mesh.shape["tp"]
    if tp == 1:
        return model
    if not mesh.distributed:
        raise ValueError("tensor parallelism needs a mesh over the ranks of a process group")
    cfg = model.cfg
    bad = [f"{k} {getattr(cfg, k)}" for k in ("n_heads", "n_kv_heads", "ffn_dim")
           if getattr(cfg, k) % tp]
    if bad:
        raise ValueError(f"tp {tp} must divide {', '.join(bad)}: a rank computes whole "
                         "heads and equal shares")
    from torch.distributed.tensor import Shard

    index, group = mesh.coordinate("tp"), mesh.group("tp")
    for name, lin in list(model.named_modules()):
        spec = _spec_for(f"{name}.weight") if isinstance(lin, nn.Linear) else None
        if isinstance(spec, Shard):
            parent, _, attr = name.rpartition(".")
            cut = (_column(lin, index, tp) if spec.dim == 0
                   else _row(lin, index, tp, group))
            setattr(model.get_submodule(parent), attr, cut)
    for layer in model.model.layers:
        attn = layer.self_attn
        attn.n_heads, attn.n_kv_heads = cfg.n_heads // tp, cfg.n_kv_heads // tp
    return model
