"""Exact k-NN feature retrieval for RVC (counterpart of
audiolab_tpu/retrieval/index.py: ``_topk_l2`` and ``knn_blend``).

Blocked exact search by squared L2 with a running top-k merge; fp32
throughout (this is plain code, not a kernel).
"""

from __future__ import annotations

import torch


def _topk_l2(queries: torch.Tensor, data: torch.Tensor, k: int = 8,
             block: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by squared L2: (dist^2 (t, k), idx (t, k)), nearest first."""
    t = queries.shape[0]
    q = queries.float()
    q_norm = (q * q).sum(-1, keepdim=True)
    best_d = torch.full((t, k), float("inf"), device=q.device)
    best_i = torch.full((t, k), -1, dtype=torch.long, device=q.device)
    for s in range(0, data.shape[0], block):
        blk = data[s:s + block].float()
        d2 = q_norm + (blk * blk).sum(-1)[None, :] - 2.0 * (q @ blk.T)
        ids = torch.arange(s, s + blk.shape[0], device=q.device).expand(t, -1)
        cand_d = torch.cat([best_d, d2], dim=-1)
        cand_i = torch.cat([best_i, ids], dim=-1)
        best_d, pos = torch.topk(cand_d, k, dim=-1, largest=False)
        best_i = torch.gather(cand_i, -1, pos)
    return best_d, best_i


def knn_blend(queries: torch.Tensor, data: torch.Tensor, index_rate: float = 0.75,
              k: int = 8) -> torch.Tensor:
    """RVC retrieval mix: 1/d^2-weighted average of the k nearest rows,
    blended with the query at ``index_rate``."""
    d2, idx = _topk_l2(queries, data, k=k)
    w = 1.0 / torch.clamp(d2, min=1e-9)
    w = w / w.sum(-1, keepdim=True)
    neigh = data.float()[idx]                                  # (t, k, d)
    blended = torch.einsum("tk,tkd->td", w, neigh)
    return index_rate * blended + (1.0 - index_rate) * queries
