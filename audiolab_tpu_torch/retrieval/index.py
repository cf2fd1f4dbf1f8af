"""Exact k-NN feature retrieval for RVC (counterpart of
audiolab_tpu/retrieval/index.py).

Blocked exact search by squared L2 with a running top-k merge, Lloyd's
k-means for compacting a large feature set, and :class:`FeatureIndex`, the
build/save/load wrapper (a plain ``.npz`` of the feature matrix); fp32
throughout (this is plain code, not a kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device


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


def kmeans(x: torch.Tensor, n_clusters: int = 10000, iters: int = 20, seed: int = 0,
           init: torch.Tensor | None = None) -> torch.Tensor:
    """Lloyd's k-means of ``(n, d)`` rows on their device -> ``(n_clusters, d)``
    centres.  ``init``: the starting centres; by default ``n_clusters`` rows
    drawn with a numpy generator seeded with ``seed`` (with replacement only
    when there are fewer rows than clusters).  Each step assigns every row
    to its nearest centre (:func:`_topk_l2`) and moves each centre to the
    mean of its rows; a centre with no row stays where it is."""
    x = x.float()
    n = x.shape[0]
    if init is None:
        rows = np.random.default_rng(seed).choice(n, n_clusters, replace=n < n_clusters)
        init = x[torch.from_numpy(rows).to(x.device)]
    c = init.float().to(x.device)
    for _ in range(iters):
        assign = _topk_l2(x, c, k=1)[1][:, 0]
        counts = torch.bincount(assign, minlength=n_clusters).float()[:, None]
        sums = torch.zeros_like(c).index_add_(0, assign, x)
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
    return c


class FeatureIndex:
    """A retrieval feature matrix: built (k-means-compacted past
    ``compact_threshold`` rows), saved and loaded as ``.npz``, and queried
    on ``device``."""

    def __init__(self, features: np.ndarray, device: str | torch.device = "cuda"):
        self.features = np.ascontiguousarray(features, dtype=np.float32)
        self.device = resolve_device(device)
        self._device_data = None

    @classmethod
    def build(cls, features: np.ndarray, compact_threshold: int = 200_000,
              n_clusters: int = 10_000, device: str | torch.device = "cuda") -> "FeatureIndex":
        if len(features) > compact_threshold:
            dev = resolve_device(device)
            x = torch.from_numpy(np.asarray(features, np.float32)).to(dev)
            features = kmeans(x, n_clusters=n_clusters).cpu().numpy()
        return cls(features, device)

    def save(self, path: str) -> None:
        np.savez_compressed(path, features=self.features)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "FeatureIndex":
        return cls(np.load(path)["features"], device)

    def device_data(self) -> torch.Tensor:
        if self._device_data is None:
            self._device_data = torch.from_numpy(self.features).to(self.device)
        return self._device_data

    def blend(self, queries: torch.Tensor, index_rate: float = 0.75, k: int = 8) -> torch.Tensor:
        return knn_blend(queries, self.device_data(), index_rate, k=k)
