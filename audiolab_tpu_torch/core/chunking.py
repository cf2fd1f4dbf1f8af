"""Fixed-size chunking of long audio and the crossfade stitch that puts the
processed chunks back together (counterpart of audiolab_tpu/core/chunking.py).

Chunks are a leading batch axis, so a model sees every chunk of a track in
a few fixed-shape batched calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ChunkPlan:
    """Static description of a chunked view of a signal.

    chunk:   samples per chunk
    hop:     chunk stride; overlap = chunk - hop
    n:       original signal length
    count:   number of chunks
    padded:  padded signal length = (count - 1) * hop + chunk
    """

    chunk: int
    hop: int
    n: int
    count: int
    padded: int

    @property
    def overlap(self) -> int:
        return self.chunk - self.hop


def plan_chunks(n: int, chunk: int, overlap: int = 0) -> ChunkPlan:
    if not 0 <= overlap < chunk:
        raise ValueError(f"overlap {overlap} must be in [0, chunk {chunk})")
    hop = chunk - overlap
    count = max(1, -(-max(n - overlap, 1) // hop))
    padded = (count - 1) * hop + chunk
    return ChunkPlan(chunk=chunk, hop=hop, n=n, count=count, padded=padded)


def extract_chunks(x: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """``(..., n) -> (count, ..., chunk)``, zero-padded at the end."""
    pad = plan.padded - plan.n
    if pad:
        x = F.pad(x, (0, pad))
    out = x.unfold(-1, plan.chunk, plan.hop)  # (..., count, chunk)
    return out.movedim(-2, 0).contiguous()


def crossfade_window(plan: ChunkPlan, dtype=torch.float32, device=None) -> torch.Tensor:
    """(count, chunk) weights: linear fades over each overlap, ones elsewhere."""
    count, chunk, ov = plan.count, plan.chunk, plan.overlap
    win = torch.ones(count, chunk, dtype=dtype, device=device)
    if ov and count > 1:
        fade = torch.linspace(0.0, 1.0, ov + 2, dtype=dtype, device=device)[1:-1]
        win[1:, :ov] = win[1:, :ov] * fade
        win[:-1, chunk - ov:] = win[:-1, chunk - ov:] * fade.flip(0)
    return win


def stitch_chunks(chunks: torch.Tensor, plan: ChunkPlan,
                  crossfade: bool = True) -> torch.Tensor:
    """Overlap-add ``(count, ..., chunk) -> (..., n)`` with linear crossfade."""
    count, chunk = chunks.shape[0], chunks.shape[-1]
    if count != plan.count or chunk != plan.chunk:
        raise ValueError(f"chunks {tuple(chunks.shape)} do not match {plan}")
    if plan.overlap and crossfade:
        win = crossfade_window(plan, chunks.dtype, chunks.device)
        chunks = chunks * win.reshape((count,) + (1,) * (chunks.dim() - 2) + (chunk,))
    out = chunks.new_zeros(chunks.shape[1:-1] + (plan.padded,))
    for i in range(count):
        s = i * plan.hop
        out[..., s:s + chunk] += chunks[i]
    return out[..., : plan.n]
