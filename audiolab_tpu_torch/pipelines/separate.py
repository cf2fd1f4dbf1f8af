"""Ensemble stem separation (counterpart of the ensemble path of
audiolab_tpu/pipelines/separate.py).

Each member runs on fixed-size chunk batches (core/chunking), the chunks
are crossfade-stitched, and the members' vocals and instrumentals are
blended (avg/median hybrid) and de-bled (residual subtraction with a cosine
guard).  Everything stays on the separator's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device


@dataclass
class EnsembleMember:
    """One separation model and its blend weights.  ``apply_fn`` maps a
    chunk batch (b, ch, n) to {stem: (b, ch, n)}; an ``nn.Module`` is moved
    to the separator's device."""

    name: str
    apply_fn: Callable[[torch.Tensor], dict]
    weight_vocals: float = 1.0
    weight_inst: float = 1.0


def _median(stack: torch.Tensor) -> torch.Tensor:
    """Median over axis 0, the mean of the two middle values for an even
    count (numpy's and jnp's convention; torch.median takes the lower)."""
    s = stack.sort(dim=0).values
    m = s.shape[0]
    if m % 2:
        return s[m // 2]
    return 0.5 * (s[m // 2 - 1] + s[m // 2])


def blend_tracks(tracks: list, weights: list[float]) -> torch.Tensor:
    """Avg/median hybrid blend of (ch, n) tracks."""
    stack = torch.stack(list(tracks))
    w = torch.tensor(weights, dtype=torch.float32, device=stack.device)[:, None, None]
    avg = (stack * w).sum(0) / w.sum()
    return 0.5 * (avg + _median(stack))


def debleed(target: torch.Tensor, other: torch.Tensor, alpha: float = 0.2,
            cos_guard: float = 0.5) -> torch.Tensor:
    """Subtract ``alpha`` times the projection of ``target`` on ``other``,
    only where the stems are decorrelated (|cos| <= cos_guard)."""
    t, o = target.reshape(-1), other.reshape(-1)
    dot = torch.dot(t, o)
    cos = dot / (torch.linalg.norm(t) * torch.linalg.norm(o) + 1e-9)
    proj = dot / (torch.dot(o, o) + 1e-9)
    apply = (cos.abs() <= cos_guard).float()
    return target - apply * alpha * proj * other


class StemSeparator:
    """Chunked, batched ensemble separation on one device."""

    def __init__(self, members: list[EnsembleMember], sr: int = 44100,
                 chunk_seconds: float = 8.0, overlap_seconds: float = 0.5,
                 device_batch: int = 8, matmul_precision: str = "bfloat16",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.members = members
        for m in members:
            if isinstance(m.apply_fn, torch.nn.Module):
                m.apply_fn.to(self.device).eval()
        self.sr = sr
        self.chunk_seconds = chunk_seconds
        self.overlap_seconds = overlap_seconds
        self.device_batch = device_batch
        self.matmul_precision = matmul_precision

    def _run_member(self, member: EnsembleMember, audio: torch.Tensor) -> dict:
        """Chunk -> fixed-size batched calls -> crossfade stitch."""
        ch, n = audio.shape
        plan = plan_chunks(n, int(self.chunk_seconds * self.sr),
                           int(self.overlap_seconds * self.sr))
        db = max(1, min(self.device_batch, plan.count))
        # balance the batch over the group count (35 chunks at batch 8 run
        # as 5 groups of 7, not 5 of 8 with 5 padded rows)
        n_groups = -(-plan.count // db)
        db = -(-plan.count // n_groups)
        pad = (-plan.count) % db
        chunks = extract_chunks(audio, plan)                     # (count, ch, chunk)
        if pad:
            chunks = torch.cat([chunks, chunks.new_zeros((pad,) + chunks.shape[1:])])
        groups = [member.apply_fn(chunks[g:g + db]) for g in range(0, chunks.shape[0], db)]
        out = {s: torch.cat([gr[s] for gr in groups])[: plan.count] for s in groups[0]}
        return {s: stitch_chunks(v, plan) for s, v in out.items()}

    @torch.inference_mode()
    def separate(self, audio, callback=None, as_numpy: bool = True) -> dict:
        """(ch, n) -> {"vocals": (ch, n), "instrumental": (ch, n)}.
        ``as_numpy=False`` returns tensors on the device."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        if audio.dim() == 1:
            audio = audio[None]
        vocals_tracks, inst_tracks, wv, wi = [], [], [], []
        with precision.matmul_precision(self.matmul_precision):
            for i, m in enumerate(self.members):
                if callback:
                    callback(i, f"Separating with {m.name}", len(self.members))
                stems = self._run_member(m, audio)
                v = stems.get("vocals")
                inst = stems.get("other", stems.get("instrumental"))
                if inst is None and v is not None:
                    inst = audio - v
                if v is not None:
                    vocals_tracks.append(v)
                    wv.append(m.weight_vocals)
                if inst is not None:
                    inst_tracks.append(inst)
                    wi.append(m.weight_inst)
        vb = blend_tracks(vocals_tracks, wv)
        ib = blend_tracks(inst_tracks, wi)
        vocals, inst = debleed(vb, ib), debleed(ib, vb)
        if as_numpy:
            return {"vocals": vocals.float().cpu().numpy(),
                    "instrumental": inst.float().cpu().numpy()}
        return {"vocals": vocals, "instrumental": inst}
