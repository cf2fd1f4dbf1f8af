"""Realtime streaming voice conversion (counterpart of
audiolab_tpu/pipelines/rvc_stream.py; reference: modules/rvc/infer/lib/
rtrvc.py:456 — chunked realtime RVC with SOLA splicing and rolling input
context).

One fixed-shape conversion (context + hop window) on the converter's device
per incoming block; the SOLA (synchronized overlap-add) search runs on the
host over a small correlation window.  State = rolling 16 kHz input buffer
+ previous output tail.  A library only: no route serves it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiolab_tpu_torch.pipelines.rvc import VoiceConverter


@dataclass
class StreamConfig:
    block_seconds: float = 0.25     # incoming hop per call
    context_seconds: float = 1.75   # rolling left context fed to the model
    sola_search_ms: float = 10.0
    crossfade_ms: float = 40.0
    sr_in: int = 16000


class StreamingVC:
    """Push 16 kHz blocks in, get model-rate converted blocks out; the
    conversion runs where ``vc`` runs."""

    def __init__(self, vc: VoiceConverter, cfg: StreamConfig | None = None,
                 sid: int = 0, transpose: int = 0, index_rate: float = 0.0):
        self.vc = vc
        self.cfg = cfg or StreamConfig()
        self.sid = sid
        self.transpose = transpose
        self.index_rate = index_rate
        c = self.cfg
        self.block = int(c.block_seconds * c.sr_in) // 320 * 320
        self.context = int(c.context_seconds * c.sr_in) // 320 * 320
        self.buffer = np.zeros(self.context + self.block, np.float32)
        sr_out = vc.synth_cfg.sr
        self.scale = sr_out / c.sr_in
        self.block_out = int(self.block * self.scale)
        self.sola_search = int(c.sola_search_ms / 1000.0 * sr_out)
        self.fade = int(c.crossfade_ms / 1000.0 * sr_out)
        self._tail = np.zeros(self.fade + self.sola_search, np.float32)
        self._primed = False

    @torch.inference_mode()
    def _convert_window(self, wav16: np.ndarray) -> np.ndarray:
        vc = self.vc
        x = torch.from_numpy(np.ascontiguousarray(wav16, np.float32)).to(vc.device)[None]
        f0 = vc._extract_f0(x, self.transpose)
        sid = torch.full((1,), self.sid, dtype=torch.long, device=vc.device)
        gen = torch.Generator(device=vc.device).manual_seed(0)
        out = vc._convert_chunk(x, f0, sid, self.index_rate, 0.33, gen)
        return out[0].float().cpu().numpy()

    def push(self, block16: np.ndarray) -> np.ndarray:
        """One realtime step: returns ``block_out`` converted samples at the
        model rate, SOLA-spliced against the previous call's tail."""
        x = np.asarray(block16, np.float32)
        if len(x) != self.block:
            pad = self.block - len(x)
            x = np.pad(x, (0, max(pad, 0)))[: self.block]
        self.buffer = np.concatenate([self.buffer[self.block:], x])

        out_full = self._convert_window(self.buffer)  # (ctx+block)*scale
        # the region corresponding to the new block, plus search+fade lead-in
        lead = self.sola_search + self.fade
        start = len(out_full) - self.block_out - lead
        seg = out_full[max(0, start):]

        if not self._primed:
            self._primed = True
            out = seg[lead: lead + self.block_out]
            self._tail = seg[lead + self.block_out - len(self._tail):].copy() \
                if len(seg) >= self.block_out + lead else np.zeros_like(self._tail)
            return out.copy()

        # SOLA: find the shift in [0, sola_search) maximizing correlation of
        # the new segment's head with the previous tail
        head = seg[: self.fade + self.sola_search]
        prev = self._tail[: self.fade]
        best, best_corr = 0, -np.inf
        for s in range(self.sola_search):
            w = head[s: s + self.fade]
            denom = np.sqrt(np.sum(w * w) * np.sum(prev * prev)) + 1e-8
            corr = float(np.dot(w, prev) / denom)
            if corr > best_corr:
                best_corr, best = corr, s
        ramp = np.linspace(0.0, 1.0, self.fade, dtype=np.float32)
        spliced = prev * (1 - ramp) + head[best: best + self.fade] * ramp
        body = seg[best + self.fade: best + self.fade + self.block_out - self.fade]
        out = np.concatenate([spliced, body])[: self.block_out]
        if len(out) < self.block_out:
            out = np.pad(out, (0, self.block_out - len(out)))
        tail_start = best + self.block_out
        tail = seg[tail_start: tail_start + len(self._tail)]
        self._tail = np.pad(tail, (0, len(self._tail) - len(tail)))
        return out
