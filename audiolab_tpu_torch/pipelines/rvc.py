"""RVC voice conversion (counterpart of the rmvpe path of
audiolab_tpu/pipelines/rvc.py).

  16 kHz input, 48 Hz high-pass (zero-phase FIR for tensors, Butterworth
  filtfilt for numpy input) -> fixed-size chunks in device batches ->
  HuBERT features -> k-NN retrieval blend -> 2x nearest upsample to 100 Hz
  -> RMVPE f0 (+ transpose) -> consonant protect blend -> coarse pitch ->
  SynthesizerTrn.infer -> crossfade stitch at the model rate -> optional
  RMS-envelope mix -> peak normalise.

Only ``f0_method="rmvpe"`` is ported in this slice; the other f0 methods
raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.core.chunking import ChunkPlan, extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.f0 import coarse_f0
from audiolab_tpu_torch.models.hubert import HubertFeatureExtractor
from audiolab_tpu_torch.models.rmvpe import RMVPE
from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerTrn
from audiolab_tpu_torch.retrieval.index import knn_blend


@dataclass
class RVCPipelineConfig:
    """The JAX package's config without ``version`` (the HuBERT module that
    the converter is given fixes it) and the f0 options of methods this
    port does not run."""

    sr: int = 48000             # model output rate
    chunk_seconds: float = 8.0  # chunk length at 16 kHz
    overlap_seconds: float = 0.4
    f0_method: str = "rmvpe"
    f0_min: float = 50.0
    f0_max: float = 1100.0
    device_batch: int = 8       # chunks per device step
    matmul_precision: str = "bfloat16"   # HuBERT / synthesizer products


def _highpass_taps() -> np.ndarray:
    return sps.firwin(257, 48, fs=16000, pass_zero=False).astype(np.float32)


def _highpass_device(x: torch.Tensor) -> torch.Tensor:
    """Zero-phase 257-tap 48 Hz FIR high-pass on the device, reflect-padded,
    applied along the last axis."""
    taps = torch.from_numpy(_highpass_taps()[::-1].copy()).to(x.device)
    pad = (taps.shape[0] - 1) // 2
    lead = x.shape[:-1]
    flat = x.float().reshape(-1, 1, x.shape[-1])
    flat = F.pad(flat, (pad, pad), mode="reflect")
    return F.conv1d(flat, taps[None, None]).reshape(*lead, -1)


def _mix_rms(x16: torch.Tensor, y: torch.Tensor, out_sr: int, rate: float) -> torch.Tensor:
    """Blend the output's 1 s RMS envelope toward the input's; rate=1 keeps
    the converted envelope."""
    def env(sig, sr):
        frame, hop = sr, sr // 2
        n = sig.shape[-1]
        k = max(1 + (n - 1) // hop, 1)
        pad = (k - 1) * hop + frame - n
        s = F.pad(sig, (0, max(pad, 0)))
        idx = torch.arange(k, device=sig.device)[:, None] * hop + torch.arange(
            frame, device=sig.device)[None]
        return torch.sqrt((s[idx] ** 2).mean(-1) + 1e-12)

    def interp_to(r, n):
        pos = torch.linspace(0, r.shape[0] - 1, n, device=r.device)
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=r.shape[0] - 1)
        w = pos - lo
        return r[lo] * (1 - w) + r[hi] * w

    n = y.shape[-1]
    r1 = interp_to(env(x16, 16000), n)
    r2 = torch.clamp(interp_to(env(y, out_sr), n), min=1e-6)
    return y * r1 ** (1 - rate) * r2 ** (rate - 1)


class VoiceConverter:
    """HuBERT + synthesizer + RMVPE (+ optional retrieval index) on one
    device; :meth:`convert` is the conversion entry point."""

    def __init__(self, synth: SynthesizerTrn, hubert: HubertFeatureExtractor,
                 rmvpe: RMVPE | None = None, index_features=None,
                 cfg: RVCPipelineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.synth_cfg = synth.cfg
        self.cfg = cfg or RVCPipelineConfig(sr=synth.cfg.sr)
        self.synth = synth.to(self.device).eval()
        self.hubert = hubert.to(self.device).eval()
        self.rmvpe = None if rmvpe is None else rmvpe.to(self.device).eval()
        self.index_features = (None if index_features is None else
                               torch.as_tensor(index_features, dtype=torch.float32).to(self.device))

    def _convert_chunk(self, wav16, f0, sid, index_rate: float, protect: float,
                       generator: torch.Generator | None):
        """(b, n) 16 kHz chunks + f0 (b, t100) -> audio (b, t100 * upp)."""
        feats = self.hubert(wav16)                                # (b, t50, d)
        feats0 = feats
        if self.index_features is not None and index_rate > 0:
            b, t, d = feats.shape
            feats = knn_blend(feats.reshape(b * t, d), self.index_features,
                              index_rate).reshape(b, t, d)
        feats = feats.repeat_interleave(2, dim=1)
        feats0 = feats0.repeat_interleave(2, dim=1)
        t100 = min(feats.shape[1], f0.shape[1])
        feats, feats0, f0 = feats[:, :t100], feats0[:, :t100], f0[:, :t100]
        # consonant protection: toward the un-indexed features where unvoiced
        pitchff = torch.where(f0[..., None] > 0, torch.ones_like(f0[..., None]),
                              torch.full_like(f0[..., None], protect))
        feats = feats * pitchff + feats0 * (1.0 - pitchff)
        pitch = coarse_f0(f0, self.cfg.f0_min, self.cfg.f0_max)
        lengths = torch.full((wav16.shape[0],), t100, dtype=torch.long, device=wav16.device)
        return self.synth.infer(feats, lengths, pitch, f0, sid, generator=generator)

    def _extract_f0(self, wav16, transpose: int) -> torch.Tensor:
        if self.cfg.f0_method != "rmvpe" or self.rmvpe is None:
            raise NotImplementedError(
                "this port runs f0_method='rmvpe' with an RMVPE model only")
        return self.rmvpe.infer(wav16) * (2.0 ** (transpose / 12.0))

    @torch.inference_mode()
    def convert(self, audio16k, sid: int = 0, transpose: int = 0, index_rate: float = 0.75,
                protect: float = 0.33, rms_mix_rate: float = 1.0, seed: int = 0,
                as_numpy: bool = True):
        """Mono 16 kHz track (numpy or tensor) -> waveform at the model rate.
        Tensors are high-passed on the device; numpy input on the host."""
        if isinstance(audio16k, torch.Tensor):
            x = _highpass_device(audio16k.to(self.device))
        else:
            b, a = sps.butter(5, 48, btype="high", fs=16000)
            x16 = sps.filtfilt(b, a, np.asarray(audio16k, dtype=np.float32)).astype(np.float32)
            x = torch.from_numpy(x16).to(self.device)
        chunk = int(self.cfg.chunk_seconds * 16000)
        chunk -= chunk % 320     # HuBERT hop: frames tile each chunk exactly
        overlap = int(self.cfg.overlap_seconds * 16000)
        overlap -= overlap % 320
        plan = plan_chunks(x.shape[-1], chunk, overlap)
        chunks = extract_chunks(x, plan)                          # (count, chunk)
        db = max(1, min(self.cfg.device_batch, plan.count))
        pad_rows = (-plan.count) % db
        if pad_rows:
            chunks = torch.cat([chunks, chunks.new_zeros((pad_rows,) + chunks.shape[1:])])
        sids = torch.full((db,), sid, dtype=torch.long, device=self.device)
        outs = []
        with precision.matmul_precision(self.cfg.matmul_precision):
            for g in range(0, chunks.shape[0], db):
                group = chunks[g:g + db]
                f0 = self._extract_f0(group, transpose)
                # every group draws its noise from the same seed, as the
                # JAX pipeline hands every group the same PRNG key
                gen = torch.Generator(device=self.device).manual_seed(seed)
                outs.append(self._convert_chunk(group, f0, sids, index_rate, protect, gen))
        out = torch.cat(outs)[: plan.count]
        scale = self.synth_cfg.sr / 16000.0
        out_hop = int(round(plan.hop * scale))
        out_plan = ChunkPlan(chunk=out.shape[-1], hop=out_hop, n=int(round(plan.n * scale)),
                             count=plan.count,
                             padded=(plan.count - 1) * out_hop + out.shape[-1])
        y = stitch_chunks(out, out_plan)
        if rms_mix_rate < 1.0:
            y = _mix_rms(x, y, self.synth_cfg.sr, rms_mix_rate)
        peak = y.abs().max()
        y = torch.where(peak > 0.99, y * (0.99 / torch.clamp(peak, min=1e-9)), y)
        return y.float().cpu().numpy() if as_numpy else y
