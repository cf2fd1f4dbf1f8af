"""RVC voice conversion (counterpart of audiolab_tpu/pipelines/rvc.py).

  16 kHz input, 48 Hz high-pass (zero-phase FIR for tensors, Butterworth
  filtfilt for numpy input) -> fixed-size chunks in device batches ->
  HuBERT features -> k-NN retrieval blend -> 2x nearest upsample to 100 Hz
  -> f0 (+ transpose) -> consonant protect blend -> coarse pitch ->
  SynthesizerTrn.infer -> crossfade stitch at the model rate -> optional
  RMS-envelope mix -> peak normalise.

f0 methods, dispatched as the JAX converter dispatches them with no crepe
model: "rmvpe" / "rmvpe_onnx" and "rmvpe+" (with an RMVPE model), "pm",
"dio" and "harvest" (host numpy), a list or "hybrid" (several methods,
median/mean merged), and YIN for everything else.  When the method needs
no separate call (YIN, or rmvpe without a model), YIN runs inside each
group's conversion step, and neither the merge nor ``f0_autotune`` applies,
as in the JAX package.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.core.audio_io import write_wav
from audiolab_tpu_torch.core.chunking import ChunkPlan, extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.f0 import coarse_f0, f0_autocorr, f0_dio, f0_harvest, f0_pm, merge_f0
from audiolab_tpu_torch.models.hubert import HubertFeatureExtractor
from audiolab_tpu_torch.models.rmvpe import RMVPE
from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerTrn
from audiolab_tpu_torch.retrieval.index import knn_blend


@dataclass
class RVCPipelineConfig:
    version: str = "v2"         # HuBERT layer 9 + proj (v1) or layer 12 (v2)
    sr: int = 48000             # model output rate
    chunk_seconds: float = 8.0  # chunk length at 16 kHz
    overlap_seconds: float = 0.4
    f0_method: str | list = "rmvpe"   # rmvpe | rmvpe+ | yin | pm | dio | harvest | hybrid | [list]
    f0_min: float = 50.0
    f0_max: float = 1100.0
    merge_type: str = "median"  # hybrid merge (median | mean)
    filter_radius: int = 3      # > 2: a 3-tap median over harvest's f0
    crepe_hop: int = 160        # crepe's hop, for when a crepe model is ported
    f0_autotune: bool = False   # snap f0 to 12-TET before synthesis
    device_batch: int = 8       # chunks per device step
    matmul_precision: str = "bfloat16"   # HuBERT / synthesizer products


_RMVPE = ("rmvpe", "rmvpe+", "rmvpe_onnx")
_HOST = {"pm": f0_pm, "dio": f0_dio, "harvest": f0_harvest}


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
    """HuBERT + synthesizer (+ optional RMVPE and retrieval index) on one
    device; :meth:`convert` is the conversion entry point, the HuBERT
    module's version the config's ``version``."""

    def __init__(self, synth: SynthesizerTrn, hubert: HubertFeatureExtractor,
                 rmvpe: RMVPE | None = None, index_features=None,
                 cfg: RVCPipelineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.synth_cfg = synth.cfg
        self.cfg = cfg or RVCPipelineConfig(sr=synth.cfg.sr)
        if hubert.version != self.cfg.version:
            raise ValueError(f"HuBERT module is {hubert.version}, config asks for "
                             f"{self.cfg.version}")
        self.synth = synth.to(self.device).eval()
        self.hubert = hubert.to(self.device).eval()
        self.rmvpe = None if rmvpe is None else rmvpe.to(self.device).eval()
        self.index_features = (None if index_features is None else
                               torch.as_tensor(index_features, dtype=torch.float32).to(self.device))

    def _convert_chunk(self, wav16, f0, sid, index_rate: float, protect: float,
                       generator: torch.Generator | None, f0_in_graph: bool = False):
        """(b, n) 16 kHz chunks + f0 (b, t100) -> audio (b, t100 * upp).
        ``f0_in_graph``: ``f0`` is the transpose factor and YIN runs here."""
        if f0_in_graph:
            f0 = self._yin(wav16) * f0
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

    def _yin(self, wav16) -> torch.Tensor:
        return f0_autocorr(wav16, sr=16000, hop=160, fmin=self.cfg.f0_min,
                           fmax=self.cfg.f0_max)[0]

    def _f0_on_host(self) -> bool:
        """True when f0 comes from a call of its own (a model, a host
        estimator or a merge), False when YIN runs inside the conversion."""
        m = self.cfg.f0_method
        if isinstance(m, (list, tuple)) or m == "hybrid":
            return True
        if m in _RMVPE:
            return self.rmvpe is not None
        return m in _HOST

    def _f0_one_method(self, method: str, wav16) -> torch.Tensor:
        """(b, n) -> (b, t) f0 Hz of one method; crepe's methods take YIN
        until a crepe model is ported, as the JAX converter does without one."""
        if method in ("rmvpe", "rmvpe_onnx") and self.rmvpe is not None:
            return self.rmvpe.infer(wav16)
        if method == "rmvpe+" and self.rmvpe is not None:
            return self.rmvpe.infer_with_pitch(wav16, f0_min=self.cfg.f0_min,
                                               f0_max=self.cfg.f0_max)
        if method in _HOST:
            rows = [_HOST[method](w, sr=16000, hop=160, fmin=self.cfg.f0_min,
                                  fmax=self.cfg.f0_max)
                    for w in wav16.float().cpu().numpy()]
            f0 = np.stack(rows)
            if method == "harvest" and self.cfg.filter_radius > 2:
                f0 = sps.medfilt(f0, (1, 3))
            return torch.from_numpy(np.asarray(f0, np.float32)).to(wav16.device)
        return self._yin(wav16)

    def _extract_f0(self, wav16, transpose: int) -> torch.Tensor:
        """(b, n) -> (b, t100) f0 Hz at 100 frames/s, transposed."""
        m = self.cfg.f0_method
        if isinstance(m, (list, tuple)) or m == "hybrid":
            if isinstance(m, (list, tuple)):
                methods = list(m)
            elif self.rmvpe is not None:
                methods = ["harvest", "rmvpe+"]
            else:
                methods = ["harvest", "yin"]
            rows = [self._f0_one_method(meth, wav16) for meth in methods]
            t = min(r.shape[-1] for r in rows)
            f0 = merge_f0(torch.stack([r[..., :t] for r in rows]), self.cfg.merge_type)
        else:
            f0 = self._f0_one_method(m, wav16)
        if self.cfg.f0_autotune:
            # snap voiced frames to the nearest 12-TET note
            semis = torch.round(12.0 * torch.log2(torch.clamp(f0, min=1e-3) / 440.0))
            f0 = torch.where(f0 > 0, 440.0 * 2.0 ** (semis / 12.0), f0)
        return f0 * (2.0 ** (transpose / 12.0))

    @staticmethod
    def _to_t100(f0: np.ndarray, n_samples: int) -> np.ndarray:
        """An f0 curve on another hop -> the 100 Hz frame grid of an
        ``n_samples`` chunk, by linear interpolation on the host (the crepe
        methods' step when crepe_hop != 160)."""
        t100 = 1 + n_samples // 160
        if f0.shape[-1] == t100:
            return f0
        src = np.asarray(f0, np.float64)
        pos = np.linspace(0, len(src) - 1, t100)
        return np.interp(pos, np.arange(len(src)), src).astype(np.float32)

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
        fuse_f0 = not self._f0_on_host()
        factor = torch.full((1, 1), 2.0 ** (transpose / 12.0), device=self.device)
        outs = []
        with precision.matmul_precision(self.cfg.matmul_precision):
            for g in range(0, chunks.shape[0], db):
                group = chunks[g:g + db]
                f0 = factor if fuse_f0 else self._extract_f0(group, transpose)
                # every group draws its noise from the same seed, as the
                # JAX pipeline hands every group the same PRNG key
                gen = torch.Generator(device=self.device).manual_seed(seed)
                outs.append(self._convert_chunk(group, f0, sids, index_rate, protect, gen,
                                                f0_in_graph=fuse_f0))
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
        if not as_numpy:
            return y
        result = y.float().cpu().numpy()
        self._debug_dump(x, result)
        return result

    def _debug_dump(self, x16, out: np.ndarray) -> None:
        """With ``AUDIOLAB_SAVE_DEBUG_AUDIO=<dir>`` set, writes the high-passed
        16 kHz input and the converted output of each call to that directory."""
        dbg = os.environ.get("AUDIOLAB_SAVE_DEBUG_AUDIO")
        if not dbg:
            return
        os.makedirs(dbg, exist_ok=True)
        tag = f"{int(time.time() * 1000) % 10**9:09d}"
        if isinstance(x16, torch.Tensor):
            x16 = x16.float().cpu().numpy()
        write_wav(os.path.join(dbg, f"{tag}_input16k_hp.wav"), np.asarray(x16, np.float32),
                  16000)
        write_wav(os.path.join(dbg, f"{tag}_converted.wav"), np.asarray(out, np.float32),
                  self.synth_cfg.sr)

    def sweep_convert(self, audio16k, out_dir: str, sid: int = 0,
                      index_rates=(0.0, 0.5, 0.75), protects=(0.2, 0.33, 0.5),
                      transposes=(0,), name: str = "sweep") -> list[str]:
        """One converted WAV per (index rate, protect, transpose) combination,
        named after it; returns the paths written."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for ir, pr, tr in itertools.product(index_rates, protects, transposes):
            y = self.convert(audio16k, sid=sid, transpose=tr, index_rate=ir, protect=pr)
            p = os.path.join(out_dir, f"{name}_ir{ir:g}_pr{pr:g}_tr{tr:+d}.wav")
            write_wav(p, y, self.synth_cfg.sr)
            paths.append(p)
        return paths
