"""ACE-Step-class flow-matching text-to-music, the in-repo base model
(counterpart of audiolab_tpu/models/acestep.py): a DCAE over mel frames,
the shared DiT (``models/dit.py``), the byte text encoder of
``models/stable_audio.py`` for genre tags and a lyric embedding, APG
guidance, the checkpoint sampler's sigma schedule, and the flow-matching
solve (Euler, Heun, PingPong; ``z_init``/``t_start``, repaint, the guidance
interval and its decay, omega's mean shift).

flax defaults mirrored: ``nn.GroupNorm`` takes eps 1e-6, ``nn.gelu`` is the
tanh form, ``Conv``/``ConvTranspose`` with ``padding="SAME"`` as in
``models/stable_audio.py``.  Parameter names are the flax tree's joined by
``.``.  The JAX solve splits ``jax.random`` keys inside ``lax.scan``; here
every draw comes from a :class:`Draws` (by default seeded
``torch.Generator``s, or one the caller passes), made before the loop.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.models.codecs import _ConvSame, _ConvTransposeSame
from audiolab_tpu_torch.models.dit import DiT, DiTConfig
from audiolab_tpu_torch.models.ksampler import linspace_f32
from audiolab_tpu_torch.models.stable_audio import TextEncoder
from audiolab_tpu_torch.models.wavegrad import SameConv1d

# ------------------------------------------------------------------ DCAE


@dataclass(frozen=True)
class DCAEConfig:
    n_mels: int = 128
    latent_dim: int = 8
    base_ch: int = 64
    ratios: Sequence[int] = (2, 2, 2)   # temporal compression 8x

    @property
    def hop(self) -> int:
        return int(np.prod(self.ratios))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class DCAEEncoder(nn.Module):
    """(b, t, n_mels) -> (b, t / hop, latent_dim)."""

    def __init__(self, cfg: DCAEConfig = DCAEConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        self.conv_in = _ConvSame(c.n_mels, c.base_ch, 3)
        ch = c.base_ch
        for i, r in enumerate(c.ratios):
            self.add_module(f"gn_{i}", nn.GroupNorm(8, ch, eps=1e-6))
            self.add_module(f"down_{i}", SameConv1d(ch, 2 * ch, 2 * r, stride=r))
            ch *= 2
        self.conv_out = _ConvSame(ch, c.latent_dim, 3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(mel.transpose(1, 2))
        for i in range(len(self.cfg.ratios)):
            h = getattr(self, f"down_{i}")(_gelu(getattr(self, f"gn_{i}")(h)))
        return self.conv_out(_gelu(h)).transpose(1, 2)


class DCAEDecoder(nn.Module):
    """(b, t, latent_dim) -> (b, t * hop, n_mels)."""

    def __init__(self, cfg: DCAEConfig = DCAEConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        ch = c.base_ch * 2 ** len(c.ratios)
        self.conv_in = _ConvSame(c.latent_dim, ch, 3)
        for i, r in enumerate(reversed(c.ratios)):
            self.add_module(f"gn_{i}", nn.GroupNorm(8, ch, eps=1e-6))
            self.add_module(f"up_{i}", _ConvTransposeSame(ch, ch // 2, r))
            ch //= 2
        self.conv_out = _ConvSame(ch, c.n_mels, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.transpose(1, 2))
        for i in range(len(self.cfg.ratios)):
            h = getattr(self, f"up_{i}")(_gelu(getattr(self, f"gn_{i}")(h)))
        return self.conv_out(_gelu(h)).transpose(1, 2)


# ------------------------------------------------------------------ lyric tokenizer

_LANG_TAG = re.compile(r"\[(verse|chorus|bridge|intro|outro|inst|en|zh|ja|ko)\]",
                       re.IGNORECASE)


def segment_languages(text: str) -> list[tuple[str, str]]:
    """Unicode-script language segmentation: [(lang, run)] with lang in
    en/zh/ja/ko, split at script boundaries (whitespace joins the run before
    it)."""

    def script_of(ch: str) -> str:
        o = ord(ch)
        if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
            return "zh"
        if 0x3040 <= o <= 0x30FF:
            return "ja"
        if 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF:
            return "ko"
        return "en"

    runs: list[tuple[str, list[str]]] = []
    for ch in text:
        lang = script_of(ch)
        if ch.isspace() and runs:
            runs[-1][1].append(ch)
        elif runs and runs[-1][0] == lang:
            runs[-1][1].append(ch)
        else:
            runs.append((lang, [ch]))
    return [(lang, "".join(chars)) for lang, chars in runs if "".join(chars).strip()]


def tokenize_lyrics(text: str, max_len: int = 1024) -> np.ndarray:
    """Structure tags ([verse], [chorus], ..., [en] ...) as control tokens
    1-10, UTF-8 bytes shifted by 16; cut and zero-padded to ``max_len``."""
    tags = ["verse", "chorus", "bridge", "intro", "outro", "inst", "en", "zh", "ja", "ko"]
    out: list[int] = []
    pos = 0
    for m in _LANG_TAG.finditer(text):
        out.extend(b + 16 for b in text[pos: m.start()].encode("utf-8"))
        out.append(1 + tags.index(m.group(1).lower()))
        pos = m.end()
    out.extend(b + 16 for b in text[pos:].encode("utf-8"))
    ids = np.zeros(max_len, np.int32)
    trunc = out[:max_len]
    ids[: len(trunc)] = trunc
    return ids


# ------------------------------------------------------------------ model

@dataclass
class ACEStepConfig:
    sr: int = 44100
    mel_hop: int = 512            # audio samples per mel frame
    dcae: DCAEConfig = field(default_factory=DCAEConfig)
    dit: DiTConfig = field(default_factory=lambda: DiTConfig(
        dim=1024, n_layers=16, n_heads=16, cond_dim=768, in_dim=8, out_dim=8))
    text_dim: int = 768
    text_layers: int = 4
    lyric_vocab: int = 300

    @property
    def latent_rate(self) -> float:
        return self.sr / (self.mel_hop * self.dcae.hop)


class ACEStepModel(nn.Module):
    def __init__(self, cfg: ACEStepConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.dcae_encoder = DCAEEncoder(c.dcae)
        self.dcae_decoder = DCAEDecoder(c.dcae)
        self.dit = DiT(c.dit)
        self.text_encoder = TextEncoder(c.text_dim, c.text_layers, max(1, c.text_dim // 64))
        self.lyric_emb = nn.Embedding(c.lyric_vocab, c.text_dim)

    def encode_cond(self, tag_ids, lyric_ids):
        """Genre-tag text and lyrics -> one context stream."""
        return torch.cat([self.text_encoder(tag_ids), self.lyric_emb(lyric_ids.long())], dim=1)

    def velocity(self, z, t, context):
        return self.dit(z, t, context)

    def velocity_hidden(self, z, t, context, depth: int):
        """The velocity and the hidden states after DiT block ``depth``."""
        return self.dit(z, t, context, return_hidden_at=depth)

    def encode_mel(self, mel):
        return self.dcae_encoder(mel)

    def decode_latent(self, z):
        return self.dcae_decoder(z)


# ------------------------------------------------------------------ APG guidance

def apg(cond: torch.Tensor, uncond: torch.Tensor, scale: float, momentum: torch.Tensor,
        beta: float = -0.75, eta: float = 0.0, norm_threshold: float = 2.5,
        channels: int | None = None):
    """Adaptive projected guidance: the CFG delta momentum-filtered (beta
    -0.75), norm-clipped at ``norm_threshold`` and split into the parts
    parallel and orthogonal to ``cond``; ``eta`` of the parallel part
    survives.  ``channels``: reduce per (b, channel) over (t, features /
    channels), the checkpoint latents' torch dims (-1, -2); None reduces over
    everything but the batch.  Returns (guided, new momentum)."""
    diff = cond - uncond
    momentum = beta * momentum + diff
    if channels is not None:
        b, t, f = diff.shape
        dr = momentum.reshape(b, t, channels, f // channels)
        cr = cond.reshape(b, t, channels, f // channels)
        red = (1, 3)
    else:
        dr, cr = momentum[..., None], cond[..., None]
        red = (1, 2)
    norm = torch.sqrt(torch.sum(dr * dr, dim=red, keepdim=True))
    dr = dr * torch.clamp(norm_threshold / (norm + 1e-15), max=1.0)
    cn = cr / (torch.sqrt(torch.sum(cr * cr, dim=red, keepdim=True)) + 1e-12)
    parallel = torch.sum(dr * cn, dim=red, keepdim=True) * cn
    upd = ((dr - parallel) + eta * parallel).reshape(cond.shape)
    return cond + (scale - 1.0) * upd, momentum


def acestep_sigmas(steps: int, shift: float = 3.0, num_train_timesteps: int = 1000) -> np.ndarray:
    """(steps + 1,) fp32: linspace(1, 1/1000, steps) time-shifted
    s' = shift s / (1 + (shift - 1) s), then 0."""
    base = linspace_f32(1.0, 1.0 / num_train_timesteps, steps)
    shifted = np.float32(shift) * base / (np.float32(1.0) + np.float32(shift - 1.0) * base)
    return np.concatenate([shifted, np.zeros(1, np.float32)]).astype(np.float32)


# ------------------------------------------------------------------ sampling

class Draws:
    """The samplers' standard normals, each stream from a ``torch.Generator``
    on ``device``: :meth:`normal` a tensor of ``shape`` for a seed,
    :meth:`steps` (steps, per_step, *shape) for a solve's per-step noise.
    A caller that needs other draws (the parity tests pass JAX's) passes an
    object with the same two methods."""

    def __init__(self, device):
        self.device = torch.device(device)

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, seed: int, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen(2 * seed), device=self.device)

    def steps(self, seed: int, steps: int, per_step: int, shape: tuple) -> torch.Tensor:
        return torch.randn((steps, per_step, *shape), generator=self._gen(2 * seed + 1),
                           device=self.device)


def _guidance_scales(steps: int, start: int, end: int, scale: float, decay: float,
                     min_scale: float) -> np.ndarray:
    scales = np.full(steps, scale, np.float32)
    if decay > 0 and end - start > 1:
        for i in range(start, end):
            progress = (i - start) / (end - start - 1)
            scales[i] = scale - (scale - min_scale) * progress * decay
    return scales


@torch.inference_mode()
def fm_sample(
    model: ACEStepModel | None,
    context2: torch.Tensor,      # (2b, s, cond_dim) [cond; uncond]
    t_latent: int,
    steps: int = 27,
    scheduler: str = "euler",    # euler | heun | pingpong
    guidance_scale: float = 7.5,
    use_apg: bool = True,
    z_init: torch.Tensor | None = None,
    t_start: float = 1.0,
    repaint_mask: torch.Tensor | None = None,   # (b, t, 1): 1 = regenerate
    z_ref: torch.Tensor | None = None,          # kept where mask == 0
    velocity2_fn: Callable | None = None,
    sigmas=None,
    timestep_scale: float = 1.0,
    omega_scale: float | None = None,
    guidance_interval: float = 1.0,
    guidance_interval_decay: float = 0.0,
    min_guidance_scale: float = 3.0,
    velocity_cond_fn: Callable | None = None,
    velocity_uncond_fn: Callable | None = None,
    apg_channels: int | None = None,
    seed: int = 0,
    draws: Draws | None = None,
) -> torch.Tensor:
    """Flow-matching ODE solve from z_1 (noise) to z_0 (data) with a CFG
    double batch; v = eps - z0 (z_t = (1 - t) z0 + t eps).

    ``z_init`` None starts from ``draws.normal(seed, (b, t_latent,
    latent_dim))``; PingPong and repaint take their per-step normals from
    ``draws.steps(seed, steps, k, z.shape)`` (k = 1 or 2; PingPong's first).
    ``velocity2_fn(z2, t2)`` replaces the model's doubled-batch velocity,
    ``velocity_cond_fn``/``velocity_uncond_fn(z, t)`` the two halves apart.
    ``sigmas`` (steps + 1,) replaces linspace(t_start, 0); the DiT's
    timestep is sigma * ``timestep_scale``.  ``omega_scale`` mean-shifts the
    Euler step, (dx - mean) logistic(omega) + mean.  ``guidance_interval``
    guides the middle fraction of steps only (outside, the conditional
    velocity alone, and the APG momentum untouched), with the scale decayed
    linearly across it by ``guidance_interval_decay`` toward
    ``min_guidance_scale``."""
    b = context2.shape[0] // 2
    dev = context2.device
    draws = draws or Draws(dev)
    if z_init is not None:
        z = z_init.to(dev, torch.float32)
    else:
        z = draws.normal(seed, (b, t_latent, model.cfg.dcae.latent_dim)).to(torch.float32)
    if sigmas is not None:
        ts = np.asarray(sigmas, np.float32)
        steps = ts.shape[0] - 1
    else:
        ts = linspace_f32(t_start, 0.0, steps + 1)
    momentum = torch.zeros_like(z)

    if guidance_interval < 1.0:
        start_idx = int(steps * ((1.0 - guidance_interval) / 2.0))
        end_idx = int(steps * (guidance_interval / 2.0 + 0.5))
    else:
        start_idx, end_idx = 0, steps
    scales = _guidance_scales(steps, start_idx, end_idx, guidance_scale,
                              guidance_interval_decay, min_guidance_scale)

    repaint = repaint_mask is not None and z_ref is not None
    per_step = int(scheduler == "pingpong") + int(repaint)
    step_noise = draws.steps(seed, steps, per_step, tuple(z.shape)) if per_step else None

    def t_batch(t, n):
        return torch.full((n,), float(np.float32(t) * np.float32(timestep_scale)), device=dev)

    def vel_both(z, t):
        if velocity_cond_fn is not None:
            tb = t_batch(t, b)
            return velocity_cond_fn(z, tb), velocity_uncond_fn(z, tb)
        z2, tb = torch.cat([z, z]), t_batch(t, 2 * b)
        v = velocity2_fn(z2, tb) if velocity2_fn is not None else model.velocity(z2, tb, context2)
        return v[:b], v[b:]

    def vel_cond(z, t):
        if velocity_cond_fn is not None:
            return velocity_cond_fn(z, t_batch(t, b))
        return vel_both(z, t)[0]

    def guide(vc, vu, mom, scale):
        if use_apg:
            return apg(vc, vu, scale, mom, channels=apg_channels)
        return vu + scale * (vc - vu), mom

    if omega_scale is not None:
        omega = 0.9 + 0.2 / (1.0 + math.exp(-0.1 * omega_scale))

    def euler_dx(v, dt):
        dx = dt * v
        if omega_scale is not None:
            m = dx.mean()
            dx = (dx - m) * omega + m
        return dx

    for i in range(steps):
        guided = start_idx <= i < end_idx
        t_cur, t_next = ts[i], ts[i + 1]
        dt = float(np.float32(t_next - t_cur))
        if guided:
            vc, vu = vel_both(z, t_cur)
            v, momentum = guide(vc, vu, momentum, float(scales[i]))
        else:
            v = vel_cond(z, t_cur)
        k = 0
        if scheduler == "heun":
            z_e = z + dt * v
            if guided:
                vc2, vu2 = vel_both(z_e, t_next)
                v2, momentum = guide(vc2, vu2, momentum, float(scales[i]))
            else:
                v2 = vel_cond(z_e, t_next)
            z = z + dt * 0.5 * (v + v2)
        elif scheduler == "pingpong":
            x0 = z - float(t_cur) * v
            z = (1.0 - float(t_next)) * x0 + float(t_next) * step_noise[i, 0]
            k = 1
        else:
            z = z + euler_dx(v, dt)
        if repaint:
            z_keep = (1.0 - float(t_next)) * z_ref + float(t_next) * step_noise[i, k]
            z = repaint_mask * z + (1.0 - repaint_mask) * z_keep
    return z


# ------------------------------------------------------------------ LoRA

def lora_apply(state_dict: dict, lora: dict, alpha: float = 1.0) -> dict:
    """A copy of a model's ``state_dict`` with ``alpha * (a @ b)`` merged into
    each adapted Linear: ``lora`` maps a module path (a tuple, the flax tree's
    path, e.g. ``("dit", "block_0", "wq")``) to its factors ``{"a": (din,
    rank), "b": (rank, dout)}``."""
    out = dict(state_dict)
    for path, ab in lora.items():
        key = ".".join(path) + ".weight"
        w = out[key]
        a, b = (torch.as_tensor(np.asarray(ab[n]), dtype=w.dtype, device=w.device)
                for n in ("a", "b"))
        out[key] = w + alpha * (a @ b).T
    return out
