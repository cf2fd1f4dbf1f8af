"""ACE-Step LoRA fine-tuning (counterpart of audiolab_tpu/train/acestep_lora.py;
upstream trainer.py:36-890): the flow-matching MSE on DCAE latents with
low-rank factors on the DiT's self-attention projections (``wq``, ``wk``,
``wv``, ``wo``), and the optional SSL projection loss (trainer.py:145-298,
ace_step_transformer.py:478-520): the hidden states after DiT block
``ssl_depth``, projected and interpolated to the SSL frame rate, are pulled
toward a frozen SSL model's features by a cosine loss, the projector
trained with the factors.

The base weights stay frozen: each step runs the DiT through
:class:`~audiolab_tpu_torch.models.acestep.LoRAModel`, the path that serves
an adapter (``torch.func.functional_call`` on ``lora_weights``: the DiT's
own weights detached, the factors merged differentiably), so only the
factors and the projector get gradients.  The self-attention's gradient flows through the
attention kernel's ``autograd.Function`` (``kernels/attention.py``: K1 at
the default 32-frame segments, the 16-bit K2 past 128 frames).  The
optimizer is ``torch.optim.Adam(lr, eps=1e-8)``, which is optax's ``adam``
(bias-corrected moments, eps outside the square root).  The batch picks
replay the JAX loop's ``np.random.default_rng(0)``; each step's t and
noise come from ``draws(step)`` or a generator seeded by (seed, step).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.models.acestep import LoRAModel, lora_init, tokenize_lyrics
from audiolab_tpu_torch.models.stable_audio import tokenize_prompt

log = logging.getLogger(__name__)


@dataclass
class LoRATrainConfig:
    rank: int = 8
    lr: float = 1e-4
    steps: int = 200
    seg_latent: int = 32      # latent frames per training example
    batch_size: int = 2
    alpha: float = 1.0
    ssl_coeff: float = 0.0    # the SSL projection loss's weight; 0 disables it
    ssl_depth: int = 1        # the DiT block whose output is projected


def _interp_time(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Linear interpolation along axis 1 (``F.interpolate`` mode "linear",
    half-pixel centres), written as the JAX function writes it."""
    n_in = x.shape[1]
    pos = (torch.arange(n_out, device=x.device, dtype=torch.float32) + 0.5) * n_in / n_out - 0.5
    lo = torch.clamp(torch.floor(pos).long(), 0, n_in - 1)
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    w = torch.clamp(pos - lo, 0.0, 1.0)[None, :, None]
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


def ssl_projection_loss(hidden, proj: dict, ssl_target) -> torch.Tensor:
    """The mean cosine distance between the projected inner states
    (``proj``: ``{"kernel": (dim, ssl_dim), "bias": (ssl_dim,)}``),
    interpolated to the SSL frame rate, and the frozen SSL features."""
    est = hidden.float() @ proj["kernel"] + proj["bias"]
    est = _interp_time(est, ssl_target.shape[1])
    est = est / torch.clamp(torch.linalg.norm(est, dim=-1, keepdim=True), min=1e-6)
    tgt = ssl_target / torch.clamp(torch.linalg.norm(ssl_target, dim=-1, keepdim=True), min=1e-6)
    return torch.mean(1.0 - torch.sum(est * tgt, dim=-1))


def flow_match_loss(model, z0, ctx, t, eps, hidden_at: int | None = None):
    """MSE(v_pred, eps - z0) at times ``t`` (b,) with noise ``eps``: the
    rectified-flow objective.  ``model`` gives ``velocity`` and
    ``velocity_hidden`` (an adapted one: :class:`LoRAModel`); with
    ``hidden_at`` the hidden states after that DiT block come back beside
    the loss."""
    tt = t[:, None, None]
    z_t = (1.0 - tt) * z0 + tt * eps
    if hidden_at is None:
        v, hidden = model.velocity(z_t, t, ctx), None
    else:
        v, hidden = model.velocity_hidden(z_t, t, ctx, hidden_at)
    loss = torch.mean((v.float() - (eps - z0)) ** 2)
    return loss if hidden_at is None else (loss, hidden)


def seeded_draws(seed: int, batch: int, seg: int, latent_dim: int, device) -> Callable:
    """``draws(step) -> (t (b,), eps (b, seg, latent_dim))`` from a
    ``torch.Generator`` seeded by (seed, step) on ``device``."""
    dev = torch.device(device)

    def draws(step: int):
        g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + step)
        t = torch.rand((batch,), generator=g, device=dev)
        return t, torch.randn((batch, seg, latent_dim), generator=g, device=dev)

    return draws


def _segments(items, cfg: LoRATrainConfig, rng_np, use_ssl: bool, ssl_frames: int):
    """One batch of the JAX loop's picks: latent crops (or zero-padded
    clips), their contexts and the matching SSL spans."""
    batch_z, batch_ctx, batch_ssl = [], [], []
    for _ in range(cfg.batch_size):
        z, ctx, feats = items[rng_np.integers(len(items))]
        t = z.shape[1]
        if t >= cfg.seg_latent:
            s = rng_np.integers(0, t - cfg.seg_latent + 1)
            z_seg = z[:, s: s + cfg.seg_latent]
        else:
            s = 0
            z_seg = F.pad(z, (0, 0, 0, cfg.seg_latent - t))
        batch_z.append(z_seg[0])
        batch_ctx.append(ctx[0])
        if use_ssl:
            t_ssl = feats.shape[0]
            s0 = int(round(s / max(t, 1) * t_ssl))
            seg = feats[s0: s0 + ssl_frames]
            if seg.shape[0] < ssl_frames:
                seg = F.pad(seg, (0, 0, 0, ssl_frames - seg.shape[0]))
            batch_ssl.append(seg)
    ssl = torch.stack(batch_ssl) if use_ssl else None
    return torch.stack(batch_z), torch.stack(batch_ctx), ssl


def train_lora(pipeline, dataset: list[tuple[np.ndarray, str, str]],
               cfg: LoRATrainConfig | None = None, callback=None, ssl_model=None,
               draws: Callable | None = None, lora: dict | None = None,
               proj: dict | None = None, seed: int = 0) -> dict:
    """Train LoRA factors for ``pipeline`` (an ``ACEStepPipeline``; its
    weights are not changed) on ``dataset`` of (audio at the pipeline's
    rate, prompt, lyrics).  Returns ``{"lora": {path: {"a", "b"}}, "loss":
    float}`` and, with the SSL loss, ``"proj"``.

    ``ssl_model(audio) -> (t, d)`` (or (1, t, d)) frozen features, needed
    when ``cfg.ssl_coeff > 0``.  ``lora``/``proj`` are starting values
    (default :func:`lora_init` and a N(0, 0.02) projector from ``seed``);
    ``draws(step) -> (t, eps)`` the per-step draws (default
    :func:`seeded_draws`).  ``callback(step, message, total)`` every tenth
    of the run."""
    cfg = cfg or LoRATrainConfig()
    model = pipeline.model
    dev = pipeline.device
    use_ssl = cfg.ssl_coeff > 0.0 and ssl_model is not None

    items, ssl_dim = [], None
    with torch.no_grad():
        for audio, prompt, lyrics in dataset:
            z = pipeline._latents_of_audio(audio).float()
            tag = torch.from_numpy(tokenize_prompt(prompt, 64)[None]).to(dev)
            lyr = torch.from_numpy(tokenize_lyrics(lyrics, 128)[None]).to(dev)
            ctx = model.encode_cond(tag, lyr).float()
            feats = None
            if use_ssl:
                # a copy: features made under inference_mode cannot be saved for backward
                feats = torch.as_tensor(ssl_model(audio), dtype=torch.float32, device=dev).clone()
                if feats.dim() == 3:
                    feats = feats[0]
                ssl_dim = int(feats.shape[-1])
            items.append((z, ctx, feats))

    if lora is None:
        lora = lora_init(model.dit, cfg.rank, seed=seed)
    factors = {p: {n: torch.as_tensor(ab[n], dtype=torch.float32, device=dev).clone()
                   .requires_grad_(True) for n in ("a", "b")} for p, ab in lora.items()}
    params = [ab[n] for ab in factors.values() for n in ("a", "b")]
    proj_state = None
    if use_ssl:
        if proj is None:
            g = torch.Generator().manual_seed(seed + 7)
            proj = {"kernel": torch.randn((model.cfg.dit.dim, ssl_dim), generator=g) * 0.02,
                    "bias": torch.zeros((ssl_dim,))}
        proj_state = {n: torch.as_tensor(proj[n], dtype=torch.float32, device=dev).clone()
                      .requires_grad_(True) for n in ("kernel", "bias")}
        params += [proj_state["kernel"], proj_state["bias"]]
    opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8)
    draws = draws or seeded_draws(seed, cfg.batch_size, cfg.seg_latent,
                                  model.cfg.dcae.latent_dim, dev)

    rng_np = np.random.default_rng(0)
    ssl_frames = max(4, min(int(it[2].shape[0]) for it in items)) if use_ssl else 0
    loss = torch.tensor(float("nan"))
    for i in range(cfg.steps):
        z0, ctx, ssl_tgt = _segments(items, cfg, rng_np, use_ssl, ssl_frames)
        t, eps = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in draws(i))
        adapted = LoRAModel(model, factors, cfg.alpha)
        if use_ssl:
            loss, hidden = flow_match_loss(adapted, z0, ctx, t, eps, cfg.ssl_depth)
            loss = loss + cfg.ssl_coeff * ssl_projection_loss(hidden, proj_state, ssl_tgt)
        else:
            loss = flow_match_loss(adapted, z0, ctx, t, eps)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if callback and (i + 1) % max(1, cfg.steps // 10) == 0:
            callback(i + 1, f"lora step {i + 1}: loss {loss.item():.4f}", cfg.steps)
    out = {"lora": {p: {n: ab[n].detach() for n in ("a", "b")} for p, ab in factors.items()},
           "loss": float(loss.detach())}
    if use_ssl:
        out["proj"] = {n: x.detach() for n, x in proj_state.items()}
    return out


def save_lora(path: str, lora: dict) -> None:
    """An ``.npz`` with the JAX package's keys: ``"/".join(path) + ".a"``
    and ``".b"``, so an adapter trained by either package loads in the
    other."""
    flat = {}
    for p, ab in lora.items():
        key = "/".join(p)
        for n in ("a", "b"):
            x = ab[n]
            flat[f"{key}.{n}"] = (x.detach().float().cpu().numpy() if torch.is_tensor(x)
                                  else np.asarray(x, np.float32))
    np.savez(path, **flat)


def load_lora(path: str) -> dict:
    """``{path tuple: {"a", "b"}}`` of CPU fp32 tensors from :func:`save_lora`'s
    (or the JAX package's) ``.npz``."""
    out: dict = {}
    with np.load(path) as data:
        for k in data.files:
            key, which = k.rsplit(".", 1)
            out.setdefault(tuple(key.split("/")), {})[which] = torch.from_numpy(
                np.array(data[k], np.float32))
    return out
