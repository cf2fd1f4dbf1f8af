"""WaveTransfer training and inference (counterpart of
audiolab_tpu/train/wavetransfer.py; reference modules/wavetransfer/main.py:110
train_model, learner.py:50-487 WaveGradLearner, main.py:36-106
CancellationToken, bddm/sampler.py:38 chunked inference,
layouts/wavetransfer.py project management):

  - a "project" holds paired (source, target) WAVs of the same phrase; the
    model learns the target's timbre conditioned on the source's mel
  - training: L1 noise loss, Adam, EMA decay 0.9999, periodic checkpoints,
    cooperative cancellation, resume from the newest checkpoint
  - inference: chunked, batched sampling over a short noise schedule and a
    crossfade stitch

Checkpoints are torch files through train/checkpoint.py's
``CheckpointManager`` (the JAX package's Orbax checkpoints are not read).
``generate`` and the super-resolution loader build the model from its
config and read the newest checkpoint: unlike the JAX package they need no
prepared WAVs and no template state.  Under a process group of more than
one rank, whose count must divide the batch size as the JAX trainer's
data-parallel branch asks of its devices, each rank takes its shard of
every global batch and of every step's global draws, the gradients are
averaged over the ranks before Adam (so the weights and the EMA stay equal
on every rank), the reported loss is the global batch's, and rank 0 alone
writes checkpoints while the others wait at a barrier.  A batch the ranks
cannot split raises ``ValueError``: the JAX trainer then runs unsharded in
its one process, but here each rank would train the whole batch and write
the same checkpoints.

Everything is fp32; on the card TF32 is off (core/precision.py).  The
randomness is explicit: the batches come from a numpy generator (the JAX
package's, draw for draw), each step's noise level and noise from a torch
generator seeded with the step (or from ``draws``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.distributed import average_gradients, rows, world_size
from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.models.wavegrad import (
    FAST_6,
    TRAIN_SCHEDULE,
    NoiseSchedule,
    SameConv1d,
    WaveGrad,
    WaveGradConfig,
    diffusion_loss,
    lecun_init,
    loss_draws,
    sample,
)
from audiolab_tpu_torch.train.checkpoint import checkpoint_manager

log = logging.getLogger(__name__)


class CancellationToken:
    """Cooperative cancel for threaded training (main.py:36-106)."""

    def __init__(self):
        self._ev = threading.Event()

    def cancel(self):
        self._ev.set()

    @property
    def cancelled(self) -> bool:
        return self._ev.is_set()


@dataclass
class WTConfig:
    sr: int = 24000
    n_mels: int = 128
    seg_frames: int = 24           # training segment: seg_frames * hop samples
    batch_size: int = 8
    lr: float = 2e-4
    steps: int = 1000
    ema: float = 0.9999
    ckpt_every: int = 500
    model: WaveGradConfig = field(default_factory=WaveGradConfig)


def _mel_of(wav: torch.Tensor, cfg: WTConfig) -> torch.Tensor:
    """Log-mel (b, frames, n_mels) with exactly len(wav)//hop frames (center
    pad, then crop) so the sampler's t*hop output matches the audio."""
    frames = wav.shape[-1] // cfg.model.hop
    m = log_mel(mel_spectrogram(wav, sr=cfg.sr, n_fft=1024, hop=cfg.model.hop,
                                win_length=1024, n_mels=cfg.n_mels, power=1.0,
                                center=True))
    return m[..., :frames, :]


def preprocess_project(project_dir: str, cfg: WTConfig | None = None) -> int:
    """Resample every WAV in <project>/data to cfg.sr mono into
    <project>/prepared (layouts/wavetransfer.py:108-159); host numpy."""
    cfg = cfg or WTConfig()
    data = Path(project_dir) / "data"
    out = Path(project_dir) / "prepared"
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(data.glob("*.wav")):
        a = read_audio(str(p)).to_mono()
        x = np.asarray(a.samples[0], np.float32)
        if a.sample_rate != cfg.sr:
            x = resample_poly_np(x, a.sample_rate, cfg.sr)
        write_wav(str(out / p.name), x, cfg.sr)
        n += 1
    (Path(project_dir) / "conf.json").write_text(
        json.dumps({"sr": cfg.sr, "n_mels": cfg.n_mels, "hop": cfg.model.hop}))
    return n


def _load_segments(project_dir: str, cfg: WTConfig, rng: np.random.Generator,
                   device: torch.device):
    """Infinite generator of (audio (b, seg*hop), mel (b, seg, n_mels)) on
    ``device``; the segments are the JAX package's for the same ``rng``."""
    files = sorted((Path(project_dir) / "prepared").glob("*.wav"))
    if not files:
        raise ValueError(f"no prepared wavs in {project_dir}")
    wavs = [np.asarray(read_audio(str(p)).to_mono().samples[0], np.float32) for p in files]
    seg = cfg.seg_frames * cfg.model.hop
    wavs = [w for w in wavs if len(w) >= seg]
    if not wavs:
        raise ValueError("all clips shorter than one training segment")
    while True:
        batch = []
        for _ in range(cfg.batch_size):
            w = wavs[rng.integers(len(wavs))]
            s = rng.integers(0, len(w) - seg + 1)
            batch.append(w[s: s + seg])
        audio = torch.from_numpy(np.stack(batch)).to(device)
        yield audio, _mel_of(audio, cfg)


def _ema_update(ema: dict, model: nn.Module, decay: float) -> None:
    with torch.no_grad():
        for k, p in model.state_dict().items():
            ema[k].mul_(decay).add_(p, alpha=1.0 - decay)


def train_model(
    project_dir: str,
    cfg: WTConfig | None = None,
    token: CancellationToken | None = None,
    callback=None,
    segment_gen=None,
    device: str | torch.device = "cuda",
    draws: Callable[[int, int, int], tuple[torch.Tensor, torch.Tensor]] | None = None,
    lock=None,
) -> dict:
    """Train loop with Adam, EMA, checkpoints in <project>/ckpt, resume and
    cancellation, on ``device`` (default the card; raises without one).

    ``segment_gen`` overrides the (audio, mel) batch source: the
    super-resolution trainer feeds (fullband audio, band-limited mel) pairs
    through the same loop (train/super_res.py).  Without a checkpoint the
    weights start from flax's initialisers with seed 0 (:func:`lecun_init`).
    ``draws(step, b, n)``
    gives a step's (noise level (b,), eps (b, n)) (default
    ``loss_draws(b, n, seed=step)``).  ``lock``, when given, is held around
    building the state and around each step (a server passes its inference
    lock).  Under a process group of more than one rank the step is
    data-parallel (module docstring); ``draws`` then gives the global
    batch's, and a ``cfg.batch_size`` that the ranks do not divide raises
    ``ValueError``.  Returns the last
    checkpointed loss, the step count and the host seconds of the first
    step run and of the later ones on average."""
    cfg = cfg or WTConfig()
    world = world_size()
    if world > 1 and cfg.batch_size % world:
        raise ValueError(f"{world} ranks need a batch size that divides by them, not "
                         f"{cfg.batch_size}")
    dev = resolve_device(device)
    token = token or CancellationToken()
    lock = lock or contextlib.nullcontext()
    gen = segment_gen or _load_segments(project_dir, cfg, np.random.default_rng(0), dev)
    draws = draws or (lambda step, b, n: loss_draws(b, n, step, dev))

    with lock:
        model = lecun_init(WaveGrad(cfg.model).to(dev), 0)
        # optax.adam(lr): the same update, m_hat / (sqrt(v_hat) + eps)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        mgr = checkpoint_manager(str(Path(project_dir) / "ckpt"))
        start = 0
        last = mgr.latest_step()
        if last is not None:
            state = mgr.restore(last, map_location=dev)
            model.load_state_dict(state["params"])
            opt.load_state_dict(state["opt"])
            ema = state["ema"]
            start = int(state["step"])
            log.info("wavetransfer resumed at step %d", start)

    dp = world > 1
    shard = dist.get_rank() if dp else 0
    writer = shard == 0
    loss = float("nan")
    loss_t = torch.tensor(float("nan"))
    t0 = time.perf_counter()
    t_first = None
    ran = 0
    for i in range(start, cfg.steps):
        if token.cancelled:
            log.info("training cancelled at step %d", i)
            break
        audio, mel = next(gen)
        with lock:
            scale, eps = draws(i, audio.shape[0], audio.shape[-1])
            if dp:
                audio, mel, scale, eps = (rows(x, shard, world) for x in (audio, mel, scale, eps))
            loss_t = diffusion_loss(model, audio, mel, scale, eps)
            opt.zero_grad(set_to_none=True)
            loss_t.backward()
            if dp:
                average_gradients(model.parameters())
                loss_t = loss_t.detach().clone()
                dist.all_reduce(loss_t)
                loss_t /= world
            opt.step()
            _ema_update(ema, model, cfg.ema)
            ran += 1
            if t_first is None:
                loss_t.item()               # waits for the device
                t_first = time.perf_counter()
            if (i + 1) % cfg.ckpt_every == 0 or i + 1 == cfg.steps:
                loss = float(loss_t.detach())
                if writer:
                    mgr.save(i + 1, {"step": i + 1, "params": model.state_dict(),
                                     "opt": opt.state_dict(), "ema": ema})
                    if callback:
                        callback(i + 1, f"step {i + 1}: loss {loss:.4f}", cfg.steps)
                    log.info("step %d loss %.4f (%.1fs)", i + 1, loss,
                             time.perf_counter() - t0)
                if dp:
                    dist.barrier()
    last_loss = float(loss_t.detach())
    t_end = time.perf_counter()
    return {"loss": loss if np.isfinite(loss) else last_loss, "steps": cfg.steps,
            "first_step_s": None if t_first is None else t_first - t0,
            "warm_step_s": (t_end - t_first) / (ran - 1) if ran > 1 else None}


def load_ema(ckpt_dir: str, model_cfg: WaveGradConfig,
             device: str | torch.device = "cuda") -> WaveGrad:
    """A WaveGrad holding the EMA weights of the newest checkpoint in
    ``ckpt_dir`` (the learner's inference convention), in eval mode."""
    dev = resolve_device(device)
    mgr = checkpoint_manager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    model = WaveGrad(model_cfg).to(dev)
    model.load_state_dict(mgr.restore(step, map_location=dev)["ema"])
    return model.eval()


def generate(
    project_dir: str,
    source_wav: np.ndarray,
    source_sr: int,
    cfg: WTConfig | None = None,
    schedule: NoiseSchedule = FAST_6,
    chunk_frames: int = 64,
    seed: int = 0,
    device: str | torch.device = "cuda",
    draws: torch.Tensor | None = None,
) -> tuple[np.ndarray, int]:
    """Timbre transfer: source audio -> mel -> batched chunked sampling ->
    crossfade stitch (bddm/sampler.py:38-628 behaviour, batched), on
    ``device``.  ``draws`` are :func:`sample`'s for the chunk batch."""
    cfg = cfg or WTConfig()
    dev = resolve_device(device)
    model = load_ema(str(Path(project_dir) / "ckpt"), cfg.model, dev)
    x = np.asarray(source_wav, np.float32)
    if source_sr != cfg.sr:
        x = resample_poly_np(x, source_sr, cfg.sr)
    hop = cfg.model.hop
    plan = plan_chunks(len(x), chunk_frames * hop, 4 * hop)
    chunks = extract_chunks(torch.from_numpy(np.ascontiguousarray(x)).to(dev), plan)
    mel = _mel_of(chunks, cfg)                         # (count, frames, n_mels)
    out = sample(model, mel, schedule, seed=seed, draws=draws)
    y = stitch_chunks(out, plan)     # the mel crop makes each output chunk plan.chunk long
    return y[: len(x)].cpu().numpy().astype(np.float32), cfg.sr


# ------------------------------------------------ BDDM schedule network

class BDDMScheduleNet(nn.Module):
    """BDDM's noise-schedule predictor phi (bddm/galr.py:427-444 role):
    beta_hat = min(beta_next bound, delta^2) * sigmoid(ratio(noisy audio)),
    the JAX package's strided-conv stack (names ``Conv_0..2``, ``ratio``)."""

    def __init__(self):
        super().__init__()
        ch = 1
        for i, (out, s) in enumerate(((16, 4), (32, 4), (64, 4))):
            setattr(self, f"Conv_{i}", SameConv1d(ch, out, 8, stride=s))
            ch = out
        self.ratio = nn.Linear(ch, 1)

    def forward(self, audio, bounds):
        """audio (b, t); bounds (b, 2) = [beta_next, delta^2] -> (b, 1)."""
        x = audio[:, None, :]
        for i in range(3):
            x = torch.nn.functional.silu(getattr(self, f"Conv_{i}")(x))
        ratio = torch.sigmoid(self.ratio(x.mean(dim=-1)))
        return bounds.min(dim=1, keepdim=True).values * ratio


def bddm_draws(gen: torch.Generator, batch: int, n: int, steps: int,
               tau: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One BDDM step's (ts (b,), z (b, n)) from ``gen``: the step index pair
    (ts, ts + tau) and the noise."""
    dev = gen.device
    ts = torch.randint(tau, steps - tau, (batch,), generator=gen, device=dev)
    return ts, torch.randn((batch, n), generator=gen, device=dev)


def bddm_step_loss(wavegrad: WaveGrad, sched_net: BDDMScheduleNet, audio, mel,
                   ts, z, schedule: NoiseSchedule = TRAIN_SCHEDULE,
                   tau: int = 250) -> torch.Tensor:
    """BDDM Eq. 14 step loss (bddm/loss.py:37-64): noise the audio at
    alpha_ts, ask phi for beta_hat bounded by [beta_next, delta^2], and score
    it against the FROZEN score network's eps prediction."""
    sac = torch.tensor(schedule.sqrt_alpha_cum, dtype=torch.float32, device=audio.device)
    a_cur = sac[ts][:, None]
    a_nxt = sac[ts + tau][:, None]
    b_nxt = 1.0 - (a_nxt / a_cur) ** 2
    delta2 = 1.0 - a_cur ** 2
    noisy = a_cur * audio + torch.sqrt(delta2) * z
    with torch.no_grad():
        e = wavegrad(noisy, mel, a_cur[:, 0])
    b_hat = sched_net(noisy, torch.cat([b_nxt, delta2], dim=1))
    t_len = audio.shape[-1]
    l = (delta2 / (2.0 * (delta2 - b_hat)) * (z - b_hat / delta2 * e) ** 2
         + torch.log(1e-8 + delta2 / (b_hat + 1e-8)) / 4.0)
    loss = l.sum(-1) + (b_hat[:, 0] / delta2[:, 0] - 1.0) / 2.0 * t_len
    return torch.mean(loss)


def train_schedule_net(wavegrad: WaveGrad, audio, mel, steps: int = 100, lr: float = 1e-4,
                       seed: int = 0, schedule: NoiseSchedule = TRAIN_SCHEDULE,
                       tau: int = 250, sched_net: BDDMScheduleNet | None = None,
                       draws: Callable[[int], tuple[torch.Tensor, torch.Tensor]] | None = None):
    """Optimise phi against a frozen score network (bddm/trainer.py role)
    with Adam.  ``sched_net`` is the start (default flax's initialisers from
    ``seed``), ``draws(step)`` a step's (ts, z) (default :func:`bddm_draws`
    from a generator seeded with ``seed``).  Returns (sched_net, losses)."""
    dev = resolve_device(audio.device)
    if sched_net is None:
        sched_net = lecun_init(BDDMScheduleNet().to(dev), seed)
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = lambda _step: bddm_draws(gen, audio.shape[0], audio.shape[-1],  # noqa: E731
                                         len(schedule.betas), tau)
    opt = torch.optim.Adam(sched_net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step in range(steps):
        ts, z = draws(step)
        loss = bddm_step_loss(wavegrad, sched_net, audio, mel, ts, z, schedule, tau)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return sched_net, [float(v) for v in losses]


@torch.no_grad()
def bddm_noise_scheduling(wavegrad: WaveGrad, sched_net: BDDMScheduleNet, ref_mel,
                          alpha_param: float = 0.95, beta_param: float = 0.02,
                          max_steps: int = 20, min_beta: float = 1e-6, seed: int = 0,
                          schedule: NoiseSchedule = TRAIN_SCHEDULE,
                          draws: torch.Tensor | None = None) -> NoiseSchedule:
    """BDDM reverse schedule search (bddm/sampler.py:238-300): run the
    reverse process from (alpha_param, beta_param), letting phi emit each
    next beta, and collect the short schedule.  ``draws`` (max_steps, b, t)
    are the starting noise and then each step's noise (default from a
    generator seeded with ``seed``).  Each step reads phi's beta on the host,
    as the JAX search does."""
    dev = resolve_device(ref_mel.device)
    b, t_len = ref_mel.shape[0], ref_mel.shape[1] * wavegrad.cfg.hop
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = torch.randn((max_steps, b, t_len), generator=gen, device=dev)
    x = draws[0]
    k = 1
    a_cur, b_cur = float(alpha_param), float(beta_param)
    min_sac = float(np.min(schedule.sqrt_alpha_cum))
    betas = []
    for n in range(max_steps - 1, -1, -1):
        if a_cur < min_sac:  # past the densest trained noise level
            break
        betas.append(b_cur)
        e = wavegrad(x, ref_mel, torch.full((b,), a_cur, device=dev))
        x = (x - b_cur / math.sqrt(1.0 - a_cur ** 2) * e) / math.sqrt(1.0 - b_cur)
        if n > 0:
            a_nxt_val = a_cur / math.sqrt(1.0 - b_cur)
            x = x + math.sqrt((1.0 - min(a_nxt_val, 1.0 - 1e-6) ** 2)
                              / (1.0 - a_cur ** 2) * b_cur) * draws[k]
            k += 1
        a_cur = a_cur / math.sqrt(1.0 - b_cur)
        if a_cur > 1.0:
            break
        bounds = torch.tensor([[b_cur, 1.0 - a_cur ** 2]], device=dev).expand(b, 2)
        b_cur = float(sched_net(x, bounds).mean())
        if b_cur < min_beta:
            break
    return NoiseSchedule(np.asarray(betas[::-1], np.float64))
