"""RVC GAN training step on one card (counterpart of audiolab_tpu/train/rvc.py;
reference behavior: modules/rvc/infer/modules/train/train.py:254-788 —
AdamW(G) / AdamW(D) with the per-epoch lr decay 0.999875, losses = LS-GAN
adversarial + 2 x feature matching + 45 x mel-L1 + KL).

The step computes what the JAX step computes, in its order: G's loss and
gradients against the discriminator *before* this step's update (the
discriminator frozen), then D's loss and gradients on the detached fake,
then both updates.  It runs fp32 with TF32 off (core/precision.py), no AMP
and no loss scaling, and launches no hand-written kernel: every op needs a
gradient, and the kernels are forward-only.

Under a ``dp`` mesh over ranks (``make_train_step(..., mesh=)``) each rank
runs its equal shard of the global batch and the step equals the global
one: the draws are the global batch's, each rank taking its rows; every
gradient is averaged over the ranks (one ``all_reduce`` a network) before
each optimizer's update, which is exact where DDP's hooks would expect one
forward for each backward and this step runs D twice; the KL term, a ratio
of two sums, reduces its numerator and its mask sum over the ranks.  Every
rank reports the global batch's metrics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.distributed import average_gradients, rows
from audiolab_tpu_torch.kernels.mel import log_mel, mel_filterbank, mel_spectrogram
from audiolab_tpu_torch.kernels.stft import stft
from audiolab_tpu_torch.models.layers import pin, pinning
from audiolab_tpu_torch.models.rvc.discriminator import MultiPeriodDiscriminatorV2
from audiolab_tpu_torch.models.rvc.synthesizer import (
    SynthesizerConfig,
    SynthesizerTrn,
    TrainDraws,
    slice_segments,
)
from audiolab_tpu_torch.train.losses import (
    discriminator_loss,
    feature_matching_loss,
    generator_adv_loss,
    kl_terms,
    mel_l1_loss,
)

# mel front-end parameters per sample rate (modules/rvc/configs/v2/*.json)
MEL_CFG = {
    32000: dict(n_fft=1024, hop=320, win_length=1024, n_mels=80),
    40000: dict(n_fft=2048, hop=400, win_length=2048, n_mels=125),
    48000: dict(n_fft=2048, hop=480, win_length=2048, n_mels=128),
}


def _mel(wav: torch.Tensor, sr: int) -> torch.Tensor:
    """The loss's log mel of ``wav`` (``mel_spectrogram`` with power 1).
    Inside :func:`pinned` its magnitude sqrt(re^2 + im^2 + eps) is written
    as its value plus a term of value 0 whose gradient is the magnitude's
    own, (re, im) / |X|, taken through :func:`pin` ("phasor"), so that a step
    held against a reference replays the reference's directions
    (``models.layers.Pins``); the value and the gradient are the same."""
    m = MEL_CFG[sr]
    if not pinning():
        return log_mel(mel_spectrogram(
            wav, sr=sr, n_fft=m["n_fft"], hop=m["hop"], win_length=m["win_length"],
            n_mels=m["n_mels"], fmin=0.0, fmax=None, norm="slaney", htk=False, power=1.0,
            center=False))
    re, im = stft(wav, m["n_fft"], m["hop"], m["win_length"], "hann", False)
    mag = torch.sqrt(re * re + im * im + 1e-9)
    u = pin("phasor", torch.stack([re, im]).detach() / mag.detach())
    mag = mag.detach() + (re - re.detach()) * u[0] + (im - im.detach()) * u[1]
    fb = mel_filterbank(sr, m["n_fft"], m["n_mels"], 0.0, None, False, "slaney")
    return log_mel(mag @ torch.from_numpy(fb).to(mag.device, mag.dtype))


class DecayedAdamW(torch.optim.AdamW):
    """AdamW whose learning rate follows its own update count n:
    ``lr * lr_decay ** (n / steps_per_epoch)`` for the update after n
    others, optax's non-staircase ``exponential_decay``.  The count lives in
    the optimizer's state, so a restored optimizer needs no scheduler."""

    def __init__(self, params, lr: float, betas, eps: float, lr_decay: float,
                 steps_per_epoch: int):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=0.0)
        self.base_lr, self.lr_decay, self.steps_per_epoch = lr, lr_decay, steps_per_epoch

    def updates(self) -> int:
        """Updates taken so far (the per-parameter ``step`` state)."""
        for st in self.state.values():
            return int(st["step"])
        return 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.base_lr * self.lr_decay ** (self.updates() / self.steps_per_epoch)
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def make_optimizer(params, lr: float = 1e-4, betas=(0.8, 0.99), eps: float = 1e-9,
                   lr_decay: float = 0.999875, steps_per_epoch: int = 200) -> DecayedAdamW:
    """AdamW with the reference's per-epoch exponential decay
    (train.py:356-363,434-439), applied per update at the epoch-equivalent
    rate; weight decay 0."""
    return DecayedAdamW(params, lr, betas, eps, lr_decay, steps_per_epoch)


@dataclass
class RVCTrainState:
    step: int
    gen: SynthesizerTrn
    disc: MultiPeriodDiscriminatorV2
    g_opt: DecayedAdamW
    d_opt: DecayedAdamW


def create_train_state(cfg: SynthesizerConfig, seed: int = 0, lr: float = 1e-4,
                       steps_per_epoch: int = 200, periods=None,
                       device: str | torch.device = "cuda"
                       ) -> tuple[RVCTrainState, SynthesizerTrn, MultiPeriodDiscriminatorV2]:
    """G (with its posterior encoder) and D with torch's default initialisers
    drawn from ``seed`` on the CPU (the same weights on any device), moved to
    ``device`` (default the card; raises without one), and their
    optimizers."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = SynthesizerTrn(cfg, posterior=True)
        disc = MultiPeriodDiscriminatorV2(periods) if periods else MultiPeriodDiscriminatorV2()
    gen, disc = gen.to(dev).train(), disc.to(dev).train()
    state = RVCTrainState(
        step=0, gen=gen, disc=disc,
        g_opt=make_optimizer(gen.parameters(), lr, steps_per_epoch=steps_per_epoch),
        d_opt=make_optimizer(disc.parameters(), lr, steps_per_epoch=steps_per_epoch))
    return state, gen, disc


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The draws' generator of update ``step`` under ``seed`` (the
    counterpart of ``fold_in(rng, step)``): a resumed run draws what an
    unbroken one draws."""
    word = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(word)


def make_train_step(cfg: SynthesizerConfig, c_mel: float = 45.0, c_kl: float = 1.0,
                    mesh=None):
    """The train step.  batch keys (tensors on the state's device): phone
    (b, t, feat), phone_lengths (b,), pitch (b, t) int, pitchf (b, t),
    spec (b, t, spec_channels), spec_lengths (b,), wave (b, t * upp), sid
    (b,).  ``step(state, batch, seed, draws=None) -> (state, metrics)``: the
    draws come from :func:`step_generator` unless given; the learning rates
    from the state's optimizers.  Metrics are 0-d tensors on the device.

    ``mesh``: a ``core.mesh.Mesh`` over ranks whose ``dp`` axis has more
    than one slot makes the step data-parallel: ``batch`` is this rank's
    shard (every rank's of the same size), ``draws`` (when given) the
    global batch's, and the state equal on every rank before the step
    stays so after it."""
    sr = cfg.sr
    dp = 1 if mesh is None else mesh.shape["dp"]
    if dp > 1 and not mesh.distributed:
        raise ValueError("the data-parallel step needs a mesh over the ranks of a process group")
    group = mesh.group("dp") if dp > 1 else None
    shard = mesh.coordinate("dp") if dp > 1 else 0

    def step(state: RVCTrainState, batch: dict, seed: int, draws: TrainDraws | None = None):
        gen, disc = state.gen, state.disc
        b, t = batch["spec"].shape[:2]
        if draws is None:
            draws = TrainDraws.sample(cfg, b * dp, t, step_generator(
                seed, state.step, batch["spec"].device))
        if dp > 1:
            if draws.starts.shape[0] != b * dp:
                raise ValueError(f"draws for {draws.starts.shape[0]} rows, the global batch "
                                 f"has {b * dp}")
            draws = TrainDraws(*(rows(x, shard, dp) for x in (draws.posterior, draws.starts,
                                                                  draws.sine)))
        state.g_opt.zero_grad(set_to_none=True)
        state.d_opt.zero_grad(set_to_none=True)

        # G's loss against the discriminator before this step's update
        o, ids, _, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q) = gen(
            batch["phone"], batch["phone_lengths"], batch["pitch"], batch["pitchf"],
            batch["spec"], batch["spec_lengths"], batch["sid"], draws=draws)
        y_hat = o[..., 0]
        wave_slice = slice_segments(batch["wave"][..., None], ids * cfg.upp,
                                    cfg.segment_size)[..., 0]
        mel_real, mel_fake = _mel(wave_slice, sr), _mel(y_hat.float(), sr)
        disc.requires_grad_(False)
        try:
            _, f_outs, r_fmaps, f_fmaps = disc(wave_slice, y_hat)
        finally:
            disc.requires_grad_(True)
        l_adv = generator_adv_loss(f_outs)
        l_fm = feature_matching_loss(r_fmaps, f_fmaps)
        l_mel = mel_l1_loss(mel_real, mel_fake, c_mel)
        kl_num, kl_den = kl_terms(z_p, logs_q, m_p, logs_p, y_mask)
        if dp > 1:
            # the global mask sum; dp x this rank's sum over it, averaged
            # with the other ranks' gradients, is the global ratio's
            kl_den = kl_den.detach().clone()
            dist.all_reduce(kl_den, group=group)
            l_kl = c_kl * (dp * kl_num / kl_den)
        else:
            l_kl = c_kl * (kl_num / kl_den)
        g_total = l_adv + l_fm + l_mel + l_kl
        g_total.backward()

        # D's loss on the detached fake (train.py:588-600)
        r_outs, f_outs, _, _ = disc(wave_slice, y_hat.detach())
        d_total = discriminator_loss(r_outs, f_outs)
        d_total.backward()

        if dp > 1:
            average_gradients(disc.parameters(), group)
            average_gradients(gen.parameters(), group)
            means = torch.stack([d_total, l_adv, l_fm, l_mel, c_kl * kl_num]).detach()
            dist.all_reduce(means, group=group)
            d_total, l_adv, l_fm, l_mel = means[:4] / dp
            l_kl = means[4] / kl_den
            g_total = l_adv + l_fm + l_mel + l_kl
        state.d_opt.step()
        state.g_opt.step()
        state.step += 1
        metrics = dict(loss_disc=d_total, loss_gen_total=g_total, loss_gen=l_adv,
                       loss_fm=l_fm, loss_mel=l_mel, loss_kl=l_kl)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
