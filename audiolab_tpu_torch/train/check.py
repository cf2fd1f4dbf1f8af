"""Train steps on devices against the same step as a reference runs it (in
fp64, or in fp32 on the CPU): the same weights, batch and draws, the six
metrics and every gradient compared.

The reference step records the values where fp32 evaluation is
ill-conditioned and the step under test replays them
(``models.layers.Pins``): which side of its kink every leaky ReLU input
took, the NSF excitation's phase, and the direction X / |X| of each STFT
bin in the mel loss (whose gradient goes through the magnitude; at a bin
near 0 the direction is the rounding's).  Without that the comparison is
ill-posed.  One leaky ReLU input within rounding of 0 takes the other
slope and moves a weight gradient summed over a few thousand positions by
a percent of its max|g|: the v2-48k step on the H100 read 1.8e-02 from an
fp64 step, on the card and on the CPU alike, and 8.9e-05 with the sides
pinned.  The phase is one fp32 cumsum over every sample, rounded in the
order the device sums in, and the noise convolutions' gradients follow
it.  The report counts the flipped sides and holds the phase difference
to twice the bound of a recursive fp32 sum of non-negative terms,
(n - 1) 2^-24 max|phase| for n samples.

Each fp32 step is held to an fp64 reference rather than to another fp32
step: two fp32 steps each sit up to about 1e-4 of a tensor's max|g| from
exact, so they differ by up to twice that (the tiny step's noise
convolutions, card against CPU with the pins replayed: 1.17e-04).  Where
the CPU's fp32 step is among those checked, it sets the conditioning: a
tensor whose gradient the CPU's fp32 step itself puts near the gate is a
sum that cancels, and another device may sit up to twice the CPU's
distance from exact there (the tiny step's ``dec.noise_convs.2.weight``:
the CPU 9.2e-05 of its max|g|, the card 1.16e-04).

The gate (:data:`GATE`) holds each metric relative to the reference and
each gradient tensor to the reference's largest |g| of that tensor (or to
twice the CPU's distance, above), with one stated rule: a bias (``.bias``, or a layer norm's ``.beta``) is held to
the larger of its own largest |g| and that of its layer's weight
(``.weight``, ``.gamma``).  A bias gradient is a single sum of the layer's
output gradient over every batch position and time step, with no input
factor, so it cancels where the weight's does not, and its rounding error
scales with its layer rather than with itself (the JAX step's own parity
test holds ``conv_k.bias`` to ``conv_k.weight`` for the same reason).  The
report carries that reading and two others: every tensor against its own
largest |g|, no rule, and against the largest |g| of its block (a
discriminator, or a top-level part of the synthesizer).
"""

from __future__ import annotations

import copy

import torch

from audiolab_tpu_torch.models.layers import Pins, pinned
from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig, TrainDraws
from audiolab_tpu_torch.train.rvc import (
    RVCTrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)

GATE = 1e-4
_LAYER_SCALE = {".bias": ".weight", ".beta": ".gamma"}


def grad_block(name: str) -> str:
    """The block a parameter belongs to: a discriminator, or a top-level part
    of the synthesizer (enc_p, enc_q, flow, dec, emb_g)."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "discriminators" else parts[0]


def gated_scale(name: str, peak: dict[str, float]) -> float:
    """The largest |g| that tensor ``name``'s gradient error is held to,
    ``peak`` mapping each parameter to its own largest |g|."""
    for suffix, layer in _LAYER_SCALE.items():
        if name.endswith(suffix):
            return max(peak[name], peak.get(name[: -len(suffix)] + layer, 0.0))
    return peak[name]


def _ratio(err: float, scale: float) -> float:
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def _worst(errs: dict[str, float]) -> tuple[float, str]:
    name = max(errs, key=errs.get)
    return errs[name], name


def step_against(cfg: SynthesizerConfig, batch: dict, draws: TrainDraws, devices,
                 periods=None, seed: int = 0, reference: str | torch.device = "cpu",
                 reference_dtype: torch.dtype = torch.float64) -> dict[str, dict]:
    """One fp32 step of ``make_train_step(cfg)`` on each of ``devices``
    against the reference step on ``reference`` in ``reference_dtype``, all
    from the weights ``create_train_state(cfg, seed, periods=periods)``
    draws, with ``batch`` and ``draws`` given on the CPU, the reference's
    pins replayed.  Returns a report per device (keyed by ``str(device)``):
    the largest relative metric difference (``metric_err``), the three
    gradient readings of the module docstring (``grad_err`` the gated one,
    ``grad_own_err``, ``grad_block_err``), each with the metric or tensor
    where it is largest (``*_at``), the leaky ReLU inputs on the other side
    (``flips``), the phase difference and its bound in cycles
    (``phase_err``, ``phase_bound``), the largest ratio of a gradient error
    to what it is allowed (``grad_allowed_err``) and ``ok``: every metric
    within :data:`GATE`, every gradient within what it is allowed (that
    ratio at most 1), the phase within its bound."""
    _, gen, disc = create_train_state(cfg, seed=seed, periods=periods, device="cpu")
    step = make_train_step(cfg)
    pins = Pins()

    def run(dev, dtype, replay):
        g, d = copy.deepcopy(gen).to(dev, dtype), copy.deepcopy(disc).to(dev, dtype)
        state = RVCTrainState(step=0, gen=g, disc=d, g_opt=make_optimizer(g.parameters()),
                              d_opt=make_optimizer(d.parameters()))
        moved = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                 for k, v in batch.items()}
        dr = TrainDraws(draws.posterior.to(dev, dtype), draws.starts.to(dev),
                        draws.sine.to(dev, dtype))
        with pinned(pins, replay=replay):
            _, metrics = step(state, moved, seed, draws=dr)
        grads = {k: p.grad.detach().cpu().double() for m in (g, d)
                 for k, p in m.named_parameters()}
        return {k: float(v) for k, v in metrics.items()}, grads

    want, ref = run(torch.device(reference), reference_dtype, False)
    peak = {k: float(g.abs().max()) for k, g in ref.items()}
    block: dict[str, float] = {}
    for k, v in peak.items():
        block[grad_block(k)] = max(block.get(grad_block(k), 0.0), v)
    bound = 2 * (pins.phase_n - 1) * 2.0 ** -24 * pins.phase_max
    runs = {}
    for device in devices:
        got, grads = run(torch.device(device), torch.float32, True)
        runs[str(device)] = (got, {k: float((grads[k] - g).abs().max()) for k, g in ref.items()},
                             pins.flips, pins.phase_err)
    cpu = runs.get("cpu")
    out = {}
    for name, (got, err, flips, phase_err) in runs.items():
        allowed = {k: GATE * gated_scale(k, peak) for k in err}
        if cpu is not None and name != "cpu":
            allowed = {k: max(a, 2 * cpu[1][k]) for k, a in allowed.items()}
        readings = {
            "metric": {k: abs(got[k] - v) / abs(v) for k, v in want.items()},
            "grad": {k: _ratio(e, gated_scale(k, peak)) for k, e in err.items()},
            "grad_own": {k: _ratio(e, peak[k]) for k, e in err.items()},
            "grad_block": {k: _ratio(e, block[grad_block(k)]) for k, e in err.items()},
            "grad_allowed": {k: _ratio(e, allowed[k]) for k, e in err.items()},
        }
        rec = {"flips": flips, "phase_err": phase_err, "phase_bound": bound}
        for key, errs in readings.items():
            rec[f"{key}_err"], rec[f"{key}_at"] = _worst(errs)
        rec["ok"] = (rec["metric_err"] <= GATE and rec["grad_allowed_err"] <= 1.0
                     and phase_err <= bound)
        out[name] = rec
    return out
