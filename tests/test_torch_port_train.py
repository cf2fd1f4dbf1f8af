"""The port's RVC training step against the JAX package's, on the CPU, fp32,
at tests/test_train.py's tiny configuration with discriminator periods
(2, 3) and seeded weights (tests/torch_port_tiny.py ``train_pair``; no flax
``init``).  The JAX step is compiled once per module.  Its three draws are
computed with ``jax.random`` from ``fold_in(rng, step)`` as the step takes
them and handed to the port as a ``TrainDraws``.

Tolerances (fp32, sums in another order): forward values and discriminator
outputs 1e-5 of max|y|; losses and the six metrics 1e-4 relative; each
gradient tensor 1e-4 of its max|g|; the optimizer 1e-6 of optax; the save /
restore round trip bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolab_tpu.models.rvc import discriminator as JD
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.train import losses as JL
from audiolab_tpu.train import rvc as JR
from audiolab_tpu_torch.kernels import attention as TA
from audiolab_tpu_torch.kernels import norms as TN
from audiolab_tpu_torch.models.layers import Pins, pinned
from audiolab_tpu_torch.models.rvc.synthesizer import TrainDraws
from audiolab_tpu_torch.train import checkpoint as TC
from audiolab_tpu_torch.train import losses as TL
from audiolab_tpu_torch.train import rvc as TR
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401
from tests.test_train import make_batch, tiny_cfg

PERIODS = (2, 3)
B, T = 2, 16
METRICS = ("loss_disc", "loss_gen_total", "loss_gen", "loss_fm", "loss_mel", "loss_kl")


def _torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("phone_lengths", "pitch", "spec_lengths", "sid"):
        out[k] = out[k].long()
    return out


def _draws(cfg, keys):
    """The posterior noise, segment starts and excitation noise that the JAX
    training forward draws from its (posterior, slice, noise) keys."""
    r_post, r_slice, r_noise = keys
    return TrainDraws(
        torch.from_numpy(np.array(jax.random.normal(r_post, (B, T, cfg.inter_channels)))),
        torch.from_numpy(np.array(jax.random.randint(r_slice, (B,), 0, 2 ** 30))).long(),
        torch.from_numpy(np.array(jax.random.normal(r_noise, (B, cfg.segment_size, 1)))))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    gp, dp, tg, td = tiny.train_pair(PERIODS)
    batch = make_batch(cfg, b=B, t=T)
    return cfg, gp, dp, tg, td, batch


@pytest.fixture(scope="module")
def stepped(setup):
    """One JAX ``make_train_step`` call and one port step on the same
    weights, batch and draws, the port's step replaying the kink sides,
    excitation phase and STFT directions of the same step in fp64.  The gradients JAX's step took are read from
    its first Adam moment: after one update mu = (1 - 0.8) g."""
    cfg, gp, dp, tg, td, batch = setup
    gen, disc = JSy.SynthesizerTrn(cfg), JD.MultiPeriodDiscriminatorV2(PERIODS)
    g_tx, d_tx = JR.make_optimizer(), JR.make_optimizer()
    state = JR.RVCTrainState(step=jnp.zeros((), jnp.int32),
                             g_params=jax.tree_util.tree_map(jnp.asarray, gp),
                             d_params=jax.tree_util.tree_map(jnp.asarray, dp),
                             g_opt=g_tx.init(gp), d_opt=d_tx.init(dp))
    rng = jax.random.PRNGKey(1)
    new, jm = JR.make_train_step(cfg, gen, disc)(state, batch, rng)
    grads = [jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.8), opt[0].mu)
             for opt in (new.g_opt, new.d_opt)]
    keys = jax.random.split(jax.random.fold_in(rng, 0), 3)   # the step's draws at step 0
    pins = Pins()

    def port_step(dtype, replay):
        tg2, td2 = (copy.deepcopy(m).train().to(dtype) for m in (tg, td))
        ts = TR.RVCTrainState(0, tg2, td2, TR.make_optimizer(tg2.parameters()),
                              TR.make_optimizer(td2.parameters()))
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in _torch_batch(batch).items()}
        d = _draws(cfg, keys)
        d = TrainDraws(d.posterior.to(dtype), d.starts, d.sine.to(dtype))
        with pinned(pins, replay=replay):
            ts, tm = TR.make_train_step(cfg)(ts, b, 1, draws=d)
        return tg2, td2, ts, tm

    # the port's fp32 step replays its fp64 step's pins (models/layers.py
    # Pins): unpinned, one leaky ReLU input of the generator within rounding
    # of 0 takes the other side on one CPU thread and moves dec.conv_pre's
    # gradient by 1.6e-3 of its max|g|
    port_step(torch.float64, False)
    tg2, td2, ts, tm = port_step(torch.float32, True)
    return ({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
            grads, (tg2, td2), ts)


@pytest.mark.parametrize("metric", METRICS)
def test_train_step_metrics_match_jax(stepped, metric):
    jm, tm = stepped[0], stepped[1]
    assert np.isfinite(tm[metric])
    assert tm[metric] == pytest.approx(jm[metric], rel=1e-4)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_gradients_match_jax(stepped, net):
    """Every parameter's gradient, per tensor, to 1e-4 of its max|g|.  The
    key projection's bias has a gradient of exactly 0 (it adds one constant
    to all logits of a query, which the softmax ignores): both packages give
    rounding noise there, held to 1e-4 of its layer's key weight's max|g|."""
    grads, modules = stepped[2], stepped[3]
    i = 0 if net == "generator" else 1
    ref = (W.synthesizer_from_jax if i == 0 else W.discriminator_from_jax)(grads[i])
    got = dict(modules[i].named_parameters())
    assert set(ref) == set(got)
    for k, g in ref.items():
        port = got[k].grad
        assert port is not None, k
        g = g.numpy()
        scale = ref[k.replace(".bias", ".weight")] if k.endswith("conv_k.bias") else g
        tol = 1e-4 * np.abs(np.asarray(scale)).max()
        np.testing.assert_allclose(port.numpy(), g, atol=tol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def forward(setup):
    """The training forward of both packages on the same inputs and draws
    (JAX jitted once)."""
    cfg, gp, dp, tg, td, batch = setup
    rng = jax.random.PRNGKey(3)
    r_post, r_slice, r_noise = jax.random.split(rng, 3)
    args = [batch[k] for k in ("phone", "phone_lengths", "pitch", "pitchf", "spec",
                               "spec_lengths", "sid")]
    # shorter second example: its mask and its own segment start
    args[1] = args[5] = jnp.asarray([T, T - 3], jnp.int32)
    gen = JSy.SynthesizerTrn(cfg)
    ref = jax.jit(lambda p, a: gen.apply({"params": p}, *a, {
        "posterior": r_post, "slice": r_slice, "noise": r_noise}))(gp, args)
    draws = _draws(cfg, (r_post, r_slice, r_noise))
    ta = [torch.from_numpy(np.array(a)) for a in args]
    for i in (1, 2, 5, 6):
        ta[i] = ta[i].long()
    with torch.no_grad():
        out = tg(*ta, draws=draws)
    flat = lambda o: [o[0], o[1], o[2], o[3], *o[4]]   # noqa: E731
    return dict(zip(("o", "ids", "x_mask", "y_mask", "z", "z_p", "m_p", "logs_p", "m_q",
                     "logs_q"), zip(flat(ref), flat(out))))


@pytest.mark.parametrize("name", ["o", "ids", "x_mask", "y_mask", "z", "z_p", "m_p",
                                  "logs_p", "m_q", "logs_q"])
def test_training_forward_matches_jax(forward, name):
    ref, out = forward[name]
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0), rtol=0)


@pytest.fixture(scope="module")
def discriminated(setup):
    cfg, gp, dp, tg, td, batch = setup
    rng = np.random.default_rng(9)
    y = (0.3 * rng.standard_normal((B, cfg.segment_size + 1))).astype(np.float32)
    y_hat = np.tanh(rng.standard_normal((B, cfg.segment_size + 1))).astype(np.float32)
    disc = JD.MultiPeriodDiscriminatorV2(PERIODS)
    ref = jax.jit(lambda p, a, b: disc.apply({"params": p}, a, b))(dp, y[..., None],
                                                                    y_hat[..., None])
    with torch.no_grad():
        out = td(torch.from_numpy(y), torch.from_numpy(y_hat))
    return ref, out


@pytest.mark.parametrize("which", ["scale", "period_2", "period_3"])
def test_discriminator_matches_jax(discriminated, which):
    """Scores and every feature map (flax NTC / NHWC against the port's NCT /
    NCHW), real and fake, on an odd length (the period pads reflect)."""
    ref, out = discriminated
    i = ("scale", "period_2", "period_3").index(which)
    for side in (0, 1):
        pairs = [(ref[side][i], out[side][i])] + [
            (np.moveaxis(np.asarray(r), -1, 1), o)
            for r, o in zip(ref[side + 2][i], out[side + 2][i])]
        for r, o in pairs:
            r = np.asarray(r)
            assert o.shape == r.shape
            np.testing.assert_allclose(o.numpy(), r, atol=1e-5 * np.abs(r).max(), rtol=0)


def _loss_inputs(rng):
    outs = [rng.standard_normal((B, n)).astype(np.float32) for n in (7, 11)]
    fmaps = [[rng.standard_normal((B, 3, n)).astype(np.float32) for n in (5, 9)]
             for _ in range(2)]
    lat = [rng.standard_normal((B, T, 4)).astype(np.float32) for _ in range(4)]
    mask = (np.arange(T)[None, :, None] < np.array([T, T - 5])[:, None, None]).astype(np.float32)
    return outs, fmaps, lat, mask


@pytest.mark.parametrize("loss", ["discriminator", "generator_adv", "feature_matching",
                                  "kl", "mel_l1"])
def test_losses_match_jax(loss):
    rng = np.random.default_rng(12)
    outs, fmaps, lat, mask = _loss_inputs(rng)
    outs2, fmaps2, _, _ = _loss_inputs(rng)
    t = lambda x: [t(v) for v in x] if isinstance(x, list) else torch.from_numpy(x)  # noqa: E731
    j = lambda x: [j(v) for v in x] if isinstance(x, list) else jnp.asarray(x)      # noqa: E731
    args = {"discriminator": (outs, outs2), "generator_adv": (outs,),
            "feature_matching": (fmaps, fmaps2), "kl": (*lat, mask),
            "mel_l1": (lat[0], lat[1], 45.0)}[loss]
    name = loss + "_loss"
    ref = float(getattr(JL, name)(*[j(a) if not isinstance(a, float) else a for a in args]))
    got = float(getattr(TL, name)(*[t(a) if not isinstance(a, float) else a for a in args]))
    assert got == pytest.approx(ref, rel=1e-4)


@pytest.mark.parametrize("lr,decay,steps_per_epoch", [(1e-4, 0.999875, 3), (1e-2, 0.5, 3)])
def test_optimizer_matches_optax(lr, decay, steps_per_epoch):
    """Ten updates (more than three epochs of three) on identical gradients:
    the parameters stay within 1e-6 of optax.adamw + exponential_decay."""
    rng = np.random.default_rng(13)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(10)]
    tx = optax.adamw(optax.exponential_decay(lr, transition_steps=steps_per_epoch,
                                             decay_rate=decay),
                     b1=0.8, b2=0.99, eps=1e-9, weight_decay=0.0)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = TR.make_optimizer(tp, lr=lr, lr_decay=decay, steps_per_epoch=steps_per_epoch)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for p, r in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), atol=1e-6, rtol=0)
    assert opt.updates() == 10


def test_save_restore_resumes_bit_exactly(setup, tmp_path, monkeypatch):
    """Two straight steps equal one step, a save, a restore into a fresh
    state and one more step, bit for bit (weights, optimizer moments,
    metrics); the steps draw their own noise from (seed, step).  The step
    needs gradients everywhere, so it reaches no kernel wrapper (whose plain
    versions would run here)."""
    cfg, *_, batch = setup

    def refuse(*_a, **_k):
        raise AssertionError("a kernel wrapper was called in the train step")

    for mod in (TA, TN):
        for name in dir(mod):
            if name.endswith("_reference"):
                monkeypatch.setattr(mod, name, refuse)
    tb = _torch_batch(batch)
    step = TR.make_train_step(cfg)

    def fresh():
        return TR.create_train_state(cfg, seed=5, lr=1e-3, steps_per_epoch=1,
                                     periods=PERIODS, device="cpu")[0]

    a = fresh()
    a, m1 = step(a, tb, 11)
    a, ma = step(a, tb, 11)
    assert a.step == 2 and a.g_opt.updates() == a.d_opt.updates() == 2
    assert set(ma) == set(METRICS) and m1 != ma
    assert all(np.isfinite(float(v)) for v in (*m1.values(), *ma.values()))
    b = fresh()
    b, _ = step(b, tb, 11)
    mgr = TC.checkpoint_manager(str(tmp_path / "ckpt"), max_to_keep=1)
    TC.save_train_state(mgr, b.step, b)
    c = TC.restore_train_state(mgr, fresh())
    assert c.step == 1 and mgr.all_steps() == [1]
    c, mc = step(c, tb, 11)
    for k in ma:
        assert torch.equal(ma[k], mc[k]), k
    for x, y in ((a.gen, c.gen), (a.disc, c.disc)):
        for (k, p), q in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(p, q), k
    for x, y in ((a.g_opt, c.g_opt), (a.d_opt, c.d_opt)):
        for sa, sc in zip(x.state.values(), y.state.values()):
            assert all(torch.equal(sa[k], sc[k]) for k in ("exp_avg", "exp_avg_sq", "step"))


def test_synthesizer_tree_round_trip(setup):
    """``synthesizer_to_jax`` inverts ``synthesizer_from_jax`` exactly, both
    ways, with and without the posterior encoder."""
    _, gp, _, tg, _, _ = setup
    sd = W.synthesizer_from_jax(gp)
    back = W.synthesizer_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(gp)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(gp)):
        np.testing.assert_array_equal(x, y)
    infer_sd = {k: v for k, v in sd.items() if not k.startswith("enc_q.")}
    assert "enc_q" not in W.synthesizer_to_jax(infer_sd)
    for k, v in W.synthesizer_from_jax(W.synthesizer_to_jax(tg.state_dict())).items():
        assert torch.equal(v, tg.state_dict()[k]), k


def test_card_check_rule_and_a_cpu_run(setup):
    """audiolab_tpu_torch/train/check.py: a bias (or a layer norm's beta) is
    held to the larger of its own max|g| and its layer weight's, any other
    tensor to its own; with the CPU as the device and as the fp32 reference
    the two steps agree exactly, no leaky ReLU flips, the phases agree and
    the gate passes;
    against an fp64 reference the fp32 step passes the gate too."""
    from dataclasses import asdict

    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig
    from audiolab_tpu_torch.train import check

    peak = {"a.weight": 2.0, "a.bias": 0.5, "b.weight": 1.0, "b.bias": 3.0,
            "n.gamma": 4.0, "n.beta": 1.0, "emb_rel_k": 0.25}
    assert [check.gated_scale(k, peak) for k in peak] == [2.0, 2.0, 1.0, 3.0, 4.0, 4.0, 0.25]
    assert check.grad_block("discriminators.1.convs.0.weight") == "discriminators.1"
    assert check.grad_block("dec.ups.0.bias") == "dec"
    cfg = SynthesizerConfig(**asdict(setup[0]))
    draws = TrainDraws.sample(cfg, B, T, torch.Generator().manual_seed(3))
    batch = _torch_batch(setup[5])
    rec = check.step_against(cfg, batch, draws, ["cpu"], periods=PERIODS,
                             reference_dtype=torch.float32)["cpu"]
    assert rec["ok"] and rec["metric_err"] == 0.0 and rec["flips"] == 0, rec
    assert rec["phase_err"] == 0.0 < rec["phase_bound"], rec
    assert rec["grad_err"] == rec["grad_own_err"] == rec["grad_block_err"] == 0.0, rec
    rec = check.step_against(cfg, batch, draws, ["cpu"], periods=PERIODS)["cpu"]
    assert rec["ok"], rec


def test_pins_replay_the_recorded_values():
    """models/layers.py: a replayed leaky ReLU takes the recorded side of its
    kink and counts the inputs that fell on the other one; a replayed phase
    is the recorded one, its largest difference kept; a replay that does
    not use every recorded value raises."""
    from audiolab_tpu_torch.models.layers import Pins, lrelu, pin, pinned

    x = torch.tensor([-1.0, -1e-9, 0.0, 2.0])
    pins = Pins()
    with pinned(pins):
        assert torch.equal(lrelu(x), torch.tensor([-0.1, -1e-10, 0.0, 2.0]))
        pin("phase", torch.tensor([[0.5, 1.0, 1.5]], dtype=torch.float64))
    assert (pins.phase_n, pins.phase_max) == (3, 1.5)
    with pinned(pins, replay=True):
        y = lrelu(torch.tensor([-1.0, 1e-9, -1e-9, 2.0]))
        phase = pin("phase", torch.tensor([[0.5, 1.0, 1.25]]))
    assert torch.equal(y, torch.tensor([-0.1, 1e-10, -1e-9, 2.0])) and pins.flips == 2
    assert torch.equal(phase, torch.tensor([[0.5, 1.0, 1.5]])) and pins.phase_err == 0.25
    with pytest.raises(RuntimeError, match="replayed"):
        with pinned(pins, replay=True):
            pass
