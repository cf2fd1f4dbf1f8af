"""The port's WaveGrad, WaveTransfer training and inference, BDDM and the
WaveTransfer routes against the JAX package's, on the CPU, at a narrow width
(``tests/torch_port_tiny.py::WAVEGRAD``: 16 mels, hop 60, DBlock strides 2,
2, 3, UBlock factors 5, 3, 2, 2), with seeded flax weights carried over by
``wavegrad_from_jax`` and the JAX keys' draws passed to the port.

Tolerances, each stated in its test: the forward within 1e-5 of max|out| at
noise levels up to 0.01 and 1e-4 up to 1 (the Fourier features of the noise
level are sin(5000 s f): a 1-ulp difference of fp32 ``exp`` in f, which XLA
and torch round differently, moves them by up to 5e-4 there, as JAX's own
jitted and eager embeddings differ); ``sample`` over FAST_6 within 1e-4 of
max|out|; the loss within 1e-5 and each gradient within 1e-4 of its
tensor's max|g| (1e-3 for the FiLM ``emb`` weights, whose gradient is an
outer product with that embedding: XLA's fp32 ``exp`` differs from the
correctly rounded value in 66 of the 256 frequencies, torch's in 6); after
three training steps the loss within 1e-4 and parameters and EMA within
1e-2 of an Adam step (a step for the FiLM ``emb`` weights); ``generate``
from each side's checkpoint within 1e-3 of max|out|; BDDM's losses and schedule within 1e-4."""

import base64
import functools
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolab_tpu.models import wavegrad as JWG
from audiolab_tpu.serve.api import create_app as j_create_app
from audiolab_tpu.train import wavetransfer as JWT
from audiolab_tpu.train.checkpoint import checkpoint_manager, restore_train_state
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.models import wavegrad as TWG
from audiolab_tpu_torch.serve.api import create_app
from audiolab_tpu_torch.train import wavetransfer as TWT
from audiolab_tpu_torch.train.checkpoint import checkpoint_manager as port_checkpoint_manager
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

SR = 8000
B = 2


def _wt_cfg(**kw):
    return dict(dict(sr=SR, n_mels=16, seg_frames=12, batch_size=B, lr=1e-3, steps=3,
                     ckpt_every=3), **kw)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _inputs(b=B, t=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t * 60)).astype(np.float32),
            rng.standard_normal((b, t, 16)).astype(np.float32))


def _clip(seconds, f0, seed):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(t.size)).astype(
        np.float32)


def _project(root, name):
    proj = root / name
    (proj / "data").mkdir(parents=True)
    write_wav(proj / "data" / "a.wav", _clip(0.5, 220.0, 1), SR)
    write_wav(proj / "data" / "b.wav", _clip(0.4, 330.0, 2), 16000)
    return str(proj)


def test_state_dict_names_are_the_flax_paths():
    _jm, tpl, _p, tm = tiny.wavegrad()
    flat = {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tpl)}
    want = {k.replace("/kernel", "/weight").replace("/", ".") for k in flat}
    assert set(tm.state_dict()) == want


@pytest.mark.parametrize("factor", [2, 3, 5])
def test_blocks_match_flax_at_each_factor(factor):
    """DBlock (stride ``factor``: flax's SAME pads a strided k = 3 conv
    asymmetrically) and UBlock (nearest upsampling by ``factor``) against the
    flax modules, within 1e-5 of max|out|."""
    rng = np.random.default_rng(factor)
    x = rng.standard_normal((2, 30, 4)).astype(np.float32)
    jd = JWG.DBlock(6, factor)
    p = tiny.filled(jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), x))["params"], factor)
    td = TWG.DBlock(4, 6, factor)
    td.load_state_dict(W.wavegrad_from_jax(p))
    want = np.asarray(jd.apply({"params": p}, x))
    got = td(torch.from_numpy(x).transpose(1, 2)).detach().transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, -(-30 // factor), 6)
    _close(got, want, 1e-5)

    shift = rng.standard_normal((2, 30 * factor, 6)).astype(np.float32)
    scale = rng.standard_normal((2, 1, 6)).astype(np.float32)
    ju = JWG.UBlock(6, factor)
    p = tiny.filled(jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), x, shift, scale))[
        "params"], factor + 10)
    tu = TWG.UBlock(4, 6, factor)
    tu.load_state_dict(W.wavegrad_from_jax(p))
    want = np.asarray(ju.apply({"params": p}, x, shift, scale))
    got = tu(*(torch.from_numpy(a).transpose(1, 2) for a in (x, shift, scale)))
    _close(got.detach().transpose(1, 2).numpy(), want, 1e-5)


@functools.lru_cache(maxsize=None)
def _jit_apply():
    jm, _tpl, p, _tm = tiny.wavegrad()
    return jax.jit(lambda a, m, s: jm.apply({"params": p}, a, m, s))


@pytest.mark.parametrize("levels,rel", [((0.003, 0.01), 1e-5), ((0.3, 0.999), 1e-4)])
def test_forward_matches_jax(levels, rel):
    _jm, _tpl, _p, tm = tiny.wavegrad()
    a, m = _inputs()
    s = np.asarray(levels, np.float32)
    want = np.asarray(_jit_apply()(a, m, s))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(v) for v in (a, m, s))).numpy()
    assert got.shape == want.shape == a.shape
    _close(got, want, rel)


def test_sample_over_fast6_matches_jax():
    jm, _tpl, p, tm = tiny.wavegrad()
    _a, m = _inputs(seed=1)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda m: JWG.sample(jm, p, m, JWG.FAST_6, key))(m))
    draws = tiny.jax_sample_draws(key, 6, B, 360)
    got = TWG.sample(tm, torch.from_numpy(m), TWG.FAST_6, draws=torch.from_numpy(draws)).numpy()
    assert got.shape == want.shape == (B, 360) and np.abs(got).max() <= 1.0
    _close(got, want, 1e-4)


def test_diffusion_loss_and_gradients_match_jax():
    jm, _tpl, p, tm = tiny.wavegrad()
    a, m = _inputs(seed=2)
    key = jax.random.PRNGKey(7)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JWG.diffusion_loss(jm, p, a, m, key)))(p)
    scale, eps = tiny.jax_loss_draws(key, B, a.shape[1])
    tm.zero_grad()
    got = TWG.diffusion_loss(tm, torch.from_numpy(a), torch.from_numpy(m),
                             torch.from_numpy(scale), torch.from_numpy(eps))
    got.backward()
    _close(got.item(), float(loss), 1e-5)
    want = W.wavegrad_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, prm in tm.named_parameters():
        # a FiLM ``emb`` weight's gradient is an outer product with the noise
        # embedding itself, which carries fp32 exp's rounding (module
        # docstring): 1e-3 there, 1e-4 for every other tensor
        rel = 1e-3 if name.endswith(".emb.weight") else 1e-4
        _close(prm.grad.numpy(), want[name].numpy(), rel)
    tm.zero_grad(set_to_none=True)


@functools.lru_cache(maxsize=None)
def _jit_init(cfg):
    return jax.jit(JWG.WaveGrad(cfg).init)


class _JitInitWaveGrad(JWG.WaveGrad):
    """The JAX WaveGrad with ``init`` jitted: one compile instead of one per
    parameter (about 8 s a call on the CPU); the values are flax's."""

    def init(self, rngs, *args, **kw):
        return _jit_init(self.cfg)(rngs, *args)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' train_model for three steps from the same start (the
    JAX init's flax parameters) on the same batches, with the JAX keys'
    draws and an EMA decay of 0.5 (at 0.9999 three steps leave the EMA at
    its start to fp32 rounding); each its own project.  The JAX trainer
    and generate run with ``_JitInitWaveGrad``."""
    root = tmp_path_factory.mktemp("wt")
    jproj, tproj = _project(root, "jax"), _project(root, "port")
    jcfg = JWT.WTConfig(model=JWG.WaveGradConfig(**tiny.WAVEGRAD), **_wt_cfg(ema=0.5))
    tcfg = TWT.WTConfig(model=TWG.WaveGradConfig(**tiny.WAVEGRAD), **_wt_cfg(ema=0.5))
    assert JWT.preprocess_project(jproj, jcfg) == TWT.preprocess_project(tproj, tcfg) == 2
    n = tcfg.seg_frames * 60
    init = _jit_init(jcfg.model)(
        jax.random.PRNGKey(0), jnp.zeros((B, n)), jnp.zeros((B, tcfg.seg_frames, 16)),
        jnp.ones((B,)))["params"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JWT, "WaveGrad", _JitInitWaveGrad)
        jres = JWT.train_model(jproj, jcfg)
    # the JAX trainer's init consumes the first batch: the port starts one on
    gen = TWT._load_segments(tproj, tcfg, np.random.default_rng(0), torch.device("cpu"))
    next(gen)

    def draws(step, b, n):
        return tuple(torch.from_numpy(v) for v in tiny.jax_loss_draws(jax.random.PRNGKey(step),
                                                                      b, n))

    # the JAX trainer's start, as a step-0 checkpoint the port resumes from
    start = TWG.WaveGrad(tcfg.model)
    start.load_state_dict(W.wavegrad_from_jax(jax.tree_util.tree_map(np.asarray, init)))
    port_checkpoint_manager(os.path.join(tproj, "ckpt")).save(0, {
        "step": 0, "params": start.state_dict(), "ema": start.state_dict(),
        "opt": torch.optim.Adam(start.parameters(), lr=tcfg.lr).state_dict()})
    tres = TWT.train_model(tproj, tcfg, segment_gen=gen, device="cpu", draws=draws)
    tpl = {"params": init, "opt": optax.adam(jcfg.lr).init(init), "ema": init, "step": 0}
    jstate = restore_train_state(checkpoint_manager(os.path.join(jproj, "ckpt")), tpl)
    return dict(jproj=jproj, tproj=tproj, jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres,
                jstate=jstate)


def test_three_train_steps_match_jax(trained):
    """After three steps: the loss within 1e-4, and parameters and EMA
    within 1e-2 of an Adam step (lr) of the JAX ones, element by element.
    Adam's update is m / sqrt(v), a sign at the first step, so a gradient
    element near 0 moves its parameter by a whole step either way; the
    FiLM ``emb`` weights, whose gradients carry the noise embedding's
    rounding (module docstring), are held to 1 step.  A wrong batch, draw,
    moment, bias correction or EMA moves every tensor by a step or more."""
    jstate, tres = trained["jstate"], trained["tres"]
    lr = trained["tcfg"].lr
    assert int(jstate["step"]) == 3 and tres["steps"] == 3
    _close(tres["loss"], trained["jres"]["loss"], 1e-4)
    state = torch.load(os.path.join(trained["tproj"], "ckpt", "ckpt_3.pt"), weights_only=True)
    assert state["step"] == 3
    for key in ("params", "ema"):
        want = W.wavegrad_from_jax(jax.tree_util.tree_map(np.asarray, jstate[key]))
        assert set(state[key]) == set(want)
        for name, v in state[key].items():
            tol = lr if name.endswith(".emb.weight") else 1e-2 * lr
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=tol, rtol=0,
                                       err_msg=f"{key} {name}")


def test_generate_from_each_sides_checkpoint(trained):
    """generate on 1 s at 8 kHz (three chunks of 64 frames, 4 frames of
    overlap) over FAST_12 from each package's own checkpoint with the JAX
    keys' draws, within 1e-3 of max|out| (the two checkpoints differ as
    ``test_three_train_steps_match_jax`` allows: by up to an Adam step in
    the FiLM ``emb`` weights).  Without the prepared WAVs the JAX generate
    cannot build its restore template and fails; the port's reads the
    checkpoint alone (ROADMAP queue 3)."""
    x = _clip(1.0, 260.0, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JWT, "WaveGrad", _JitInitWaveGrad)
        want, sr = JWT.generate(trained["jproj"], x, SR, trained["jcfg"], JWG.FAST_12, seed=4)
    draws = tiny.jax_sample_draws(jax.random.PRNGKey(4), 12, 3, 64 * 60)
    got, sr_t = TWT.generate(trained["tproj"], x, SR, trained["tcfg"], TWG.FAST_12,
                             device="cpu", draws=torch.from_numpy(draws))
    assert sr == sr_t == SR and got.shape == want.shape == (SR,)
    _close(got, want, 1e-3)

    for proj in (trained["jproj"], trained["tproj"]):
        shutil.rmtree(os.path.join(proj, "prepared"))
    with pytest.raises(ValueError, match="no prepared wavs"):
        JWT.generate(trained["jproj"], x, SR, trained["jcfg"], JWG.FAST_12, seed=4)
    again, _ = TWT.generate(trained["tproj"], x, SR, trained["tcfg"], TWG.FAST_12,
                            device="cpu", draws=torch.from_numpy(draws))
    np.testing.assert_array_equal(again, got)


def test_resume_and_cancel(tmp_path):
    """A second train_model with more steps resumes from the newest
    checkpoint; a cancelled token stops before the first step."""
    proj = _project(tmp_path, "p")
    cfg = TWT.WTConfig(model=TWG.WaveGradConfig(**tiny.WAVEGRAD), **_wt_cfg(steps=2,
                                                                            ckpt_every=2))
    TWT.preprocess_project(proj, cfg)
    seen = []
    TWT.train_model(proj, cfg, device="cpu")
    cfg.steps = 4
    res = TWT.train_model(proj, cfg, device="cpu", callback=lambda i, msg, total: seen.append(i))
    assert seen == [4] and np.isfinite(res["loss"]) and res["warm_step_s"] > 0
    mgr = port_checkpoint_manager(os.path.join(proj, "ckpt"))
    assert mgr.all_steps() == [2, 4]
    token = TWT.CancellationToken()
    token.cancel()
    cfg.steps = 6
    res = TWT.train_model(proj, cfg, device="cpu", token=token)
    assert mgr.all_steps() == [2, 4] and res["first_step_s"] is None


def test_bddm_schedule_net_and_search_match_jax():
    """Two schedule-net steps (Eq. 14 loss) from the flax init, then the
    reverse schedule search: losses, phi's parameters and the found betas
    within 1e-4."""
    jm, _tpl, p, tm = tiny.wavegrad()
    a, m = _inputs(seed=3)
    a = np.clip(a * 0.3, -1, 1)
    seed, tau = 3, 250
    jnet, jsp, jlosses = JWT.train_schedule_net(jm, p, jnp.asarray(a), jnp.asarray(m),
                                                steps=2, lr=1e-3, seed=seed, tau=tau)
    init = JWT.BDDMScheduleNet().init(jax.random.PRNGKey(seed), jnp.asarray(a),
                                      jnp.ones((B, 2)))["params"]
    net = TWT.BDDMScheduleNet()
    net.load_state_dict(W.bddm_from_jax(jax.tree_util.tree_map(np.asarray, init)))
    keys, rng = [], jax.random.PRNGKey(seed)
    for _ in range(2):
        rng, k = jax.random.split(rng)
        k1, k2 = jax.random.split(k)
        keys.append((torch.from_numpy(np.asarray(jax.random.randint(k1, (B,), tau, 1000 - tau))
                                      ).long(),
                     torch.from_numpy(np.asarray(jax.random.normal(k2, a.shape)))))
    net, losses = TWT.train_schedule_net(tm, torch.from_numpy(a), torch.from_numpy(m),
                                         steps=2, lr=1e-3, tau=tau, sched_net=net,
                                         draws=lambda step: keys[step])
    _close(losses, jlosses, 1e-4)
    want = W.bddm_from_jax(jax.tree_util.tree_map(np.asarray, jsp))
    for name, v in net.state_dict().items():
        _close(v.numpy(), want[name].numpy(), 1e-4)

    jsched = JWT.bddm_noise_scheduling(jm, p, jnet, jsp, jnp.asarray(m[:1]), max_steps=6,
                                       seed=seed)
    rng = jax.random.PRNGKey(seed)
    zs = []
    for _ in range(6):
        rng, k = jax.random.split(rng)
        zs.append(np.asarray(jax.random.normal(k, (1, 360))))
    with torch.no_grad():
        tsched = TWT.bddm_noise_scheduling(tm, net, torch.from_numpy(m[:1]), max_steps=6,
                                           draws=torch.from_numpy(np.stack(zs)))
    assert len(tsched.betas) == len(jsched.betas) >= 1
    _close(tsched.betas, jsched.betas, 1e-4)


def _wav_b64(tmp_path, name, x, sr):
    p = tmp_path / name
    write_wav(p, x, sr)
    return {"filename": name, "content": base64.b64encode(p.read_bytes()).decode()}


def _wait(router, job, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        _code, status = router.dispatch("GET", f"/api/v1/rvc/job/{job}", {})
        if status["status"] != "running":
            return status
        time.sleep(0.05)
    raise AssertionError("job did not finish")


def test_served_routes_against_the_jax_router(tmp_path, monkeypatch):
    """The five routes: projects, schedule and the errors answer as the JAX
    router's; a served train (tiny WTConfig patched in) runs as a job and a
    served generate returns the WAV the library call gives.  A project name
    with a path in it is refused (the JAX routes join it unchecked)."""
    j = j_create_app(str(tmp_path / "jax" / "process"))
    t = create_app(str(tmp_path / "port" / "process"), device="cpu")
    for method, path, body in (("GET", "/api/v1/wavetransfer/projects", {}),
                               ("GET", "/api/v1/wavetransfer/schedule", {}),
                               ("POST", "/api/v1/wavetransfer/cancel", {"project": "x"}),
                               ("POST", "/api/v1/wavetransfer/generate", {"project": "x"})):
        assert t.dispatch(method, path, body) == j.dispatch(method, path, body)

    monkeypatch.setattr(TWT, "WTConfig", functools.partial(
        TWT.WTConfig, n_mels=16, seg_frames=12, model=TWG.WaveGradConfig(**tiny.WAVEGRAD)))
    files = [_wav_b64(tmp_path, "a.wav", _clip(0.5, 220.0, 1), SR),
             _wav_b64(tmp_path, "b.wav", _clip(0.4, 330.0, 2), 16000)]
    code, resp = t.dispatch("POST", "/api/v1/wavetransfer/train", {
        "project": "voice", "files": files,
        "settings": {"sr": SR, "steps": 2, "batch_size": B, "ckpt_every": 2}})
    assert code == 200 and resp["project"] == "voice"
    status = _wait(t, resp["job_id"])
    assert status["status"] == "done", status
    assert status["result"]["steps"] == 2 and np.isfinite(status["result"]["loss"])
    assert t.dispatch("GET", "/api/v1/wavetransfer/projects", {}) == (200, {"projects": ["voice"]})
    assert t.dispatch("POST", "/api/v1/wavetransfer/cancel", {"project": "voice"}) == (
        200, {"cancelled": "voice"})

    src = _clip(0.6, 250.0, 5)
    code, resp = t.dispatch("POST", "/api/v1/wavetransfer/generate", {
        "project": "voice", "files": [_wav_b64(tmp_path, "src.wav", src, SR)],
        "settings": {"sr": SR, "schedule": "fast12"}})
    assert code == 200 and resp["sample_rate"] == SR and resp["format"] == "wav"
    out = tmp_path / "out.wav"
    out.write_bytes(base64.b64decode(resp["audio"]))
    got = read_audio(str(out)).samples[0]
    proj = str(tmp_path / "port" / "wavetransfer" / "voice")
    want, _ = TWT.generate(proj, read_audio(str(tmp_path / "src.wav")).samples[0], SR,
                           TWT.WTConfig(sr=SR), TWG.FAST_12, device="cpu")
    write_wav(tmp_path / "want.wav", want, SR)
    assert got.shape == want.shape == src.shape
    np.testing.assert_array_equal(got, read_audio(str(tmp_path / "want.wav")).samples[0])

    for bad in ("..", ".", ""):
        assert t.dispatch("POST", "/api/v1/wavetransfer/train", {"project": bad})[0] == 400
    assert t.dispatch("POST", "/api/v1/wavetransfer/cancel", {"project": "../voice"}) == (
        200, {"cancelled": "voice"})
