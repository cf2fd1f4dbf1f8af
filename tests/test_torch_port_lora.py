"""ACE-Step LoRA training in the port against the JAX package on the CPU.

- The attention kernels' gradient: K1's and K2's ``autograd.Function``
  (whose forward is the wrapper's call and whose backward is the plain
  version's gradient), called through the wrappers and by its ``backward``
  directly, against autograd of the plain version (bit for bit: the same
  ops) and K2's fp32 gradient against JAX's autodiff of its plain attention
  (1e-5 of max|g|); grad off is the wrapper's old call; K3-K7 refuse a
  gradient.
- ``lora_init``'s shapes and paths, ``lora_weights``/``LoRAModel`` against
  the JAX ``lora_apply`` (1e-5 of max|v|), ``.npz`` adapters both ways.
- ``train_lora`` over 3 steps with JAX's factors, draws and projector
  passed in, in fp32 (the loss within 1e-4; every factor, and with the SSL
  loss the projector, within 1e-3 of its tensor's scale) and with the DiT
  in bf16 (the loss and the adapted velocity y within 2e-2 of max|y|, PR
  16's bf16 tolerance).  Adam's step is the gradient over its own running
  norm, so an element's update carries its gradient's relative error: an
  element of b (or, from the second step, of a) whose gradient is a
  thousandth of the largest moves 1e-4 to 2e-4 of the tensor's scale apart
  between the packages in fp32, and in bf16 an element whose gradient is at
  rounding level moves a whole step apart, which is why bf16 holds the
  function and not the factors.
- The first step's factor gradients of both packages through the loss both
  trainers compute (the flow-matching MSE, with the SSL loss or without), at
  the trainer's start (b = 0, where a's gradient is 0 in both) and at one
  with b filled: 1e-4 of each tensor's max|g|, a quantity Adam's
  normalisation cannot amplify.

The JAX ``lora_init`` seeds each factor with ``hash()`` of its path
(``audiolab_tpu/models/acestep.py:419``), which changes with the process's
hash seed, so the JAX trainer's start (and with it Adam's treatment of
gradients near its eps) would differ between runs.  Every test here starts
the JAX trainer from :func:`crc_lora_init` instead, patched over the name
``audiolab_tpu.train.acestep_lora`` imported, and passes the same factors to
the port.  The rule: the JAX formula (a = N(0, 1) * 0.01 for each target
kernel, b = 0), each factor seeded with ``fold_in(PRNGKey(0), crc32(path) %
2**31)``, ``path`` the ``"/"``-joined path the ``.npz`` adapters use.
"""

import copy
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.kernels import attention as JK
from audiolab_tpu.models import acestep as JA
from audiolab_tpu.models import codecs as JC
from audiolab_tpu.pipelines import acestep as JP
from audiolab_tpu.train import acestep_lora as JL
from audiolab_tpu_torch.kernels import attention as TK
from audiolab_tpu_torch.kernels import norms as TN
from audiolab_tpu_torch.models import acestep as TA
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.pipelines import acestep as TP
from audiolab_tpu_torch.train import acestep_lora as TL
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.test_torch_port_acestep import JaxDraws
from tests.test_torch_port_music import close
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(21)
BF = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _qkv(shape_q, shape_k, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(_t(rng.standard_normal(s).astype(np.float32), dtype).requires_grad_(True)
                 for s in (shape_q, shape_k, shape_k))


def _plain_grads(fn, q, k, v, g):
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    return torch.autograd.grad(fn(*leaves), leaves, g)


# ------------------------------------------------------------------ the kernels' gradient


@pytest.mark.parametrize("kernel,dtype,tq,tk,causal", [
    ("k1", BF, 32, 32, False),            # the trainer's 32-frame segments
    ("k2", BF, 200, 200, False),          # past 128 frames: the 16-bit K2
    ("k2", torch.float32, 40, 70, True),
    ("k2", BF, 90, 40, True)])            # keyless rows get the mean of v
def test_attention_gradient_is_the_plain_versions(kernel, dtype, tq, tk, causal):
    q, k, v = _qkv((2, 3, tq, 64), (2, 3, tk, 64), dtype, tq + tk)
    g = _t(np.random.default_rng(1).standard_normal((2, 3, tq, 64)), dtype)
    scale = 0.125
    if kernel == "k1":
        out = TK.attention_nk1(q, k, v)
        plain = functools.partial(TK.attention_nk1_reference, scale=scale)
        fn = TK._K1Grad
    else:
        out = TK.flash_attention_fwd(q, k, v, causal=causal)
        plain = functools.partial(TK.flash_attention_reference, causal=causal, scale=scale)
        fn = TK._K2Grad
    assert type(out.grad_fn).__name__ == f"{fn.__name__}Backward"
    with torch.no_grad():
        assert torch.equal(out, plain(q, k, v))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = _plain_grads(plain, q, k, v, g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)

    class Ctx:                                            # the Function's backward, called
        saved_tensors = (q.detach(), k.detach(), v.detach())
        needs_input_grad = (True, False, True, False, False)
        causal, scale = False, 0.125

    Ctx.causal = causal
    direct = fn.backward(Ctx, g)
    assert torch.equal(direct[0], want[0]) and direct[1] is None
    assert torch.equal(direct[2], want[2]) and all(x is None for x in direct[3:])


def test_k2_fp32_gradient_matches_jax_autodiff():
    """K2's backward in fp32 against ``jax.vjp`` of the JAX package's plain
    attention, which is what the JAX package differentiates on the CPU."""
    q, k, v = _qkv((1, 2, 24, 64), (1, 2, 40, 64), torch.float32, 3)
    g = np.random.default_rng(4).standard_normal((1, 2, 24, 64)).astype(np.float32)
    out = TK.flash_attention(q, k, v, causal=True, block_k=16)
    got = torch.autograd.grad(out, (q, k, v), _t(g))
    _, vjp = jax.vjp(lambda a, b, c: JK.attention_reference(a, b, c, causal=True),
                     *(jnp.asarray(x.detach().numpy()) for x in (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        close(a.numpy(), b, 1e-5, "K2 gradient")


def test_grad_off_is_the_old_call_and_other_kernels_refuse_a_gradient():
    q, k, v = _qkv((1, 2, 20, 64), (1, 2, 20, 64), BF, 5)
    TK.reset_launch_counts()
    with torch.no_grad():
        assert TK.flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert TK.flash_attention(q, k, v).grad_fn is None
    assert TK.flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None
    assert (TK.attention_nk1.launches, TK.flash_attention_fwd.launches) == (0, 0)
    cos, sin = TK.rope_tables(20, 64)
    calls = [lambda: TK.attention_nk1_rope(q, k, v, cos, sin),
             lambda: TK.slim_attention(q, k, v), lambda: TK.attention_nk1_core(q, k, v),
             lambda: TK.flash_attention_fwd_core(q, k, v),
             lambda: TK.packed_attention(*(x.reshape(1, 20, 128) for x in (q, k, v)), 2, 64),
             lambda: TN.rms_norm(q, torch.ones(64, requires_grad=True)),
             lambda: TN.layer_norm(q, torch.ones(64), torch.zeros(64))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no gradient through this kernel"):
            call()
        with torch.no_grad():
            call()


# ------------------------------------------------------------------ adapters


@functools.lru_cache(maxsize=None)
def pipelines(dtype: str = "float32"):
    """(JAX ACEStepPipeline with jitted modules, port pipeline on the CPU) at
    random_acestep's widths, the DiT in ``dtype``, on the same weights."""
    jref = JP.random_acestep()          # for its configurations only
    cfg = jref.cfg
    cfg.dit = type(cfg.dit)(**dict(vars(cfg.dit), dtype=dtype))
    model = JA.ACEStepModel(cfg)
    tpl = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.dcae.hop * 4, cfg.dcae.n_mels)),
        jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)),
        method=JA.ACEStepModel.full_init))["params"]
    p = tiny.filled(tpl, 22)
    voc = JC.Vocos(jref.vocos.cfg)
    vp = tiny.filled(jax.eval_shape(lambda: voc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, cfg.dcae.n_mels))))["params"], 23)
    jp = JP.ACEStepPipeline(cfg, p, jref.vocos.cfg, vp)
    jp.model, jp.vocos = tiny.Jitted(jp.model), tiny.Jitted(jp.vocos)
    tcfg = TA.ACEStepConfig(
        sr=cfg.sr, mel_hop=cfg.mel_hop, dcae=TA.DCAEConfig(**vars(cfg.dcae)),
        dit=TP.DiTConfig(**vars(cfg.dit)), text_dim=cfg.text_dim, text_layers=cfg.text_layers,
        lyric_vocab=cfg.lyric_vocab)
    tm = tiny._load(TA.ACEStepModel(tcfg), W.acestep_from_jax(p))
    tv = tiny._load(TC.Vocos(TC.VocosConfig(**vars(jref.vocos.cfg)), in_dim=cfg.dcae.n_mels),
                    W.vocos_from_jax(vp))
    return jp, TP.ACEStepPipeline(tm, tv, device="cpu", draws=JaxDraws())


def crc_lora_init(params, rng, rank: int = 8, targets=("wq", "wk", "wv", "wo")) -> dict:
    """The JAX ``lora_init`` with each factor seeded by ``crc32`` of its
    path's text in place of ``hash()`` of the path: the same walk, shapes
    and formula, and the same start in every process."""
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            p = path + (k,)
            if not isinstance(v, dict):
                continue
            if k in targets and "kernel" in v:
                key = jax.random.fold_in(rng, zlib.crc32("/".join(p).encode()) % (2**31))
                din, dout = v["kernel"].shape
                flat[p] = {"a": jax.random.normal(key, (din, rank)) * 0.01,
                           "b": jnp.zeros((rank, dout))}
            else:
                walk(v, p)

    walk(params, ())
    return flat


@pytest.fixture(autouse=True)
def _jax_start_by_crc(monkeypatch):
    """The JAX trainer starts from :func:`crc_lora_init`."""
    monkeypatch.setattr(JL, "lora_init", crc_lora_init)


def _jax_lora(jp, rank=4):
    """The factors the JAX ``train_lora`` starts from (:func:`crc_lora_init`
    at ``PRNGKey(0)``), and a copy with b filled so that a merge is not the
    identity."""
    lora = crc_lora_init(jp.base_params["dit"], jax.random.PRNGKey(0), rank)
    rng = np.random.default_rng(24)
    return lora, {path: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape)
                                                         * 0.05, jnp.float32)}
                  for path, ab in sorted(lora.items())}


def test_lora_init_paths_and_shapes_are_the_jax_ones():
    jp, tp = pipelines()
    jl, _ = _jax_lora(jp)
    hashed = JA.lora_init(jp.base_params["dit"], jax.random.PRNGKey(0), 4)
    assert set(hashed) == set(jl)
    for path, ab in hashed.items():
        for n in ("a", "b"):
            assert ab[n].shape == jl[path][n].shape
        assert not np.asarray(jl[path]["b"]).any()
        assert 0.005 < float(np.std(jl[path]["a"])) < 0.02
    tl = TA.lora_init(tp.model.dit, 4, seed=3)
    assert set(tl) == set(jl) and len(tl) == 4 * tp.cfg.dit.n_layers
    for path, ab in tl.items():
        assert ab["a"].shape == jl[path]["a"].shape and not ab["b"].any()
        assert ab["b"].shape == jl[path]["b"].shape
        assert 0.005 < float(ab["a"].std()) < 0.02
    assert all(torch.equal(tl[p]["a"], TA.lora_init(tp.model.dit, 4, seed=3)[p]["a"]) for p in tl)


def test_lora_merge_matches_jax_and_leaves_the_model_alone():
    jp, tp = pipelines()
    _, jl = _jax_lora(jp)
    tl = W.lora_from_jax(jl)
    z = RNG.standard_normal((2, 6, 4)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    ctx = RNG.standard_normal((2, 5, 32)).astype(np.float32)
    merged = dict(jp.base_params)
    merged["dit"] = JA.lora_apply(jp.base_params["dit"], jl, 0.5)
    want = jp.model.apply({"params": merged}, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx),
                          method=JA.ACEStepModel.velocity)
    before = {k: v.clone() for k, v in tp.model.state_dict().items()}
    with torch.no_grad():
        got = TA.LoRAModel(tp.model, tl, 0.5).velocity(_t(z), _t(t), _t(ctx))
        base = tp.model.velocity(_t(z), _t(t), _t(ctx))
    close(got.numpy(), want, 1e-5, "merged velocity")
    assert not torch.allclose(got, base)
    assert all(torch.equal(v, tp.model.state_dict()[k]) for k, v in before.items())


def test_npz_adapters_cross_both_ways(tmp_path):
    jp, _ = pipelines()
    _, jl = _jax_lora(jp)
    JL.save_lora(str(tmp_path / "jax.npz"), jl)
    got = TL.load_lora(str(tmp_path / "jax.npz"))
    assert set(got) == set(jl)
    for p, ab in jl.items():
        for n in ("a", "b"):
            np.testing.assert_array_equal(got[p][n].numpy(), np.asarray(ab[n]))
    TL.save_lora(str(tmp_path / "port.npz"), got)
    back = JL.load_lora(str(tmp_path / "port.npz"))
    assert set(back) == set(jl)
    for p, ab in jl.items():
        for n in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[p][n]), np.asarray(ab[n]))


# ------------------------------------------------------------------ training


def _dataset(sr, n=2, seconds=0.9):
    rng = np.random.default_rng(6)
    t = np.arange(int(sr * seconds)) / sr
    return [((0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t)
              + 0.05 * rng.standard_normal(t.size)).astype(np.float32),
             f"style {i}", "[verse] la la") for i in range(n)]


def ssl_features(audio):
    """A frozen stand-in SSL model shared by both packages: 64-sample frames
    through a fixed random projection, (frames, 12)."""
    w = np.random.default_rng(99).standard_normal((64, 12)).astype(np.float32)
    x = np.asarray(audio, np.float32)
    return np.tanh(x[: x.size // 64 * 64].reshape(-1, 64) @ w)


def _jax_draws(b, seg, latent_dim):
    """The JAX step's t and noise: ``split(PRNGKey(step))``, uniform then normal."""
    def draws(step):
        k1, k2 = jax.random.split(jax.random.PRNGKey(step))
        return (np.asarray(jax.random.uniform(k1, (b,))),
                np.asarray(jax.random.normal(k2, (b, seg, latent_dim))))
    return draws


@pytest.mark.parametrize("dtype,ssl", [("float32", False), ("float32", True),
                                       ("bfloat16", False)])
def test_train_lora_matches_jax(dtype, ssl):
    jp, tp = pipelines(dtype)
    data = _dataset(jp.cfg.sr)
    cfg = dict(rank=4, lr=1e-3, steps=3, seg_latent=8, batch_size=2,
               ssl_coeff=0.5 if ssl else 0.0, ssl_depth=0)
    jl, _ = _jax_lora(jp)
    if ssl:  # the SSL tap's depth is a static argument: the step jits the raw module
        jp = copy.copy(jp)
        jp.model = jp.model.module
    want = JL.train_lora(jp, data, JL.LoRATrainConfig(**cfg),
                         ssl_model=ssl_features if ssl else None)
    proj = None
    if ssl:
        proj = {"kernel": jax.random.normal(jax.random.PRNGKey(7), (jp.cfg.dit.dim, 12)) * 0.02,
                "bias": np.zeros(12, np.float32)}
        proj = {n: np.asarray(x) for n, x in proj.items()}
    seen = []
    got = TL.train_lora(tp, data, TL.LoRATrainConfig(**cfg),
                        ssl_model=ssl_features if ssl else None,
                        draws=_jax_draws(2, 8, jp.cfg.dit.in_dim), lora=W.lora_from_jax(jl),
                        proj=proj, callback=lambda *a: seen.append(a[0]))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert seen == [1, 2, 3]
    assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"])
    assert set(got["lora"]) == set(want["lora"])
    for p, ab in want["lora"].items():
        assert float(got["lora"][p]["b"].abs().max()) > 0
        if dtype == "float32":
            for n in ("a", "b"):
                close(got["lora"][p][n].numpy(), ab[n], 1e-3, f"{p} {n}")
    if dtype != "float32":
        z = RNG.standard_normal((2, 6, 4)).astype(np.float32)
        t = np.array([0.2, 0.7], np.float32)
        ctx = RNG.standard_normal((2, 5, 32)).astype(np.float32)
        merged = dict(jp.base_params)
        merged["dit"] = JA.lora_apply(jp.base_params["dit"], want["lora"])
        y = jp.model.apply({"params": merged}, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx),
                           method=JA.ACEStepModel.velocity)
        with torch.no_grad():
            got_y = TA.LoRAModel(tp.model, got["lora"]).velocity(_t(z), _t(t), _t(ctx))
        close(got_y.float().numpy(), np.asarray(y, np.float32), tol, "adapted velocity")
    if ssl:
        for n in ("kernel", "bias"):
            close(got["proj"][n].numpy(), want["proj"][n], 1e-3, f"projector {n}")
    assert all(not x.requires_grad for x in tp.model.parameters() if x.grad is not None)
    assert all(x.grad is None for x in tp.model.parameters())



def _first_batch(items, seg: int, batch: int, ssl_frames: int):
    """The first step's batch of one package's (latent, context, SSL
    features) items, by both trainers' ``default_rng(0)`` picks."""
    rng = np.random.default_rng(0)
    zs, ctxs, ssl = [], [], []
    for _ in range(batch):
        z, ctx, feats = items[rng.integers(len(items))]
        t = z.shape[1]
        s = rng.integers(0, t - seg + 1) if t >= seg else 0
        z = z[0, s: s + seg]                                # zero-padded to seg frames
        zs.append(z if z.shape[0] == seg else (
            jnp.pad(z, ((0, seg - z.shape[0]), (0, 0))) if isinstance(z, jnp.ndarray)
            else torch.nn.functional.pad(z, (0, 0, 0, seg - z.shape[0]))))
        ctxs.append(ctx[0])
        s0 = int(round(s / t * feats.shape[0]))
        span = np.asarray(feats[s0: s0 + ssl_frames])
        ssl.append(np.pad(span, ((0, ssl_frames - span.shape[0]), (0, 0))))
    return zs, ctxs, np.stack(ssl)


@pytest.mark.parametrize("ssl", [False, True])
def test_lora_first_step_gradients_match_jax(ssl):
    """The first training step's gradients of the factors (and, with the SSL
    loss, of the projector) in fp32: the JAX trainer's loss (the
    flow-matching MSE of ``flow_match_loss``'s draws, plus ``ssl_coeff``
    times ``ssl_projection_loss`` of the hidden states after block
    ``ssl_depth``) differentiated by ``jax.grad``, against the port
    trainer's ``flow_match_loss`` and ``ssl_projection_loss`` through
    ``LoRAModel``, on each package's own latents and contexts, both at the
    trainer's start (b = 0: a's gradient is 0 in both) and with b filled."""
    from audiolab_tpu.models.stable_audio import tokenize_prompt as j_prompt
    from audiolab_tpu_torch.models.stable_audio import tokenize_prompt as t_prompt

    jp, tp = pipelines()
    data = _dataset(jp.cfg.sr)
    seg, batch, coeff, depth = 8, 2, 0.5, 0
    feats = [ssl_features(audio) for audio, _, _ in data]
    ssl_frames = max(4, min(f.shape[0] for f in feats))
    j_items, t_items = [], []
    for (audio, prompt, lyrics), f in zip(data, feats):
        tag, lyr = j_prompt(prompt, 64)[None], JA.tokenize_lyrics(lyrics, 128)[None]
        j_items.append((jp._latents_of_audio(audio), jp.model.apply(
            {"params": jp.base_params}, jnp.asarray(tag), jnp.asarray(lyr),
            method=JA.ACEStepModel.encode_cond), f))
        with torch.no_grad():
            tag, lyr = t_prompt(prompt, 64)[None], TA.tokenize_lyrics(lyrics, 128)[None]
            t_items.append((tp._latents_of_audio(audio).float(), tp.model.encode_cond(
                torch.from_numpy(tag), torch.from_numpy(lyr)).float(), f))
    jz, jctx, tgt = _first_batch(j_items, seg, batch, ssl_frames)
    tz, tctx, _ = _first_batch(t_items, seg, batch, ssl_frames)
    jz, jctx, tz, tctx = jnp.stack(jz), jnp.stack(jctx), torch.stack(tz), torch.stack(tctx)
    t_draw, eps = _jax_draws(batch, seg, jp.cfg.dit.in_dim)(0)
    module = jp.model.module

    def jax_loss(state):
        merged = dict(jp.base_params)
        merged["dit"] = JA.lora_apply(jp.base_params["dit"], state["lora"], 1.0)
        if not ssl:
            return JL.flow_match_loss(module, merged, jz, jctx, jax.random.PRNGKey(0))
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        t = jax.random.uniform(k1, (batch,))
        e = jax.random.normal(k2, jz.shape)
        z_t = (1.0 - t[:, None, None]) * jz + t[:, None, None] * e
        v, hidden = module.apply({"params": merged}, z_t, t, jctx, depth,
                                 method=JA.ACEStepModel.velocity_hidden)
        return (jnp.mean((v - (e - jz)) ** 2)
                + coeff * JL.ssl_projection_loss(hidden, state["proj"], jnp.asarray(tgt)))

    proj = {"kernel": np.asarray(jax.random.normal(jax.random.PRNGKey(7), (jp.cfg.dit.dim, 12))
                                 * 0.02), "bias": np.zeros(12, np.float32)}
    grad = jax.jit(jax.grad(jax_loss))
    for start in _jax_lora(jp):
        state = {"lora": start, "proj": proj} if ssl else {"lora": start}
        want = grad(state)
        factors = {p: {n: _t(ab[n]).requires_grad_(True) for n in ("a", "b")}
                   for p, ab in start.items()}
        tproj = {n: _t(x).requires_grad_(True) for n, x in proj.items()}
        adapted = TA.LoRAModel(tp.model, factors, 1.0)
        if ssl:
            loss, hidden = TL.flow_match_loss(adapted, tz, tctx, _t(t_draw), _t(eps), depth)
            loss = loss + coeff * TL.ssl_projection_loss(hidden, tproj, _t(tgt))
        else:
            loss = TL.flow_match_loss(adapted, tz, tctx, _t(t_draw), _t(eps))
        loss.backward()
        filled = bool(np.asarray(next(iter(start.values()))["b"]).any())
        for p, ab in want["lora"].items():
            for n in ("a", "b"):
                g = factors[p][n].grad
                assert g.dtype == torch.float32
                if n == "a" and not filled:
                    assert not g.any() and not np.asarray(ab[n]).any(), p
                else:
                    assert float(g.abs().max()) > 0, (p, n)
                close(g.numpy(), ab[n], 1e-4, f"{'filled' if filled else 'start'} {p} {n}")
        if ssl:
            for n in ("kernel", "bias"):
                close(tproj[n].grad.numpy(), want["proj"][n], 1e-4, f"projector {n}")
    assert all(x.grad is None for x in tp.model.parameters())

def test_interp_time_and_ssl_loss_match_jax():
    x = RNG.standard_normal((2, 7, 5)).astype(np.float32)
    for n in (3, 7, 16):
        close(TL._interp_time(_t(x), n).numpy(), JL._interp_time(jnp.asarray(x), n), 1e-6,
              f"interp {n}")
    h = RNG.standard_normal((2, 6, 8)).astype(np.float32)
    proj = {"kernel": RNG.standard_normal((8, 5)).astype(np.float32),
            "bias": RNG.standard_normal(5).astype(np.float32)}
    tgt = RNG.standard_normal((2, 9, 5)).astype(np.float32)
    want = JL.ssl_projection_loss(jnp.asarray(h), proj, jnp.asarray(tgt))
    got = TL.ssl_projection_loss(_t(h), {n: _t(v) for n, v in proj.items()}, _t(tgt))
    close(got.numpy(), want, 1e-6, "ssl loss")


def test_pipeline_lora_argument_merges_into_the_dit_and_the_jax_one_raises():
    """``ACEStepPipeline(lora=)`` takes the trainer's DiT-relative factors
    and generates what ``LoRAModel`` does with them; the JAX pipeline merges
    them into its whole tree, where ("block_0", "wq") is not a path, and
    raises (ROADMAP queue 3)."""
    jp, tp = pipelines()
    _, jl = _jax_lora(jp)
    tl = W.lora_from_jax(jl)
    with pytest.raises(KeyError):
        JP.ACEStepPipeline(jp.cfg, jp.base_params, jp.vocos.cfg, jp.vocos_params, lora=jl)
    merged = TP.ACEStepPipeline(copy.deepcopy(tp.model), tp.vocos, lora=tl, device="cpu",
                                draws=JaxDraws())
    seen = copy.copy(tp)
    seen.model = TA.LoRAModel(tp.model, tl)
    kw = dict(duration=1.0, infer_step=2, seed=3)
    y_merged, _ = merged.generate("lofi", **kw)
    y_seen, _ = seen.generate("lofi", **kw)
    y_base, _ = tp.generate("lofi", **kw)
    close(y_merged, y_seen, 1e-5, "merged against functional")
    assert np.abs(y_merged - y_base).max() > 1e-4 * np.abs(y_base).max()
