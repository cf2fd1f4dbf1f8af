"""Parity of the port's LM core (audiolab_tpu_torch/models/lm.py) with the
JAX package's models/lm.py on the CPU, at a test width (vocab 64, dim 32, 2
layers, 4 query heads over 2 KV heads), with seeded weights carried by
``lm_from_jax`` and mapped back by ``convert_llama``.

Tolerances: fp32 logits within 1e-5 of max|logit| (the JAX side's attention
normalises before the product, K2's plain version after it); bf16 within 2
bf16 ulps of max|logit| (2^-6 of the scale: the two sides round the scores
at different points).  Tokens agree exactly: the port is handed the Gumbel
draws that the JAX keys give."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import lm as JL
from audiolab_tpu.utils.convert import convert_llama
from audiolab_tpu_torch.models import lm as TL
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           max_seq_len=32)


def _close(out, ref, rel):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _lm(dtype: str):
    """(JAX config, module, params; port module) at CFG in one type."""
    cfg = JL.LMConfig(**CFG, dtype=dtype)
    jm = JL.TransformerLM(cfg)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 4), jnp.int32)))["params"]
    p = tiny.filled(tpl, 11)
    tm = TL.TransformerLM(TL.LMConfig(**CFG, dtype=dtype))
    tm.load_state_dict(W.lm_from_jax(p), strict=True)
    return cfg, jm, p, tm.eval()


@pytest.fixture(params=["float32", "bfloat16"])
def lm(request):
    return _lm(request.param)


@pytest.fixture
def lm32():
    return _lm("float32")


def test_state_dict_maps_back_through_convert_llama(lm):
    _cfg, _jm, p, tm = lm
    sd = {k: v.float().numpy() for k, v in tm.state_dict().items()}
    back = convert_llama(sd, p, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        # the port holds linear kernels in the configuration's type
        tol = 0 if tm.cfg.dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=1e-30)


def test_uncached_forward_matches_jax(lm):
    """The full causal forward (K2's plain version on the CPU)."""
    _cfg, jm, p, tm = lm
    toks = np.random.default_rng(0).integers(0, 64, (2, 12))
    ref, _ = jax.jit(lambda p, t: jm.apply({"params": p}, t))(p, jnp.asarray(toks))
    with torch.no_grad():
        out, _ = tm(torch.from_numpy(toks))
    _close(out.float(), ref, 1e-5 if tm.cfg.dtype == "float32" else 2.0 ** -6)


def test_prefill_and_steps_through_the_cache_match_jax(lm32):
    """A 6-token prefill through the cache (the causal block mask) and 4
    single steps, each call's logits against JAX's same calls (fp32)."""
    cfg, jm, p, tm = lm32
    toks = np.random.default_rng(1).integers(0, 64, (2, 10))
    jc = JL.init_cache(cfg, 2, 32)
    tc = TL.init_cache(tm.cfg, 2, 32)
    calls = [(0, 6)] + [(i, i + 1) for i in range(6, 10)]
    japply = jax.jit(lambda p, t, pos, c: jm.apply({"params": p}, t, pos, c))
    for a, b in calls:
        ref, jc = japply(p, jnp.asarray(toks[:, a:b]), jnp.arange(a, b), jc)
        with torch.no_grad():
            out, _ = tm(torch.from_numpy(toks[:, a:b]), torch.arange(a, b), tc)
        _close(out, ref, 1e-5)
    assert int(tc[0]["index"]) == 10 == int(jc[0]["index"])


@pytest.mark.parametrize("mode", ["greedy", "top_k", "top_p"])
def test_sample_logits_matches_jax(mode):
    kw = {"greedy": dict(temperature=0.0), "top_k": dict(temperature=0.8, top_k=5),
          "top_p": dict(temperature=1.1, top_p=0.7)}[mode]
    logits = np.random.default_rng(2).standard_normal((16, 40)).astype(np.float32) * 3
    key = jax.random.PRNGKey(5)
    ref = JL.sample_logits(jnp.asarray(logits), key, **kw)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape, jnp.float32)))
    out = TL.sample_logits(torch.from_numpy(logits), gumbel, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cfg_logits():
    c, u = np.float32([[1.0, 2.0]]), np.float32([[0.5, -1.0]])
    np.testing.assert_allclose(TL.cfg_logits(torch.from_numpy(c), torch.from_numpy(u), 3.0),
                               np.asarray(JL.cfg_logits(c, u, 3.0)))


def test_decode_codes_match_jax_under_the_jax_draws(lm32):
    """``decode`` over a 4-token prefill, 8 steps, top-k 6, a stop token:
    the port's tokens equal the JAX scan's under the JAX keys' draws."""
    cfg, jm, p, tm = lm32
    toks = np.random.default_rng(3).integers(0, 64, (2, 4))
    steps, stop, seed = 8, 7, 4
    jc = JL.init_cache(cfg, 2, 32)
    logits, jc = jm.apply({"params": p}, jnp.asarray(toks), jnp.arange(4), jc)
    first = jnp.argmax(logits[:, -1], axis=-1)

    def japply(params, t, pos, caches):
        return jm.apply({"params": params}, t, pos, caches)

    ref, _ = JL.decode(japply, p, jc, first, 4, steps, jax.random.PRNGKey(seed),
                       temperature=0.9, top_k=6, stop_token=stop)
    tc = TL.init_cache(tm.cfg, 2, 32)
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(toks), torch.arange(4), tc)

    def tapply(t, pos, caches):
        return tm(t, pos, caches)

    draws = tiny.jax_draws(seed, steps, 2, 64)
    out = TL.decode(tapply, tc, tl[:, -1].argmax(-1), 4, steps, temperature=0.9, top_k=6,
                    stop_token=stop, draws=torch.from_numpy(draws))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
