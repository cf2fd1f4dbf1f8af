"""The port's Whisper (models/whisper.py) against the JAX package's, on the
CPU, at a narrow width (dim 64, 4 heads, 2 + 2 layers, 600 tokens, 24 text
positions): the weights are a seeded flax tree carried over by
``whisper_from_jax``, and ``convert_whisper`` maps the port's state_dict
back onto it.

Tolerances: the log-mel within 1e-5 of its max|.| (fp32 STFT and filterbank
sums in another order), the encoder output and the uncached logits within
1e-5 of their max|.|, the cached decode against the uncached forward within
1e-5 of max|logit|; greedy tokens identical, and sampled tokens identical
under the JAX keys' Gumbel draws (``tests/torch_port_tiny.py::jax_draws``).
The JAX decode runs its flax modules through ``tiny.Jitted`` (its own code
unchanged)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import whisper as JW
from audiolab_tpu.utils.convert import convert_whisper
from audiolab_tpu_torch.models import whisper as TW
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

CFG = dict(n_mels=80, dim=64, n_heads=4, n_audio_layers=2, n_text_layers=2, vocab_size=600,
           n_text_ctx=24, sot=520, eot=519, no_timestamps=530, timestamp_base=531)


@functools.lru_cache(maxsize=None)
def _pair():
    """(flax template, flax params, JAX model jitted, port model)."""
    jm = JW.WhisperModel(JW.WhisperConfig(**CFG))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3000, 80)),
                                         jnp.zeros((1, 4), jnp.int32)))["params"]
    p = tiny.filled(tpl, 50)
    tm = TW.WhisperModel(TW.WhisperConfig(**CFG))
    tm.load_state_dict(W.whisper_from_jax(p), strict=True)
    return tpl, p, tiny.Jitted(jm), tm.eval()


@functools.lru_cache(maxsize=None)
def _mel():
    """45 s of seeded noise at 16 kHz as the JAX package's (2, 3000, 80)
    windows, and the port's."""
    x = (0.1 * np.random.default_rng(0).standard_normal(16000 * 45)).astype(np.float32)
    return (np.array(JW.log_mel_30s(x, JW.WhisperConfig(**CFG))),
            TW.log_mel_30s(x, TW.WhisperConfig(**CFG), "cpu").numpy())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: its small recurrent and attention
    ops run fastest so, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def test_weights_round_trip_through_the_jax_converter():
    tpl, p, _jm, tm = _pair()
    tiny.assert_tree_equal(convert_whisper(tiny.numpy_state(tm), tpl), p)
    assert "encoder.positional_embedding" not in tm.state_dict()
    assert tm.encoder.blocks[0].attn.key.bias is None


def test_log_mel_matches_jax():
    jmel, tmel = _mel()
    assert tmel.shape == jmel.shape == (2, 3000, 80)
    _close(tmel, jmel)


def test_encoder_and_uncached_logits_match_jax():
    _tpl, p, jm, tm = _pair()
    jmel, _ = _mel()
    toks = np.random.default_rng(1).integers(0, 600, (2, 12)).astype(np.int32)
    ref_enc = np.asarray(jm.apply({"params": p}, jnp.asarray(jmel), method=JW.WhisperModel.encode))
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(jmel), jnp.asarray(toks)))
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(jmel)).numpy()
        logits = tm(torch.from_numpy(jmel), torch.from_numpy(toks).long()).numpy()
    assert enc.shape == (2, 1500, 64) and logits.shape == (2, 12, 600)
    _close(enc, ref_enc)
    _close(logits, ref)
    cached = TW.cached_logits(tm, torch.from_numpy(jmel), torch.from_numpy(toks).long())
    _close(cached.numpy(), logits)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_tokens_identical(temperature):
    """24 steps (all the text positions: the JAX decode's last, unused
    forward already reads a clamped position), greedy and sampled."""
    _tpl, p, jm, tm = _pair()
    jmel, _ = _mel()
    ref = np.asarray(JW.transcribe_window(jm, p, jnp.asarray(jmel), max_tokens=24,
                                          temperature=temperature, rng=jax.random.PRNGKey(3)))
    draws = tiny.jax_draws(3, 24, 2, 600) if temperature else None
    out = TW.transcribe_window(tm, jmel, max_tokens=24, temperature=temperature, draws=draws,
                               device="cpu")
    assert out.dtype == torch.long and out.shape == (2, 24)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > (4 if temperature else 1)


def test_decode_past_the_text_positions():
    """ROADMAP queue 3: the JAX decode slices its positions with a clamped
    dynamic slice, so with max_tokens past n_text_ctx it silently feeds the
    table's last row again.  Its tokens equal the port's on a table that
    repeats its last row 4 times; the port refuses such a call."""
    _tpl, p, jm, tm = _pair()
    jmel, _ = _mel()
    ref = np.asarray(JW.transcribe_window(jm, p, jnp.asarray(jmel[:1]), max_tokens=28))
    with pytest.raises(ValueError, match="text positions"):
        TW.transcribe_window(tm, jmel[:1], max_tokens=28, device="cpu")
    longer = TW.WhisperModel(TW.WhisperConfig(**dict(CFG, n_text_ctx=28)))
    sd = dict(tm.state_dict())
    pos = sd["decoder.positional_embedding"]
    sd["decoder.positional_embedding"] = torch.cat([pos, pos[-1:].expand(4, -1)])
    longer.load_state_dict(sd, strict=True)
    out = TW.transcribe_window(longer.eval(), jmel[:1], max_tokens=28, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
