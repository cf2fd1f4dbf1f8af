"""The port's S3Gen (models/chatterbox_s3gen.py) and S3 tokenizer
(models/s3tokenizer.py) against the JAX package's, on the CPU, at the JAX
engine test's tiny widths (flow 32 wide, estimator 16 channels, HiFT base
16 on 8 mels; the tokenizer 2 x 32 on 128 mels), with seeded weights
carried by ``s3gen_flow_from_jax`` / ``hift_from_jax`` /
``s3tokenizer_from_jax``.

Tolerances: the rel-shift exact; attention, encoder and estimator outputs
within 1e-5 of their peak; mels and waveforms within 1e-4 of the peak
(HiFT under the JAX keys' source draws; its source phase is a running sum
over every sample, which the two packages round in another order); the
S3 ids identical."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolab_tpu.kernels.stft import istft as jax_istft
from audiolab_tpu.models import chatterbox_s3gen as JS
from audiolab_tpu.models import s3tokenizer as JS3
from audiolab_tpu.utils.convert import convert_hift, convert_s3gen_flow, convert_s3tokenizer
from audiolab_tpu_torch.kernels import stft as TStft
from audiolab_tpu_torch.models import chatterbox_s3gen as TS
from audiolab_tpu_torch.models import s3tokenizer as TS3
from tests import torch_port_tiny as tiny


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _flow_apply():
    fcfg = tiny.s3gen()[0]
    return jax.jit(JS.CausalMaskedDiffWithXvec(fcfg).apply)


@functools.lru_cache(maxsize=None)
def _hift_apply():
    hcfg = tiny.s3gen()[1]
    return jax.jit(JS.HiFTGenerator(hcfg).apply)


def test_rel_shift_and_rel_pos_attention_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 7, 13)).astype(np.float32)
    np.testing.assert_array_equal(TS.rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(JS._rel_shift(jnp.asarray(x))))
    np.testing.assert_array_equal(TS.espnet_rel_pos_emb(9, 32), JS.espnet_rel_pos_emb(9, 32))
    fp = tiny.s3gen()[3]
    tm = tiny.s3gen()[6]
    node = fp["encoder"]["encoders_0"]["self_attn"]
    h = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pos = JS.espnet_rel_pos_emb(9, 32)
    ref = JS.RelPosSelfAttention(32, 2).apply({"params": node}, jnp.asarray(h), jnp.asarray(pos))
    with torch.no_grad():
        out = tm.flow.encoder.encoders[0].self_attn(torch.from_numpy(h), torch.from_numpy(pos))
    _close(out, ref, 1e-5)


def test_encoder_and_estimator_match_jax():
    fcfg, _h, _ft, fp, _ht, _hp, tm = tiny.s3gen()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, fcfg.dim)).astype(np.float32)
    ref = jax.jit(JS.UpsampleConformerEncoder(fcfg).apply)({"params": fp["encoder"]},
                                                           jnp.asarray(x))
    with torch.no_grad():
        out = tm.flow.encoder(torch.from_numpy(x))
    assert out.shape == (2, 14, fcfg.dim)
    _close(out, ref, 1e-5)
    t_mel = 14
    args = [rng.standard_normal((2, t_mel, fcfg.mel_dim)).astype(np.float32) for _ in range(2)]
    spks = rng.standard_normal((2, fcfg.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((2, t_mel, fcfg.mel_dim)).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    ref = jax.jit(JS.ConditionalDecoder(fcfg).apply)({"params": fp["decoder"]["estimator"]},
                                                      *map(jnp.asarray, (*args, spks, cond, t)))
    with torch.no_grad():
        out = tm.flow.decoder.estimator(*map(torch.from_numpy, (*args, spks, cond, t)))
    _close(out, ref, 1e-5)


def test_cfm_under_the_fixed_noise_matches_jax():
    """The whole flow (tokens ++ prompt mel, x-vector) from the fixed CFM noise
    of S3Token2Wav, both packages' copies of it identical."""
    fcfg, _h, _ft, fp, _ht, _hp, tm = tiny.s3gen()
    jnoise = JS.S3Token2Wav(fcfg, fp, tiny.s3gen()[1], {}).rand_noise
    np.testing.assert_array_equal(tm.rand_noise.numpy(), jnoise)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 34, (1, 9))          # ids past the vocabulary are clipped
    xvec = rng.standard_normal((1, fcfg.xvector_dim)).astype(np.float32)
    prompt = rng.standard_normal((1, 6, fcfg.mel_dim)).astype(np.float32)
    noise = jnoise[:, :18]
    ref = _flow_apply()({"params": fp}, jnp.asarray(tokens), jnp.asarray(xvec),
                        jnp.asarray(prompt), jnp.asarray(noise))
    with torch.no_grad():
        out = tm.flow(torch.from_numpy(tokens), torch.from_numpy(xvec), torch.from_numpy(prompt),
                      tm.rand_noise[:, :18])
    _close(out, ref, 1e-4)


def test_hift_matches_jax_under_the_jax_draws():
    """HiFT on a mel of 12 frames with the NSF draws of PRNGKey(3); its iSTFT
    spectrum has nonzero imaginary parts at DC and Nyquist (mag sin(sin x)),
    which the JAX matmul iSTFT ignores and the port's real_edges zeroes."""
    _f, hcfg, _ft, _fp, _ht, hp, tm = tiny.s3gen()
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((1, 12, hcfg.in_channels)).astype(np.float32)
    ref = _hift_apply()({"params": hp}, jnp.asarray(mel), jax.random.PRNGKey(3))
    draws = tiny.jax_hift_draws(3, 1, 12 * hcfg.total_upsample, hcfg.nb_harmonics + 1)
    hift = tm.mel2wav
    with torch.no_grad():
        out = hift(torch.from_numpy(mel), source_draws=draws)
        f0 = hift.f0_predictor(torch.from_numpy(mel).transpose(1, 2))
    assert out.shape == (1, 12 * hcfg.total_upsample)
    _close(out, ref, 1e-4)
    jf0 = JS.HiFTGenerator(hcfg).apply({"params": hp}, jnp.asarray(mel),
                                       method=lambda m, x: m.f0_predictor(x))
    _close(f0, jf0, 1e-5)


def test_istft_with_nonzero_edge_imaginary_parts_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 18)).astype(np.float32)
    mag, ph = np.exp(x[..., :9]), np.sin(x[..., 9:])
    real, imag = mag * np.cos(ph), mag * np.sin(ph)
    assert np.abs(imag[..., [0, 8]]).min() > 0
    ref = jax_istft(jnp.asarray(real), jnp.asarray(imag), n_fft=16, hop=4, win_length=16)
    out = TStft.istft(torch.from_numpy(real), torch.from_numpy(imag), n_fft=16, hop=4,
                      win_length=16)
    _close(out, ref, 1e-5)


def test_ref_mel_and_tokens_to_wav_match_jax():
    """s3gen_ref_mel on 0.5 s at 24 kHz, and S3Token2Wav.tokens_to_wav on 3
    prompt tokens with their 6-frame mel and 6 generated tokens, HiFT under
    the JAX keys' draws (the JAX assembly with the jitted flow and HiFT of
    the tests above, at their shapes)."""
    fcfg, hcfg, _ft, fp, _ht, hp, tm = tiny.s3gen()
    rng = np.random.default_rng(5)
    w24 = (0.2 * rng.standard_normal((1, 12000))).astype(np.float32)
    _close(TS.s3gen_ref_mel(torch.from_numpy(w24)), JS.s3gen_ref_mel(w24), 1e-4)
    jeng = JS.S3Token2Wav(fcfg, fp, hcfg, hp)
    jeng.flow = SimpleNamespace(apply=_flow_apply())
    jeng.hift = SimpleNamespace(apply=_hift_apply())
    tokens = rng.integers(0, 30, (1, 9))
    xvec = rng.standard_normal((1, fcfg.xvector_dim)).astype(np.float32)
    prompt = rng.standard_normal((1, 6, fcfg.mel_dim)).astype(np.float32)
    ref = jeng.tokens_to_wav(jnp.asarray(tokens), jnp.asarray(xvec),
                             prompt_mel=jnp.asarray(prompt), seed=6)
    draws = tiny.jax_hift_draws(6, 1, 12 * hcfg.total_upsample, hcfg.nb_harmonics + 1)
    out = tm.tokens_to_wav(tokens, xvec, prompt_mel=prompt, source_draws=draws)
    assert out.shape == (1, 12 * hcfg.total_upsample)
    _close(out, ref, 1e-4)


def test_s3_tokenizer_ids_match_jax():
    """1.1 s of a seeded voice-like signal: the log-mel within 1e-5 of its
    peak, the encoder within 1e-5, the 25 Hz FSQ ids identical (the least
    distance of a pre-rounding value from a rounding boundary is reported
    by the assertion message)."""
    cfg, _tpl, p, tm = tiny.s3tokenizer()
    rng = np.random.default_rng(7)
    t = np.arange(17600) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 170 * t) * (1 + np.sin(2 * np.pi * 3 * t))
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    jmel = JS3.s3_log_mel(wav[None], cfg.n_mels)
    tmel = TS3.s3_log_mel(torch.from_numpy(wav)[None], cfg.n_mels)
    _close(tmel, jmel, 1e-5)
    # tokenize_wav's model call, jitted
    ref = np.asarray(jax.jit(JS3.S3TokenizerV2(cfg).apply)({"params": p}, jmel))
    out = TS3.tokenize_wav(tm, wav)
    with torch.no_grad():
        pre = tm.project(tmel).numpy()
    margin = float(np.abs(np.abs(pre) - 0.5).min())
    assert out.shape == ref.shape == (1, 28)
    assert np.array_equal(out, ref), f"ids differ; least |u| - 0.5 distance {margin:.2e}"


def test_convert_round_trips():
    """The port's state_dicts map back through the JAX converters (the
    ``flow.`` / ``mel2wav.`` prefixes of s3gen.safetensors) onto the trees
    they came from."""
    _f, _h, ftpl, fp, htpl, hp, tm = tiny.s3gen()
    sd = tiny.numpy_state(tm)
    tiny.assert_tree_equal(convert_s3gen_flow(sd, ftpl, prefix="flow."), fp)
    tiny.assert_tree_equal(convert_hift(sd, htpl, prefix="mel2wav."), hp)
    _c, stpl, sp, stm = tiny.s3tokenizer()
    tiny.assert_tree_equal(convert_s3tokenizer(tiny.numpy_state(stm), stpl), sp)
