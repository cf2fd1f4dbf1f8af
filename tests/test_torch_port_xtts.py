"""Parity of the port's XTTS (audiolab_tpu_torch/models/{xtts,bigvgan}.py and
the engines and tokenizer of pipelines/tts.py) with the JAX package's on
the CPU, in fp32, at the JAX package's tiny engine widths (GPT-2 2 x 32,
speaker encoder filters 8-64 into 24, HiFi decoder rates 4, 4; the
capability XTTS at dim 32), with seeded weights carried by the
``xtts*_from_jax`` functions and mapped back by the ``convert_xtts_*``
converters.

Tolerances: hidden states, logits and latents within 1e-5 of their max;
waveforms within 1e-4 of the peak; codes identical under the Gumbel draws
that the JAX keys give.  The port's cached decode is held against the JAX
function's full re-forward at every step."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import xtts as JX
from audiolab_tpu.pipelines import tts as JT
from audiolab_tpu.utils import convert as C
from audiolab_tpu_torch.models import xtts as TX
from audiolab_tpu_torch.pipelines import tts as TT
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

DIM, SDIM = 32, 24
GPT = dict(layers=2, dim=DIM, heads=2, n_text=40, n_audio=30, max_text=32, max_mel=64,
           start_text=38, stop_text=0)
COND = dict(dim=DIM, heads=4, blocks=2)
PERC = dict(dim=DIM, depth=1, num_latents=6, heads=2, dim_head=8)
SPK = dict(layers=(1, 1, 1, 1), num_filters=(8, 16, 32, 64), proj_dim=SDIM)
HIFI = dict(input_dim=DIM, cond_dim=SDIM, upsample_rates=(4, 4), upsample_kernels=(8, 8),
            resblock_kernels=(3,), resblock_dilations=((1, 3),), initial_channel=32)
DVAE = dict(num_tokens=16, codebook_dim=8, hidden_dim=8, num_layers=2, num_resnet_blocks=1)


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


def _same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _module(name: str):
    """(JAX module, flax variables, port module) of one XTTS-v2 module."""
    jcls, tcls, kw, args, load = {
        "gpt": (JX.XttsGPT2, TX.XttsGPT2, GPT,
                (jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4), jnp.int32),
                 jnp.zeros((1, 6, DIM))), W.xtts_gpt2_from_jax),
        "cond": (JX.XttsConditioningEncoder, TX.XttsConditioningEncoder, COND,
                 (jnp.zeros((1, 8, 80)),), W.xtts_conditioner_from_jax),
        "perc": (JX.XttsPerceiverResampler, TX.XttsPerceiverResampler, PERC,
                 (jnp.zeros((1, 8, DIM)),), W.xtts_perceiver_from_jax),
        "spk": (JX.XttsSpeakerEncoder, TX.XttsSpeakerEncoder, SPK,
                (jnp.zeros((1, 40, 64)),), None),
        "hifi": (JX.XttsHifiganDecoder, TX.XttsHifiganDecoder, HIFI,
                 (jnp.zeros((1, 4, DIM)), jnp.zeros((1, SDIM))), W.xtts_hifigan_from_jax),
        "dvae": (JX.XttsDVAE, TX.XttsDVAE, DVAE, (jnp.zeros((1, 16, 80)),),
                 W.xtts_dvae_from_jax),
    }[name]
    jm = jcls(**kw)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    jm = tiny.Jitted(jm)
    v = {k: tiny.filled(t, 20 + len(k)) for k, t in tpl.items()}
    tm = tcls(**kw)
    if name == "spk":
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: 0.5 + np.abs(a) if path[-1].key == "var" else a, v["batch_stats"])
        tm.load_state_dict(W.xtts_speaker_from_jax(v["params"], v["batch_stats"]), strict=True)
    else:
        tm.load_state_dict(load(v["params"]), strict=True)
    return jm, v, tm.eval()


def test_gpt2_forward_and_latents_match_jax():
    jm, v, tm = _module("gpt")
    rng = np.random.default_rng(1)
    text, mel = rng.integers(0, 40, (2, 5)), rng.integers(0, 30, (2, 7))
    cond = _rand(2, 6, DIM)
    ref = jm.apply(v, jnp.asarray(text), jnp.asarray(mel), jnp.asarray(cond),
                   return_latents=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(text), torch.from_numpy(mel), torch.from_numpy(cond),
                 return_latents=True)
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("name", ["cond", "perc", "spk", "hifi"])
def test_conditioning_speaker_and_decoder_modules_match_jax(name):
    jm, v, tm = _module(name)
    if name == "cond":
        args = (_rand(2, 20, 80),)
    elif name == "perc":
        args = (_rand(2, 20, DIM),)
    elif name == "spk":
        args = (np.abs(_rand(2, 40, 64)) + 0.01,)
    else:
        args = (_rand(2, 6, DIM), _rand(2, SDIM))
    kw = {"l2_norm": True} if name == "spk" else {}
    ref = jm.apply(v, *map(jnp.asarray, args), **kw)
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, args), **kw)
    _close(out, ref, 1e-4 if name == "hifi" else 1e-5)


def test_dvae_codes_and_mel_match_jax():
    jm, v, tm = _module("dvae")
    mel = _rand(2, 16, 80)
    codes = jm.apply(v, jnp.asarray(mel), method=JX.XttsDVAE.encode)
    with torch.no_grad():
        tcodes = tm.encode(torch.from_numpy(mel))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
        _close(tm.decode(tcodes), jm.apply(v, codes, method=JX.XttsDVAE.decode))


def test_speaker_mel_matches_jax():
    wav = _rand(1, 8000) * 0.1
    _close(TX.speaker_mel(torch.from_numpy(wav)), JX.speaker_mel(jnp.asarray(wav)))


@pytest.mark.parametrize("name,convert,prefix", [
    ("gpt", C.convert_xtts_gpt, "gpt."),
    ("cond", C.convert_xtts_conditioner, "gpt.conditioning_encoder."),
    ("perc", C.convert_xtts_perceiver, "gpt.conditioning_perceiver."),
    ("spk", C.convert_xtts_speaker, "hifigan_decoder.speaker_encoder."),
    ("hifi", C.convert_xtts_hifigan, "hifigan_decoder.waveform_decoder."),
    ("dvae", C.convert_xtts_dvae, "dvae."),
])
def test_state_dict_maps_back_through_the_converter(name, convert, prefix):
    """Each port state_dict, under the checkpoint's prefix, through its
    ``convert_xtts_*`` gives the flax tree it was loaded from."""
    _jm, v, tm = _module(name)
    sd = _sd(tm, prefix)
    if name == "spk":
        _same_tree(convert(sd, v, strict=True), v)
    else:
        _same_tree(convert(sd, v["params"], strict=True), v["params"])


def test_cached_decode_matches_xtts_gpt2_generate():
    """The port's KV-cached decode with one step at a time against the JAX
    function's full re-forward a step: identical codes and lengths under the
    JAX keys' draws, latents within 1e-5.  With stop id 18 the row stops at
    step 5 under these draws, so the hold after the stop and the latents'
    masking past it are exercised."""
    jm, v, tm = _module("gpt")
    text, cond = np.asarray([[3, 9, 14, 2, 27]]), _rand(1, 6, DIM, seed=2)
    steps, seed = 12, 3
    kw = dict(temperature=0.85, top_k=8)
    ref = JX.xtts_gpt2_generate(jm, v["params"], jnp.asarray(text), jnp.asarray(cond), steps,
                                rng=jax.random.PRNGKey(seed), stop_audio=18, **kw)
    draws = tiny.jax_draws(seed, steps, 1, GPT["n_audio"])
    out = TX.xtts_gpt2_generate(tm, text, cond, steps, stop_audio=18,
                                draws=torch.from_numpy(draws), device="cpu", **kw)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert int(out[2][0]) == 5
    _close(out[1], ref[1])


@functools.lru_cache(maxsize=None)
def _checkpoint_engines():
    jeng = JT.XttsCheckpointEngine(*(a for n in ("gpt", "cond", "perc", "spk", "hifi")
                                     for a in _module(n)[:2]))
    jeng.spk_vars = _module("spk")[1]
    for n, attr in (("gpt", "gpt_params"), ("cond", "cond_params"), ("perc", "perc_params"),
                    ("hifi", "dec_params")):
        setattr(jeng, attr, _module(n)[1]["params"])
    teng = TT.XttsCheckpointEngine(*(_module(n)[2] for n in ("gpt", "cond", "perc", "spk",
                                                             "hifi")), device="cpu")
    return jeng, teng


def test_checkpoint_engine_synthesize_matches_jax():
    """conditioning on a 1.5 s reference at 22.05 kHz (one chunk, resampled
    to 16 kHz for the speaker encoder), then 10 decode steps and the HiFi
    decoder."""
    jeng, teng = _checkpoint_engines()
    t = np.arange(33075) / 22050
    ref = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    ref = ref.astype(np.float32)
    y_jax, sr = jeng.synthesize("hello", ref_wav=ref, ref_sr=22050, max_steps=10, seed=4)
    draws = tiny.jax_draws(4, 10, 1, GPT["n_audio"])
    y, tsr = teng.synthesize("hello", ref_wav=ref, ref_sr=22050, max_steps=10,
                             draws=torch.from_numpy(draws))
    assert sr == tsr == 24000
    _close(y, y_jax, 1e-4)


def test_long_text_overruns_the_jax_text_positions_not_the_port():
    """A text of max_text bytes or more: the JAX engine cuts at max_text - 1
    and the [START]/[STOP] wrap makes max_text + 1 positions, one past the
    learned text positions, so it fails; the port cuts at max_text - 2
    (ROADMAP queue 3)."""
    jeng, teng = _checkpoint_engines()
    text = "x" * (GPT["max_text"] + 8)
    cond, dvec = _rand(1, 6, DIM, seed=7), _rand(1, SDIM, seed=8)
    with pytest.raises((TypeError, ValueError)):
        jeng.synthesize(text, cond=jnp.asarray(cond), d_vector=jnp.asarray(dvec), max_steps=4)
    y, sr = teng.synthesize(text, cond=torch.from_numpy(cond), d_vector=torch.from_numpy(dvec),
                            max_steps=4)
    assert sr == 24000 and len(teng.tokenize(text)) == GPT["max_text"] - 2
    assert np.isfinite(y).all()


# ------------------------------------------------------ the capability XTTS

def test_capability_xtts_tts_matches_jax():
    """``XTTS.tts``: the reference's conditioning, the GPT prefilled through
    its cache, 10 decode steps (top-k 50 at temperature 0.75, the stop token
    held) and BigVGAN, against the JAX engine under its keys' draws."""
    jx, tx = tiny.xtts()
    t = np.arange(12000) / 24000
    ref = (0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    y_jax, sr = jx.tts("hi you", ref, 24000, max_codes=10, seed=6)
    draws = tiny.jax_draws(6, 10, 1, tx.cfg.audio_vocab)
    y, tsr = tx.tts("hi you", ref, 24000, max_codes=10, draws=torch.from_numpy(draws))
    assert sr == tsr == 24000
    _close(y, y_jax, 1e-4)


def test_random_engines_run_on_the_cpu():
    """The demo engines build on the CPU when asked and synthesize finite
    audio (the speech routes' ``coqui`` engine and the tiny XTTS-v2)."""
    eng = TT.random_xtts(device="cpu")
    wav, sr = eng.generate("hi", seed=1)                  # 18 codes a word
    assert sr == 24000 and wav.shape == (18 * 256,) and np.isfinite(wav).all()
    ck = TT.random_xtts_checkpoint(device="cpu")
    ck.register_voice("v", (0.2 * np.sin(np.arange(16000) / 9)).astype(np.float32), 16000)
    wav, sr = ck.generate("hi")
    assert sr == 24000 and np.isfinite(wav).all()


# ------------------------------------------------------------- tokenizer

def _vocab_json(tmp_path, whitespace: bool):
    chars = list("helowrdtynisamcgux fv")
    vocab = {t: i for i, t in enumerate(["[STOP]", "[UNK]", "[SPACE]", "[en]"] + chars
                                        + ["he", "ll", "hell", "lo", "wo"])}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for t in ("[STOP]", "[UNK]", "[SPACE]", "[en]")],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"} if whitespace else None,
        "post_processor": None, "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "vocab": vocab,
                  "merges": ["h e", "l l", "he ll", "l o", "w o"]},
    }
    path = tmp_path / f"vocab_{int(whitespace)}.json"
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.mark.parametrize("whitespace", [False, True])
def test_tokenizer_matches_the_jax_tokenizer(tmp_path, whitespace):
    """The port's BPE against the JAX tokenizer (the ``tokenizers`` library)
    on a toy vocabulary with merges: English cleaning (numbers,
    abbreviations, symbols), unknown characters, decode."""
    path = _vocab_json(tmp_path, whitespace)
    jt, tt = JT.XttsTokenizer(path), TT.XttsTokenizer(path)
    for text in ("Hello world", "Dr. who saw 10 cats & 21 dogs!", "hell, yellow: wow?",
                 "Mr. Lowe 2036"):
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids) == jt.decode(ids)
    assert TT._int_words(2036) == JT._int_words(2036) == "two thousand thirty six"
