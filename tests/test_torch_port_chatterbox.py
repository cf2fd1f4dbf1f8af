"""The port's Chatterbox T3, voice encoder and engine (models/chatterbox_t3.py,
pipelines/tts.py) against the JAX package's, on the CPU, at the JAX engine
test's tiny widths (T3 2 x 32, 4 heads, perceiver 4 tokens; the voice
encoder at its published widths), with seeded weights carried by
``chatterbox_t3_from_jax`` / ``voice_encoder_from_jax``.

Tolerances: fp32 logits within 1e-5 of max|logit|, embeddings within 1e-5,
mels and waveforms within 1e-4 of the peak; T3's codes identical under the
JAX keys' draws wherever the JAX decode's positions are right (no prompt,
or a prompt of exactly ``perceiver_tokens``).  With a longer prompt the
JAX decode rotates its steps past the context (ROADMAP queue 3); the
position test shows it and the port's repair."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import chatterbox_t3 as JT3
from audiolab_tpu.pipelines import tts as JT
from audiolab_tpu.utils.convert import convert_chatterbox_t3, convert_voice_encoder
from audiolab_tpu_torch.models import chatterbox_t3 as TT3
from audiolab_tpu_torch.pipelines import tts as TT
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _apply():
    """The JAX T3's teacher-forced forward, prefill and step, jitted."""
    cfg = tiny.chatterbox_t3()[0]
    m = JT3.T3(cfg, max_seq_len=256)
    return (jax.jit(m.apply), jax.jit(functools.partial(m.apply, method=JT3.T3.prefill)),
            jax.jit(functools.partial(m.apply, method=JT3.T3.step)))


def _inputs(seed: int, n_prompt: int | None, n_text: int = 7, n_speech: int = 9):
    cfg = tiny.chatterbox_t3()[0]
    rng = np.random.default_rng(seed)
    text = rng.integers(1, cfg.text_vocab, (1, n_text))
    speech = rng.integers(0, 30, (1, n_speech))
    speech[:, 0] = cfg.start_speech_token
    spk = rng.standard_normal((1, cfg.speaker_embed_size)).astype(np.float32)
    prompt = None if n_prompt is None else rng.integers(0, 30, (1, n_prompt))
    return text, speech, spk, prompt, np.asarray([0.7], np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def test_perceiver_and_cond_enc_match_jax():
    cfg, _tpl, p, tm = tiny.chatterbox_t3()
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((2, 11, cfg.dim)).astype(np.float32)
    ref = JT3.PerceiverResampler(cfg).apply({"params": p["cond_enc"]["perceiver"]},
                                            jnp.asarray(ctx))
    with torch.no_grad():
        out = tm.cond_enc.perceiver(torch.from_numpy(ctx))
    assert out.shape == (2, cfg.perceiver_tokens, cfg.dim)
    _close(out, ref, 1e-5)
    spk = rng.standard_normal((2, cfg.speaker_embed_size)).astype(np.float32)
    emo = np.asarray([0.3, 0.9], np.float32)
    for prompt, e in ((ctx, emo), (None, None)):
        ref = JT3.T3CondEnc(cfg).apply({"params": p["cond_enc"]}, jnp.asarray(spk),
                                       None if prompt is None else jnp.asarray(prompt),
                                       None if e is None else jnp.asarray(e))
        with torch.no_grad():
            out = tm.cond_enc(*_t(spk, prompt, e))
        _close(out, ref, 1e-5)


def test_t3_forward_prefill_and_step_match_jax():
    """The teacher-forced forward with a prompt (text and speech logits), and
    without one the prefill at BOS and a cached step (where the JAX
    position is the context length)."""
    cfg, _tpl, p, tm = tiny.chatterbox_t3()
    fwd, prefill, step = _apply()
    text, speech, spk, prompt, emo = _inputs(1, n_prompt=6)
    rt, rs = fwd({"params": p}, *map(jnp.asarray, (text, speech, spk, prompt, emo)))
    with torch.no_grad():
        ot, os_ = tm(*_t(text, speech, spk, prompt, emo))
    _close(ot, rt, 1e-5)
    _close(os_, rs, 1e-5)
    text, speech, spk, _prompt, emo = _inputs(2, n_prompt=None)
    n_ctx = 2 + text.shape[1] + 1
    jcache = JT3.t3_init_cache(cfg, 1, n_ctx + 4)
    rl, jcache, ctx = prefill({"params": p}, jnp.asarray(text), jnp.asarray(spk), None,
                              jnp.asarray(emo), jcache)
    rstep, _ = step({"params": p}, jnp.asarray(speech[:, 1:2]), 1,
                    jnp.full((1,), n_ctx, jnp.int32), jcache)
    tcache = TT3.t3_init_cache(tm.cfg, 1, n_ctx + 4)
    with torch.no_grad():
        ol, tctx = tm.prefill(*_t(text, spk), None, torch.from_numpy(emo), tcache)
        one = torch.ones(1, dtype=torch.long)
        ostep = tm.step(torch.from_numpy(speech[:, 1:2]), one, tctx - 1 + one, tcache)
    assert tctx == int(ctx) == n_ctx
    _close(ol, rl, 1e-5)
    _close(ostep, rstep, 1e-5)


@pytest.mark.parametrize("n_prompt", [None, 4], ids=["no_prompt", "perceiver_tokens"])
def test_t3_generate_codes_match_jax(n_prompt):
    """t3_generate's codes under the JAX keys' draws: 14 new tokens, CFG 0.5,
    temperature 0.8, top-p 0.8, repetition penalty 1.2."""
    cfg, _tpl, p, tm = tiny.chatterbox_t3()
    text, _s, spk, prompt, _e = _inputs(3, n_prompt=n_prompt)
    ids = np.concatenate([[[cfg.start_text_token]], text, [[cfg.stop_text_token]]], axis=1)
    ref = JT3.t3_generate(cfg, p, ids.astype(np.int32), spk[0], prompt_tokens=prompt,
                          emotion_adv=0.6, max_new_tokens=14, seed=5)
    out = TT3.t3_generate(tm, ids, spk[0], prompt_tokens=prompt, emotion_adv=0.6,
                          max_new_tokens=14,
                          draws=tiny.jax_t3_draws(5, 14, cfg.speech_vocab), device="cpu")
    assert out.dtype == np.int32 and ref.shape[1] >= 3
    np.testing.assert_array_equal(out, ref)


def test_t3_decode_position_fault():
    """A 25-token prompt (the tiny config's perceiver takes 4 rows): the JAX
    decode's first step, at its rotary position 2 + 25 + n_text + 1, departs
    from the JAX teacher-forced forward at the same token, and agrees with it
    at the prefill's context length; the port's cached decode agrees with
    its own forward over a whole stream."""
    cfg, _tpl, p, tm = tiny.chatterbox_t3()
    fwd, prefill, step = _apply()
    text, speech, spk, prompt, emo = _inputs(4, n_prompt=25)
    _rt, rs = fwd({"params": p}, *map(jnp.asarray, (text, speech[:, :2], spk, prompt, emo)))
    ref = np.asarray(rs)[:, 1]
    seq_len = 2 + 25 + text.shape[1] + 1
    jcache = JT3.t3_init_cache(cfg, 1, seq_len + 4)
    _l, jcache, ctx = prefill({"params": p}, *map(jnp.asarray, (text, spk, prompt, emo)),
                              jcache)
    assert int(ctx) == seq_len - 21
    lg = {}
    for name, pos in (("jax", seq_len), ("context", int(ctx))):
        lg[name], _ = step({"params": p}, jnp.asarray(speech[:, 1:2]), 1,
                           jnp.full((1,), pos, jnp.int32), jcache)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(lg["jax"])[:, 0] - ref).max() > 1e-2 * scale
    np.testing.assert_allclose(np.asarray(lg["context"])[:, 0], ref, atol=1e-5 * scale, rtol=0)
    with torch.no_grad():
        _ot, os_ = tm(*_t(text, speech, spk, prompt, emo))
        cached = TT3.t3_cached_logits(tm, text, speech[:, 1:], *_t(spk, prompt, emo))
    _close(cached, os_, 1e-5)


def test_voice_encoder_and_utterance_embedding_match_jax():
    """VoiceEncoderConfig() (3 x 256 LSTM over 40 mels): the encoder on 2 x 30
    frames, and the utterance embedding of 2.5 s at 16 kHz (three partial
    windows)."""
    _tpl, p, tm = tiny.voice_encoder()
    jm = tiny.Jitted(JT3.VoiceEncoder())
    rng = np.random.default_rng(6)
    mels = rng.standard_normal((2, 30, 40)).astype(np.float32)
    ref = jm.apply({"params": p}, jnp.asarray(mels))
    with torch.no_grad():
        out = tm(torch.from_numpy(mels))
    _close(out, ref, 1e-5)
    wav = (0.3 * np.sin(2 * np.pi * 190 * np.arange(40000) / 16000)
           + 0.05 * rng.standard_normal(40000)).astype(np.float32)
    ref = JT3.utterance_embedding(lambda m: jm.apply({"params": p}, m), wav, 16000)
    out = TT3.utterance_embedding(tm, wav, 16000)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _engines():
    """(JAX engine, port engine) with the encoders (torch_port_tiny)."""
    return tiny.chatterbox_engines(encoders=True)


@pytest.fixture(scope="module")
def jitted_encoders():
    """The JAX engine's conditioning calls campplus_xvector and tokenize_wav,
    which apply their flax modules op by op (seconds on the CPU): here the
    same functions with the module calls jitted."""
    from audiolab_tpu.kernels.kaldi import kaldi_fbank
    from audiolab_tpu.models import campplus as JCp
    from audiolab_tpu.models import s3tokenizer as JS3

    cp_apply = jax.jit(JCp.CAMPPlus(tiny.campplus()[0]).apply)
    st_apply = jax.jit(JS3.S3TokenizerV2(tiny.s3tokenizer()[0]).apply)

    def campplus_xvector(params, wav16k, cfg):
        feat = kaldi_fbank(jnp.asarray(wav16k, jnp.float32)[None], n_mels=cfg.feat_dim)
        feat = feat - jnp.mean(feat, axis=1, keepdims=True)
        return np.asarray(cp_apply({"params": params}, feat)[0])

    def tokenize_wav(params, wav16k, cfg):
        mel = JS3.s3_log_mel(np.asarray(wav16k, np.float32)[None], cfg.n_mels)
        return np.asarray(st_apply({"params": params}, mel), np.int32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCp, "campplus_xvector", campplus_xvector)
        mp.setattr(JS3, "tokenize_wav", tokenize_wav)
        yield


def _reference(seconds: float, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * 170 * t) * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def test_engine_conditioning_and_synthesize_match_jax(jitted_encoders):
    """conditioning on a 0.16 s reference at 16 kHz (4 S3 tokens, the
    perceiver's 4 rows: the JAX decode's positions are right), then
    synthesize by cloning from it under the JAX keys' draws for T3 and
    HiFT.  The builtin-voice path (no reference, no prompt) runs in the port
    alone here: its T3 codes are held by the generate test above, its flow
    without a prompt by test_torch_port_s3gen.py."""
    j, t = _engines()
    ref = _reference(0.16)
    jspk, jrd = j.conditioning(ref, 16000)
    tspk, trd = t.conditioning(ref, 16000)
    np.testing.assert_allclose(tspk, jspk, atol=1e-5, rtol=0)
    np.testing.assert_allclose(trd["ref_xvector"], jrd["ref_xvector"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(trd["ref_tokens"], jrd["ref_tokens"])
    assert trd["ref_tokens"].shape == (1, 4) and trd["ref_mel"].shape == (1, 8, 8)
    _close(trd["ref_mel"], jrd["ref_mel"], 1e-4)
    c, hcfg = t.t3.cfg, t.s3gen.hift_cfg
    per_token = 2 * hcfg.total_upsample
    # the tiny T3 takes an 8-d speaker embedding: the first 8 of the 256
    jw, jsr = j.synthesize("clone me, please", speaker_emb=(jspk[:8], jrd), max_tokens=10,
                           seed=3)
    tw, tsr = t.synthesize("clone me, please", speaker_emb=(tspk[:8], trd), max_tokens=10,
                           draws=tiny.jax_t3_draws(3, 10, c.speech_vocab),
                           source_draws=tiny.jax_hift_draws(3, 1, len(jw),
                                                            hcfg.nb_harmonics + 1),
                           timed=True)
    assert tsr == jsr == 24000 and len(jw) >= per_token and len(jw) % per_token == 0
    _close(tw, jw, 1e-4)
    assert t.last_stats["tokens"] == 4 + len(jw) // per_token
    bw, _sr = t.synthesize("a builtin voice", max_tokens=10, seed=4)
    assert len(bw) % per_token == 0 and 0 < len(bw) <= 11 * per_token
    assert np.isfinite(bw).all()


def test_engine_conditioning_on_a_long_reference_matches_jax(jitted_encoders):
    """1.5 s at 22.05 kHz (host resampling to 16 and 24 kHz): the speaker
    embedding, x-vector, S3 tokens and prompt mel as the JAX engine's."""
    j, t = _engines()
    ref = _reference(1.5 * 22050 / 16000, seed=8)
    jspk, jrd = j.conditioning(ref, 22050)
    tspk, trd = t.conditioning(ref, 22050)
    # utterance_embedding resamples 22.05 -> 16 kHz on the device in both
    # packages (the JAX resample's last sample is off at some lengths,
    # ROADMAP queue 3): held to 1e-4
    np.testing.assert_allclose(tspk, jspk, atol=1e-4, rtol=0)
    np.testing.assert_allclose(trd["ref_xvector"], jrd["ref_xvector"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(trd["ref_tokens"], jrd["ref_tokens"])
    _close(trd["ref_mel"], jrd["ref_mel"], 1e-4)


def test_punc_norm_and_tokenizer_match_jax(tmp_path):
    """chatterbox_punc_norm, and ChatterboxTokenizer on a toy BPE
    tokenizer.json written here (a [SPACE] token and a few merges)."""
    for text in ("hello world", "Hi there!", "a…b", "", "x: y; z — w “q”"):
        assert TT.chatterbox_punc_norm(text) == JT.chatterbox_punc_norm(text)
    vocab = {"[UNK]": 0, "[SPACE]": 1}
    for ch in "abcdefghijklmnopqrstuvwxyzHW.,!":
        vocab[ch] = len(vocab)
    merges = ["h e", "l l", "he ll", "o r", "w or"]
    for m in merges:
        vocab[m.replace(" ", "")] = len(vocab)
    spec = {"version": "1.0", "added_tokens": [
        {"id": 1, "content": "[SPACE]", "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}],
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
        "decoder": None, "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                                   "continuing_subword_prefix": None,
                                   "end_of_word_suffix": None, "fuse_unk": False,
                                   "vocab": vocab, "merges": merges}}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    jt, tt = JT.ChatterboxTokenizer(str(path)), TT.ChatterboxTokenizer(str(path))
    for text in ("hello world.", "Hello, world!", "well, who?"):
        norm = TT.chatterbox_punc_norm(text)
        assert tt.encode(norm) == jt.encode(norm) and len(tt.encode(norm)) > 3


def test_convert_round_trips():
    """The port's T3 and voice encoder state_dicts (t3_cfg.safetensors' and
    ve.safetensors' names) map back through the JAX converters onto the
    trees they came from."""
    _cfg, tpl, p, tm = tiny.chatterbox_t3()
    sd = tiny.numpy_state(tm)
    assert "tfmr.layers.0.self_attn.q_proj.weight" in sd and "tfmr.norm.weight" in sd
    tiny.assert_tree_equal(convert_chatterbox_t3(sd, tpl), p)
    tpl, p, tm = tiny.voice_encoder()
    tiny.assert_tree_equal(convert_voice_encoder(tiny.numpy_state(tm), tpl), p)
