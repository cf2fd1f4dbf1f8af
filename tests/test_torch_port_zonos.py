"""Parity of the port's Zonos (models/zonos.py, kernels/ssm.py,
models/codecs.py) with the JAX package's, on the CPU, in fp32, at a test
width (tests/torch_port_tiny.py: dim 32, 3 layers with attention at the
third, both mixers).  The JAX side runs as its own tests run it on the CPU
(flash attention through ``attention_reference``).

Tolerances: the SSM's log-depth scan combines in another order than
``lax.associative_scan``, and K2's plain version normalises after the
product where the JAX reference normalises before it, so the float paths
agree to 1e-5 of the largest value, not bit for bit.  Tokens agree exactly:
``jax.random.categorical`` is the argmax of logits plus Gumbel draws, and
the tests hand the port the draws the JAX keys give."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.kernels import ssm as JS
from audiolab_tpu.models import codecs as JC
from audiolab_tpu.models import zonos as JZ
from audiolab_tpu.utils.convert import (
    convert_dac,
    convert_zonos,
    convert_zonos_prefix,
    zonos_mapping,
)
from audiolab_tpu_torch.kernels import ssm as TS
from audiolab_tpu_torch.models import zonos as TZ
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

MIXERS = ("mamba1", "mamba2")


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ------------------------------------------------------------------ ssm

def _ssm_inputs(seed=0, b=2, t=37, d=8, n=4):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)   # noqa: E731
    return dict(u=f(b, t, d), delta=np.abs(f(b, t, d)) * 0.5, a=-np.abs(f(d, n)) - 0.1,
                b=f(b, t, n), c=f(b, t, n), d=f(d), h=f(b, d, n), w=f(4, d), bias=f(d),
                cache=f(b, 3, d))


@pytest.mark.parametrize("fn", ["selective_scan", "ssm_step", "causal_conv1d",
                                "causal_conv1d_step"])
def test_ssm_matches_jax(fn):
    """Each of the four functions to 1e-5 of the largest output."""
    x = _ssm_inputs()
    if fn == "selective_scan":
        args = [x[k] for k in ("u", "delta", "a", "b", "c", "d")]
    elif fn == "ssm_step":
        args = [x["h"], x["u"][:, 0], x["delta"][:, 0], x["a"], x["b"][:, 0], x["c"][:, 0],
                x["d"]]
    elif fn == "causal_conv1d":
        args = [x["u"], x["w"], x["bias"]]
    else:
        args = [x["cache"], x["u"][:, 0], x["w"], x["bias"]]
    ref = jax.jit(getattr(JS, fn))(*map(jnp.asarray, args))
    out = getattr(TS, fn)(*map(_t, args))
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(o.numpy(), r)


def test_selective_scan_state_is_the_last_state():
    x = _ssm_inputs(1, t=5)
    args = [_t(x[k]) for k in ("u", "delta", "a", "b", "c", "d")]
    y, h = TS.selective_scan(*args, return_state=True)
    hs = torch.zeros_like(h)
    for i in range(5):
        hs, _y = TS.ssm_step(hs, *(a[:, i] for a in args[:2]), args[2], args[3][:, i],
                             args[4][:, i], args[5])
    _close(h.numpy(), hs.numpy())
    _close(y.numpy(), TS.selective_scan(*args).numpy(), rel=0)


# ------------------------------------------------------------------ blocks

BLOCKS = {"mamba1": ("mamba1", 0, JZ.MambaBlock), "mamba2": ("mamba2", 0, JZ.Mamba2Block),
          "attn": ("mamba1", 2, JZ.AttnBlock)}


@pytest.mark.parametrize("method", ["call", "prefill", "step"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind, method):
    """``__call__``, ``prefill`` (output and decode state) and three ``step``s
    after it, each to 1e-5 of its largest value."""
    mixer, layer, cls = BLOCKS[kind]
    cfg, p, tm = tiny.zonos(mixer)
    name = f"{'attn' if kind == 'attn' else 'mamba'}_{layer}"
    jb, bp = cls(cfg), {"params": p["backbone"][name]}
    blk = tm.backbone.layers[layer].mixer
    t = 11
    x = np.random.default_rng(3).standard_normal((2, t, cfg.dim)).astype(np.float32)
    steps = np.random.default_rng(4).standard_normal((3, 2, cfg.dim)).astype(np.float32)
    pos = np.arange(t)
    attn = kind == "attn"
    with torch.no_grad():
        if method == "call":
            ref = jb.apply(bp, x, pos) if attn else jb.apply(bp, x)
            _close((blk(_t(x), torch.arange(t)) if attn else blk(_t(x))).numpy(), ref)
            return
        if attn:
            cache_len = t + 5
            q, k, v = jb.apply(bp, x, pos, method=lambda m, x, pos: m._qkv(x, pos))
            ref, ref_state = jb.apply(bp, x, pos), dict(
                k=jnp.zeros((2, cache_len) + k.shape[2:]).at[:, :t].set(k),
                v=jnp.zeros((2, cache_len) + v.shape[2:]).at[:, :t].set(v),
                index=jnp.asarray(t, jnp.int32))
            out, state = blk.prefill(_t(x), torch.arange(t), cache_len)
            ref_parts = [ref_state["k"], ref_state["v"]]
        else:
            ref, ref_state = jb.apply(bp, x, method=cls.prefill)
            out, state = blk.prefill(_t(x))
            ref_parts = list(ref_state)
        if method == "prefill":
            _close(out.numpy(), ref)
            for o, r in zip(state, ref_parts):
                _close(o.numpy(), r)
            return
        for i, s in enumerate(steps):
            if attn:
                ref, ref_state = jb.apply(bp, s, jnp.asarray([t + i]), ref_state,
                                          method=cls.step)
                out = blk.step(_t(s), torch.tensor([t + i]), state)
            else:
                ref, ref_state = jb.apply(bp, s, ref_state, method=cls.step)
                out = blk.step(_t(s), state)
            _close(out.numpy(), ref)
        for o, r in zip(state, [ref_state["k"], ref_state["v"]] if attn else ref_state):
            _close(o.numpy(), r)


def _prefix_inputs(cfg, b=2, t_text=6, seed=5):
    r = np.random.default_rng(seed)
    return dict(text_ids=r.integers(1, cfg.vocab_text, (b, t_text)).astype(np.int32),
                spk=r.standard_normal((b, cfg.spk_dim)).astype(np.float32),
                emotion=r.random((b, 8)).astype(np.float32),
                rate=np.full((b, 1), 15.0, np.float32), pitch=np.full((b, 1), 20.0, np.float32))


@pytest.mark.parametrize("mixer", MIXERS)
def test_backbone_prefill_and_teacher_forced_steps_match_jax(mixer):
    """``prefill`` then 8 decode steps on given codes: logits within 1e-5 of
    max|logit| at every step."""
    cfg, p, tm = tiny.zonos(mixer)
    x = _prefix_inputs(cfg)
    b = x["text_ids"].shape[0]
    cache_len = 6 + 5 + 8 + 2
    bos = np.full((b, cfg.n_codebooks, 1), cfg.masked_id, np.int32)
    jm = JZ.ZonosModel(cfg)
    args = (x["text_ids"], x["spk"], x["emotion"], x["rate"], x["pitch"], bos)
    ref, ref_states, plen = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, cache_len, method=JZ.ZonosModel.prefill))(p, *args)
    step = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=JZ.ZonosModel.decode_step))
    with torch.no_grad():
        out, states, plen_t = tm.prefill(*(_t(a, torch.long if a.dtype == np.int32 else
                                                  torch.float32) for a in args), cache_len)
        assert plen_t == int(plen)
        _close(out.numpy(), ref)
        codes = np.random.default_rng(6).integers(0, cfg.codebook_size - 2,
                                                  (8, b, cfg.n_codebooks))
        for i, ct in enumerate(codes):
            ref, ref_states = step(p, jnp.asarray(ct, jnp.int32), jnp.asarray([plen + i]),
                                   ref_states)
            out = tm.decode_step(torch.from_numpy(ct), torch.tensor([plen_t + i]), states)
            _close(out.numpy(), ref)


def test_full_sequence_backbone_matches_jax():
    """``ZonosBackbone.__call__`` (the full-sequence forward, attention through
    K2's plain version) to 1e-5 of its largest value."""
    cfg, p, tm = tiny.zonos("mamba2")
    x = np.random.default_rng(7).standard_normal((2, 9, cfg.dim)).astype(np.float32)
    ref = jax.jit(JZ.ZonosBackbone(cfg).apply)({"params": p["backbone"]}, x, np.arange(9))
    with torch.no_grad():
        _close(tm.backbone(_t(x), torch.arange(9)).numpy(), ref)


# ------------------------------------------------------------------ sampling

SAMPLERS = {
    "published": dict(cfg_scale=2.0, temperature=1.0, top_k=0, min_p=0.1,
                      repetition_penalty=3.0),
    "top_k": dict(cfg_scale=1.5, temperature=0.7, top_k=5, min_p=0.0,
                  repetition_penalty=1.0),
    "both": dict(cfg_scale=3.0, temperature=1.3, top_k=7, min_p=0.05,
                 repetition_penalty=2.0),
}


@pytest.mark.parametrize("setting", sorted(SAMPLERS))
def test_sample9_matches_jax_tokens(setting):
    """The same logits, window and draws give identical tokens and windows
    (delay masks at steps before q, EOS after max_frames + q)."""
    cfg, _p, _tm = tiny.zonos("mamba1")
    kw, b, max_frames = SAMPLERS[setting], 3, 4
    js, _init = JZ._make_sample9(JZ.ZonosModel(cfg), max_frames, **kw)
    ts = TZ.make_sample9(TZ.ZonosConfig(**tiny.ZONOS), max_frames, **kw)
    r = np.random.default_rng(8)
    window = np.full((b, cfg.n_codebooks, 2), -1, np.int32)
    for step in range(max_frames + cfg.n_codebooks + 1):
        logits = (2.0 * r.standard_normal((2 * b, cfg.n_codebooks, cfg.codebook_size))
                  ).astype(np.float32)
        g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(step),
                                         (b * cfg.n_codebooks, cfg.codebook_size)))
        ref_tok, ref_win = js(jnp.asarray(logits), jax.random.PRNGKey(step), step, window)
        tok, win = ts(_t(logits), _t(g), torch.tensor([step]), _t(window, torch.long))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        np.testing.assert_array_equal(win.numpy(), np.asarray(ref_win))
        window = np.asarray(ref_win)


def test_delay_patterns_match_jax():
    codes = np.random.default_rng(9).integers(0, 30, (2, 3, 7)).astype(np.int32)
    ref = JZ.delay_pattern(jnp.asarray(codes), 33)
    out = TZ.delay_pattern(torch.from_numpy(codes), 33)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(TZ.undelay_pattern(out, 3).numpy(),
                                  np.asarray(JZ.undelay_pattern(ref, 3)))


@pytest.mark.parametrize("mixer", MIXERS)
def test_generate_matches_jax_codes(mixer):
    """``generate`` (prefill, the CFG double batch, 12 frames + the delay
    tail, the published sampling) with the JAX keys' draws injected: the
    codes are JAX's, exactly."""
    cfg, p, tm = tiny.zonos(mixer)
    x = _prefix_inputs(cfg, seed=10)
    kw = dict(max_frames=12, emotion=x["emotion"], rate=x["rate"], pitch=x["pitch"])
    ref = JZ.generate(JZ.ZonosModel(cfg), p, jnp.asarray(x["text_ids"]), jnp.asarray(x["spk"]),
                      rng=jax.random.PRNGKey(3), **kw)
    out = TZ.generate(tm, x["text_ids"], x["spk"], device="cpu",
                      draws=lambda *shape: tiny.jax_draws(3, *shape), **kw)
    assert out.shape == ref.shape == (2, cfg.n_codebooks, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ------------------------------------------------------------------ DAC, speaker

# case: (widths, kernel scale, frames, limit as a fraction of max|y|)
DACS = {
    "published_rates": ({}, 0.5, 5, 1e-5),
    "odd_rates": (dict(rates=(3, 5), decoder_dim=16), 0.5, 5, 1e-5),
    # the filler's full kernel scale: activations near 20 before the tanh,
    # 10 % of the samples clipped.  Both fp32 decoders then sit a few 1e-5
    # from an fp64 evaluation of the same weights, on the CPU: with these
    # codes port 1.9e-05, JAX 2.1e-05, the two 2.2e-05 apart; with another
    # draw 4.8e-05, 3.5e-05 and 3.1e-05.  The limit is twice the largest
    "published_rates_full_scale": ({}, 1.0, 40, 1e-4),
}


@pytest.mark.parametrize("case", sorted(DACS))
def test_dac_decoder_matches_jax(case):
    """codes -> audio through both decoders, and the port's against its own
    fp64 evaluation, within the case's limit of max|y|; the odd rates
    exercise flax's asymmetric transposed-convolution crop."""
    kw, kernel_scale, frames, rel = DACS[case]
    cfg, p, tm = tiny.dac(kernel_scale=kernel_scale, **kw)
    codes = np.random.default_rng(11).integers(0, cfg.codebook_size, (2, cfg.n_q, frames))
    ref = jax.jit(JC.DACDecoder(cfg).apply)({"params": p}, jnp.asarray(codes, jnp.int32))
    with torch.no_grad():
        out = tm(torch.from_numpy(codes))
        exact = copy.deepcopy(tm).double()(torch.from_numpy(codes))
    assert out.shape == (2, frames * cfg.hop)
    _close(out.numpy(), ref, rel)
    _close(out.numpy(), exact.numpy(), rel)


@pytest.mark.parametrize("frames", [20, 21])
def test_speaker_encoder_matches_jax(frames):
    """Even and odd mel lengths (flax SAME padding at stride 2), 1e-5."""
    p, tm = tiny.speaker_encoder()
    mel = np.random.default_rng(12).standard_normal((2, frames, 80)).astype(np.float32)
    ref = jax.jit(JZ.SpeakerEncoder(16).apply)({"params": p}, mel)
    with torch.no_grad():
        _close(tm(_t(mel)).numpy(), ref)


# ------------------------------------------------------------------ weights

def test_zonos_weights_map_back_through_convert_zonos():
    """The port's state_dict, under Zyphra's names, converts back to the same
    flax leaves by ``convert_zonos`` (the hybrid Mamba2 layout the converter
    maps); the conditioners it leaves unmapped keep the JAX tree's names."""
    cfg, p, tm = tiny.zonos("mamba2")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, p)
    back = convert_zonos(sd, zeros, cfg)
    mapped = zonos_mapping(p, cfg)
    flat_p = dict(jax.tree_util.tree_flatten_with_path(p)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_p.keys() == flat_b.keys()
    for path, leaf in flat_p.items():
        name = "/".join(str(k.key) for k in path)
        if name in mapped:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf), name)
        else:
            assert name.split("/")[0] in ("text_emb", "spk_proj", "emotion", "rate", "pitch")
    assert {k.split(".")[0] for k in sd} == {"backbone", "embeddings", "heads", "text_emb",
                                            "spk_proj", "emotion", "rate", "pitch"}


def test_dac_weights_map_back_through_convert_dac():
    cfg, p, tm = tiny.dac()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_dac(sd, p, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ prefix bank

def _cond(dim_speaker: int, seed: int, absent=()) -> dict:
    """A cond dict of the published bank's slots for a batch of 2, leaving
    out ``absent`` (their learned uncond vectors stand in)."""
    r = np.random.default_rng(seed)
    cond = dict(espeak=r.integers(0, JZ.ZONOS_PHONEME_VOCAB, (2, 7)),
                speaker=r.standard_normal((2, 1, dim_speaker)).astype(np.float32),
                emotion=r.random((2, 1, 8)).astype(np.float32),
                fmax=np.full((2, 1, 1), 22050.0, np.float32),
                pitch_std=r.uniform(20, 80, (2, 1, 1)).astype(np.float32),
                speaking_rate=r.uniform(10, 20, (2, 1, 1)).astype(np.float32),
                language_id=np.asarray([[[24]], [[3]]], np.float32))
    return {k: v for k, v in cond.items() if k not in absent}


@functools.lru_cache(maxsize=None)
def _prefix(projection: str, seed: int = 12):
    dim = 32
    jm = JZ.ZonosPrefixConditioner(dim, JZ.DEFAULT_ZONOS_CONDITIONERS, projection)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jax.tree_util.tree_map(
        jnp.asarray, _cond(128, 0))))["params"]
    p = tiny.filled(tpl, seed)
    specs = tuple(TZ.CondSpec(**dataclasses.asdict(s)) for s in JZ.DEFAULT_ZONOS_CONDITIONERS)
    tm = TZ.ZonosPrefixConditioner(dim, specs, projection)
    tm.load_state_dict(W.zonos_prefix_from_jax(p, specs, projection), strict=True)
    return jm, p, tm.eval()


@pytest.mark.parametrize("projection", ["none", "mlp"])
def test_prefix_conditioner_matches_jax(projection):
    """The published bank with every slot given, and with the speaker and
    emotion slots left out (learned uncond vectors), with no bank projection
    and with the MLP one; its state_dict maps back through
    convert_zonos_prefix."""
    jm, p, tm = _prefix(projection)
    for absent in ((), ("speaker", "emotion")):
        cond = _cond(128, 1, absent)
        ref = jm.apply({"params": p}, jax.tree_util.tree_map(jnp.asarray, cond))
        with torch.no_grad():
            out = tm({k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()})
        _close(out.numpy(), ref)
    sd = {f"model.prefix_conditioner.{k}": v.numpy() for k, v in tm.state_dict().items()}
    back = convert_zonos_prefix(sd, p, JZ.DEFAULT_ZONOS_CONDITIONERS, projection, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generate_embedded_matches_jax_codes():
    """``generate_embedded`` from a prefix pair built by the port's bank
    (cond; uncond with every slot but espeak absent) at the model's width:
    the codes are JAX's under its keys' draws."""
    cfg, p, tm = tiny.zonos("mamba1")
    _jm, _pp, bank = _prefix("none")
    cond, uncond = _cond(128, 2), {"espeak": _cond(128, 2)["espeak"]}
    with torch.no_grad():
        x2 = torch.cat([bank({k: torch.from_numpy(np.asarray(v)) for k, v in c.items()})
                        for c in (cond, uncond)])
    ref = JZ.generate_embedded(JZ.ZonosModel(cfg), p, jnp.asarray(x2.numpy()), max_frames=8,
                               rng=jax.random.PRNGKey(4))
    out = TZ.generate_embedded(tm, x2, max_frames=8, device="cpu",
                               draws=lambda *shape: tiny.jax_draws(4, *shape))
    assert out.shape == ref.shape == (2, cfg.n_codebooks, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
