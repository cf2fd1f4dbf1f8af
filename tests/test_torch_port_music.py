"""The port's music slice against the JAX package on the CPU: T5 and UMT5
(with ``q_tau``), the seconds ``NumberEmbedder``, both Oobleck decoders at
every stride of (2, 4, 4, 8, 8) and the encoder, the shared ``DiT`` in fp32
and in bf16 (with ``return_hidden_at``), the stable-audio-open DiT, the
DPM++ 3M SDE and v-DDIM samplers under JAX's draws, ``generate_audio``,
``variations``, ``continue_audio`` and ``StableAudioCheckpointPipeline.
generate`` end to end.

Weights: flax trees of ``jax.eval_shape`` templates filled with seeded
numbers (``tests/torch_port_tiny.py::filled``), carried into the port by
``utils/weights.py``; the JAX converters map the port's ``state_dict``s back
to the same trees.  Draws: the JAX keys' normals, handed to the port.

Tolerances: fp32 outputs to 1e-5 of the output's max|y| (sums in another
order); the bf16 DiT to 2e-2 of its max|y| against JAX's bf16 path (JAX
rounds the attention scores to bf16 before the softmax, K2 keeps them
fp32; bf16 products in another order), with the fp32 case the tight gate;
end-to-end audio to 1e-4 of its max|y| (a sampler's steps and the decoder
compound fp32 differences).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import dit as JD
from audiolab_tpu.models import ksampler as JK
from audiolab_tpu.models import stable_audio as JS
from audiolab_tpu.models import stable_audio_dit as JSD
from audiolab_tpu.models import t5 as JT
from audiolab_tpu.pipelines import music as JM
from audiolab_tpu.utils.convert import (
    convert_oobleck,
    convert_sao_dit,
    convert_sao_number,
    convert_t5,
)
from audiolab_tpu_torch.models import dit as TD
from audiolab_tpu_torch.models import ksampler as TK
from audiolab_tpu_torch.models import stable_audio as TS
from audiolab_tpu_torch.models import stable_audio_dit as TSD
from audiolab_tpu_torch.models import t5 as TT
from audiolab_tpu_torch.pipelines import music as TM
from audiolab_tpu_torch.utils import spm as TSpm
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(16)
T5_TINY = dict(vocab_size=40, dim=32, d_kv=8, heads=4, d_ff=48, layers=2)
DIT_TINY = dict(dim=32, n_layers=3, n_heads=2, cond_dim=24, in_dim=8, out_dim=8)
SAO_TINY = dict(io_channels=8, embed_dim=128, depth=2, num_heads=2, cond_token_dim=64,
                global_cond_dim=128)
CKPT_VAE = dict(out_channels=2, channels=4, latent_dim=8, c_mults=(1, 2, 2, 4, 4),
                strides=(2, 4, 4, 8, 8))
SA_CFG = dict(sr=8192, max_seconds=4.0, text_dim=32, text_layers=1)
SA_VAE = dict(channels=2, latent_dim=8, base_ch=4, ratios=(2, 4, 4, 8, 8))
STEPS = 4


def close(got, want, tol: float, what: str = ""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def tree_equal(a, b):
    tiny.assert_tree_equal(jax.tree_util.tree_map(np.asarray, a),
                           jax.tree_util.tree_map(np.asarray, b))


def built(jm, port_cls, from_jax, seed, *init_args, **init_kw):
    """(flax template, filled params, port module loaded from them)."""
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *init_args, **init_kw))["params"]
    p = tiny.filled(tpl, seed)
    return tpl, p, tiny._load(port_cls(), from_jax(p))


def tamed_oobleck(params):
    """An Oobleck tree (or a tree holding one) with each residual unit's last
    convolution scaled by 0.1.  With every kernel at N(0, 1/fan_in) the 15
    residual units double the variance each, the activations reach ~100 and
    the snakes' sin^2(e^a x) turns a 2e-6 difference of the latents into
    1e-3 of the audio (either package against an fp64 run: 1e-4 on the same
    latents); at 0.1 the activations stay near 1."""
    def leaf(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        return x * np.float32(0.1) if keys[-2:] == ["c2", "kernel"] else x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ------------------------------------------------------------------ T5


@pytest.mark.parametrize("umt5", [False, True])
def test_t5_encoder_matches_jax(umt5):
    """T5 (shared relative bias, ReLU FFN) and UMT5 (per-layer bias, gated
    GELU) with a padding mask and ``q_tau`` on layer 1, 1e-5 of max|y|; the
    JAX converter maps the port's state_dict back to the flax tree."""
    cfg = dict(T5_TINY, gated=umt5, per_layer_bias=umt5)
    jm = JT.T5Encoder(JT.T5Config(**cfg))
    ids = RNG.integers(0, 40, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    tpl, p, tm = built(jm, lambda: TT.T5Encoder(TT.T5Config(**cfg)), W.t5_from_jax, 3,
                       jnp.zeros((1, 8), jnp.int32))
    for kw in ({}, {"q_tau": 0.01, "q_tau_layers": (1,)}):
        want = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask), **kw)
        with torch.no_grad():
            got = tm(_t(ids, torch.long), _t(mask, torch.long), **kw)
        close(got, want, 1e-5, f"umt5={umt5} {kw}")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    tree_equal(convert_t5(sd, tpl), p)


def test_number_embedder_matches_jax():
    jm = JS.NumberEmbedder(features=32)
    tpl, p, tm = built(jm, lambda: TS.NumberEmbedder(features=32),
                       W.number_embedder_from_jax, 4, jnp.zeros((1,)))
    x = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    with torch.no_grad():
        close(tm(_t(x)), jm.apply({"params": p}, jnp.asarray(x)), 1e-5)
    sd = {f"embedder.{k}": v.numpy() for k, v in tm.state_dict().items()}
    tree_equal(convert_sao_number(sd, tpl, "seconds_start"), p)


# ------------------------------------------------------------------ Oobleck


def test_checkpoint_oobleck_decoder_matches_jax():
    """stable-audio-open's decoder layout at every stride of (2, 4, 4, 8, 8)
    (the transposed convolutions' SAME crop) at :func:`tamed_oobleck`'s
    weights, against JAX and against the port in fp64, 1e-5 of max|y|."""
    cfg = dict(CKPT_VAE)
    jm = JSD.OobleckDecoder(JSD.OobleckConfig(**cfg))
    tpl, p, tm = built(jm, lambda: TSD.OobleckDecoder(TSD.OobleckConfig(**cfg)),
                       lambda p: W.sao_oobleck_from_jax(tamed_oobleck(p)), 5,
                       jnp.zeros((1, 3, 8)))
    p = tamed_oobleck(p)
    z = RNG.standard_normal((1, 3, 8)).astype(np.float32)
    with torch.no_grad():
        got = tm(_t(z))
        exact = tm.double()(_t(z, torch.float64))
    tm.float()
    want = jm.apply({"params": p}, jnp.asarray(z))
    assert got.shape == (1, 2, 3 * 2048)
    close(got, exact, 1e-5, "fp32 against fp64")
    close(got, want, 1e-5, "against JAX")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    tree_equal(convert_oobleck(sd, tpl), p)


def test_in_repo_oobleck_matches_jax():
    """The in-repo VAE: the encoder's strided SAME convolutions and the
    decoder's transposed ones at every stride of (2, 4, 4, 8, 8)."""
    cfg = JS.OobleckConfig(**SA_VAE)
    x = (0.3 * RNG.standard_normal((1, 2 * 2048, 2))).astype(np.float32)
    enc = JS.OobleckEncoder(cfg)
    tpl, p, tm = built(enc, lambda: TS.OobleckEncoder(TS.OobleckConfig(**SA_VAE)),
                       functools.partial(W.stable_audio_from_jax), 6, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    for g, w, name in zip(got, enc.apply({"params": p}, jnp.asarray(x)), ("mean", "logvar")):
        close(g, w, 1e-5, name)
    dec = JS.OobleckDecoder(cfg)
    z = RNG.standard_normal((1, 3, 8)).astype(np.float32)
    tpl, p, tm = built(dec, lambda: TS.OobleckDecoder(TS.OobleckConfig(**SA_VAE)),
                       W.stable_audio_from_jax, 7, jnp.asarray(z))
    with torch.no_grad():
        close(tm(_t(z)), dec.apply({"params": p}, jnp.asarray(z)), 1e-5)


# ------------------------------------------------------------------ DiT


@functools.lru_cache(maxsize=None)
def dit_pair(dtype: str):
    cfg = dict(DIT_TINY, dtype=dtype)
    jm = JD.DiT(JD.DiTConfig(**cfg))
    tpl, p, tm = built(jm, lambda: TD.DiT(TD.DiTConfig(**cfg), global_dim=12), W.dit_from_jax,
                       8, jnp.zeros((1, 4, 8)), jnp.zeros((1,)), jnp.zeros((1, 3, 24)),
                       jnp.ones((1, 3)), jnp.zeros((1, 12)))
    return jm, p, tm


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_dit_matches_jax(dtype, tol):
    """The DiT over 136 latent frames (K2's plain version on the port's side:
    over 128 keys), a masked 5-token context, a global conditioning vector,
    and the hidden states after block 1."""
    jm, p, tm = dit_pair(dtype)
    x = RNG.standard_normal((2, 136, 8)).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    ctx = RNG.standard_normal((2, 5, 24)).astype(np.float32)
    cmask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32)
    g = RNG.standard_normal((2, 12)).astype(np.float32)
    want, want_h = jm.apply({"params": p}, *map(jnp.asarray, (x, t, ctx, cmask, g)),
                            return_hidden_at=1)
    with torch.no_grad():
        got, got_h = tm(_t(x), _t(t), _t(ctx), _t(cmask, torch.long), _t(g),
                        return_hidden_at=1)
    close(got, want, tol, "out")
    close(got_h, want_h, tol, "hidden")
    assert got.dtype == torch.float32 and got_h.dtype == torch.float32


# ------------------------------------------------------------------ SAO DiT


@functools.lru_cache(maxsize=None)
def sao_pair():
    jm = JSD.StableAudioDiT(JSD.SAODiTConfig(**SAO_TINY))
    tpl, p, tm = built(jm, lambda: TSD.StableAudioDiT(TSD.SAODiTConfig(**SAO_TINY)),
                       W.sao_dit_from_jax, 9, jnp.zeros((1, 8, 8)), jnp.zeros((1,)),
                       jnp.zeros((1, 4, 64)), jnp.zeros((1, 128)))
    return jm, tpl, p, tm


def test_sao_dit_matches_jax():
    """The prepended global token, the partial rope (32 of 64 head dims), the
    repeated cross K/V heads, 1e-5 of max|y|; ``convert_sao_dit`` maps the
    port's state_dict (under the checkpoint's ``model.model.`` prefix) back."""
    jm, tpl, p, tm = sao_pair()
    x = RNG.standard_normal((2, 20, 8)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    ctx = RNG.standard_normal((2, 6, 64)).astype(np.float32)
    g = RNG.standard_normal((2, 128)).astype(np.float32)
    want = jm.apply({"params": p}, *map(jnp.asarray, (x, t, ctx, g)))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(ctx), _t(g))
    close(got, want, 1e-5)
    sd = {f"model.model.{k}": v.numpy() for k, v in tm.state_dict().items()}
    tree_equal(convert_sao_dit(sd, tpl), p)


def test_partial_rope_rotates_half_the_head():
    x = torch.from_numpy(RNG.standard_normal((1, 2, 7, 64)).astype(np.float32))
    got = TSD._partial_rope(x)
    close(got, JSD._partial_rope(jnp.asarray(x.numpy())), 1e-6)
    assert torch.equal(got[..., 32:], x[..., 32:])


# ------------------------------------------------------------------ samplers


def jax_sde_draws(key, steps: int, shape) -> np.ndarray:
    """The SDE normals ``sample_dpmpp_3m_sde`` draws from ``key``: one split
    a step."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, shape)))
    return np.stack(out)


def test_dpmpp_3m_sde_matches_jax():
    """Four steps of DPM++ 3M SDE (every history order, the sigma = 0 last
    step) with a denoiser both packages compute alike, under JAX's draws."""
    sig = JK.sigmas_polyexponential(STEPS, 0.3, 500.0)
    np.testing.assert_array_equal(TK.sigmas_polyexponential(STEPS, 0.3, 500.0), np.asarray(sig))
    w = RNG.standard_normal((6, 6)).astype(np.float32) / 6
    x = (RNG.standard_normal((1, 5, 6)) * float(sig[0])).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JK.sample_dpmpp_3m_sde(lambda x, s: jnp.tanh(x @ w) / (1 + s), jnp.asarray(x), sig,
                                  eta=1.0, rng=key)
    draws = torch.from_numpy(jax_sde_draws(key, STEPS, (1, 5, 6)))
    got = TK.sample_dpmpp_3m_sde(lambda x, s: torch.tanh(x @ torch.from_numpy(w)) / (1 + s),
                                 _t(x), sig, eta=1.0, draws=draws)
    close(got, want, 1e-5)
    assert np.isfinite(np.asarray(want)).all()


def test_v_denoiser_matches_jax():
    x = RNG.standard_normal((1, 3, 4)).astype(np.float32)
    for s in (0.3, 2.0, 500.0):
        want = JK.v_denoiser(lambda x, t: x * t + 1.0)(jnp.asarray(x), jnp.float32(s))
        got = TK.v_denoiser(lambda x, t: x * t + 1.0)(_t(x), s)
        close(got, want, 1e-6, f"sigma {s}")


# ------------------------------------------------------------------ Stable Audio


@functools.lru_cache(maxsize=None)
def stable_audio_pair():
    """(JAX StableAudioPipeline with a jitted model, port pipeline on the CPU)
    on the same filled weights."""
    jcfg = JS.StableAudioConfig(vae=JS.OobleckConfig(**SA_VAE),
                                dit=JD.DiTConfig(**dict(DIT_TINY, cond_dim=32, dtype="float32")), **SA_CFG)
    jm = JS.StableAudioModel(jcfg)
    tpl = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2 * 2048, 2)),
        jnp.asarray(JS.tokenize_prompt("x"))[None], jnp.zeros((1,)),
        method=JS.StableAudioModel.full_init))["params"]
    p = tamed_oobleck(tiny.filled(tpl, 10))
    jp = JM.StableAudioPipeline(jcfg, p)
    jp.model = tiny.Jitted(jp.model)
    tcfg = TS.StableAudioConfig(vae=TS.OobleckConfig(**SA_VAE),
                                dit=TD.DiTConfig(**dict(DIT_TINY, cond_dim=32, dtype="float32")), **SA_CFG)
    tm = tiny._load(TS.StableAudioModel(tcfg), W.stable_audio_from_jax(p))
    return jp, TM.StableAudioPipeline(tm, device="cpu")


def jax_start(seed: int, shape) -> np.ndarray:
    """``generate_audio``'s starting latents: the first of ``split(PRNGKey(seed))``."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.normal(k_init, shape))


def test_generate_audio_matches_jax():
    jp, tp = stable_audio_pair()
    kw = dict(negative_prompt="noise", seconds_total=1.0, seconds_start=0.5, steps=STEPS,
              cfg_scale=3.0, seed=2)
    want, sr = jp.generate("warm pads", **kw)
    z = jax_start(2, (1, TS.latent_frames(1.0, 8192, 2048), 8))
    got, sr2 = tp.generate("warm pads", z=torch.from_numpy(z), **kw)
    assert sr == sr2 == 8192 and got.shape == want.shape == (2, 4 * 2048)
    close(got, want, 1e-4)


def test_variations_and_continue_match_jax():
    """``variations`` (init audio through the encoder, ``t_start`` from the
    strength) and ``continue_audio`` (the crossfade splice)."""
    jp, tp = stable_audio_pair()
    clip = (0.2 * np.sin(np.arange(3 * 2048) / 9.0)[:, None] * [1.0, 0.5]).astype(np.float32)
    kw = dict(steps=STEPS, cfg_scale=2.0, seed=4)
    want, _ = jp.variations(clip, "glass", strength=0.6, **kw)
    z = jax_start(4, (1, TS.latent_frames(1.0, 8192, 2048), 8))   # clamped to 1 s
    got, _ = tp.variations(clip, "glass", strength=0.6, z=torch.from_numpy(z), **kw)
    close(got, want, 1e-4, "variations")
    want, _ = jp.continue_audio(clip[:, 0], "glass", seconds_total=1.0, **kw)
    z = jax_start(4, (1, TS.latent_frames(1.0, 8192, 2048), 8))
    got, _ = tp.continue_audio(clip[:, 0], "glass", seconds_total=1.0, z=torch.from_numpy(z),
                               **kw)
    assert got.shape == want.shape
    close(got, want, 1e-4, "continue")


# ------------------------------------------------------------------ the checkpoint pipeline


@pytest.fixture(scope="module")
def spm_model(tmp_path_factory):
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.0, 1),
              ("▁a", -1.0, 1), ("▁b", -1.5, 1), ("a", -2.5, 1), ("b", -2.5, 1),
              ("▁warm", -1.0, 1), ("▁pad", -1.2, 1), ("s", -2.0, 1)]
    path = tmp_path_factory.mktemp("spm") / "t5.model"
    path.write_bytes(TSpm.build_model_proto(pieces, model_type=TSpm.UNIGRAM, unk_id=2,
                                            bos_id=-1, eos_id=1, pad_id=0))
    return str(path)


@pytest.fixture(scope="module")
def checkpoint_pair(spm_model):
    """Both packages' StableAudioCheckpointPipeline at tiny widths on the
    same weights (the JAX modules jitted)."""
    t5cfg = dict(T5_TINY, dim=64)
    jt5 = JT.T5Encoder(JT.T5Config(**t5cfg))
    t5_tpl, t5_p, t5_m = built(jt5, lambda: TT.T5Encoder(TT.T5Config(**t5cfg)), W.t5_from_jax,
                               11, jnp.zeros((1, 8), jnp.int32))
    jne = JS.NumberEmbedder(features=64)
    ne = [built(jne, lambda: TS.NumberEmbedder(features=64), W.number_embedder_from_jax,
                12 + i, jnp.zeros((1,))) for i in range(2)]
    jdec = JSD.OobleckDecoder(JSD.OobleckConfig(**CKPT_VAE))
    _, dec_p, dec_m = built(jdec, lambda: TSD.OobleckDecoder(TSD.OobleckConfig(**CKPT_VAE)),
                            lambda p: W.sao_oobleck_from_jax(tamed_oobleck(p)), 14,
                            jnp.zeros((1, 3, 8)))
    dec_p = tamed_oobleck(dec_p)
    _, _, dit_p, dit_m = sao_pair()
    kw = dict(sr=8192, max_seconds=4.0)
    jp = JM.StableAudioCheckpointPipeline(
        dit_p, dec_p, t5_p, ne[0][1], ne[1][1], spm_model, dit_cfg=JSD.SAODiTConfig(**SAO_TINY),
        vae_cfg=JSD.OobleckConfig(**CKPT_VAE), t5_cfg=JT.T5Config(**t5cfg), **kw)
    for name in ("dit", "decoder", "t5", "num_emb"):
        setattr(jp, name, tiny.Jitted(getattr(jp, name)))
    tp = TM.StableAudioCheckpointPipeline(dit_m, dec_m, t5_m, ne[0][2], ne[1][2], spm_model,
                                          device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("sampler", ["dpmpp-3m-sde", "v-ddim"])
@pytest.mark.parametrize("negative", ["", "b a"])
def test_checkpoint_pipeline_generate_matches_jax(checkpoint_pair, sampler, negative):
    """``generate`` end to end under JAX's draws (the starting noise from the
    first of ``split(PRNGKey(seed))``, the SDE's from the second): the zeroed
    or negative-prompt unconditional row, both samplers, 1e-4 of max|y|."""
    jp, tp = checkpoint_pair
    kw = dict(negative_prompt=negative, seconds_total=1.0, seconds_start=1.0, steps=STEPS,
              cfg_scale=4.0, seed=5, sampler_type=sampler)
    want, sr = jp.generate("warm pads", **kw)
    t_lat = tp.latent_frames(1.0)
    rng_noise, rng_samp = jax.random.split(jax.random.PRNGKey(5))
    noise = np.asarray(jax.random.normal(rng_noise, (1, t_lat, 8)))
    draws = jax_sde_draws(rng_samp, STEPS, (1, t_lat, 8))
    got, sr2 = tp.generate("warm pads", noise=torch.from_numpy(noise),
                           sde_draws=torch.from_numpy(draws), **kw)
    assert sr == sr2 and got.shape == want.shape == (2, t_lat * 2048)
    close(got, want, 1e-4)


def test_checkpoint_pipeline_rejects_init_audio(checkpoint_pair):
    _jp, tp = checkpoint_pair
    with pytest.raises(NotImplementedError):
        tp.generate("a", steps=1, init_audio=np.zeros((2, 100), np.float32))
