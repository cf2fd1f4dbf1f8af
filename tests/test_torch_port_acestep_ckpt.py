"""ACE-Step's checkpoint-layout models in the port against the JAX package
on the CPU: the transformer (``decode`` with ERG's ``q_tau`` and the SSL
projections, ``encode``, ``time_embedding``), the lyric conformer (with
``q_tau_layers``), AutoencoderDC (ResBlocks and EfficientViT blocks, both
down- and both upsampling types), ADaMoS, ``MusicDCAE``'s mel front end and
codec, ``CheckpointACEStep.generate`` (ERG, APG per channel, the guidance
interval and its decay, omega) and ``ACEStepTextEncoder`` on a tiny UMT5
and a SentencePiece model the test writes.  Tiny widths, weights filled on
``jax.eval_shape`` templates; each ``*_from_jax`` round-trips through the
JAX converter.

Tolerances: 1e-5 of max|y| for single modules (fp32 sums in another
order), 1e-4 for the DCAE's and ADaMoS's deeper stacks, the mel chain and a
solve (steps and decoders compound fp32 differences).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiolab_tpu.models import acestep_dit as JD
from audiolab_tpu.models import adamos_vocoder as JV
from audiolab_tpu.models import dcae as JC
from audiolab_tpu.models import music_dcae as JM
from audiolab_tpu.models import t5 as JT
from audiolab_tpu.pipelines import acestep as JP
from audiolab_tpu.utils.convert import (
    convert_acestep_dit,
    convert_acestep_lyric,
    convert_adamos,
    convert_dcae,
    convert_t5,
)
from audiolab_tpu_torch.models import acestep_dit as TD
from audiolab_tpu_torch.models import adamos_vocoder as TV
from audiolab_tpu_torch.models import dcae as TC
from audiolab_tpu_torch.models import music_dcae as TM
from audiolab_tpu_torch.models import t5 as TT
from audiolab_tpu_torch.pipelines import acestep as TP
from audiolab_tpu_torch.utils import spm as TSpm
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.test_torch_port_acestep import JaxDraws
from tests.test_torch_port_music import close, tree_equal
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(17)
DIT = dict(num_layers=3, num_attention_heads=2, attention_head_dim=8, in_channels=2,
           out_channels=2, patch_height=4, speaker_embedding_dim=8, text_embedding_dim=8,
           lyric_vocab_size=32, lyric_hidden_size=16, ssl_latent_dims=(8, 6),
           ssl_encoder_depths=(0, 1))
LYRIC = dict(dim=16, heads=2, ffn_dim=32, num_blocks=2)
DCAE = dict(in_channels=2, latent_channels=4, attention_head_dim=8,
            encoder_block_types=("ResBlock", "EfficientViTBlock"),
            encoder_block_out_channels=(8, 16), encoder_layers_per_block=(1, 1),
            encoder_qkv_multiscales=((), (3,)),
            decoder_block_types=("ResBlock", "EfficientViTBlock"),
            decoder_block_out_channels=(8, 16), decoder_layers_per_block=(1, 1),
            decoder_qkv_multiscales=((), (3,)))
ADAMOS = dict(input_channels=16, depths=(1, 2), dims=(8, 12), kernel_size=7,
              upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
              num_mels=12, upsample_initial_channel=16, pre_conv_kernel_size=5,
              post_conv_kernel_size=5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _n(x):
    return x.detach().cpu().numpy()


def _tpl(model, *args, method=None, **kw):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, method=method,
                                             **kw))["params"]


@functools.lru_cache(maxsize=None)
def dit_pair(cfg_items=tuple(DIT.items()), seed=30):
    """(flax ACEStepDiT, its filled params, the template, port ACEStepDiT)."""
    cfg = dict(cfg_items)
    jm = JD.ACEStepDiT(JD.ACEStepDiTConfig(**cfg))
    c = jm.cfg
    tpl = dict(_tpl(jm, jnp.zeros((1, c.in_channels, c.patch_height, 4)), jnp.ones((1, 4)),
                    jnp.zeros((1, 2, c.text_embedding_dim)), jnp.ones((1, 2)),
                    jnp.zeros((1, c.speaker_embedding_dim)), jnp.full((1,), 0.5),
                    jnp.zeros((1, 3, c.lyric_hidden_size)), jnp.ones((1, 3)),
                    return_hidden=True))
    tpl |= dict(_tpl(jm, jnp.zeros((1, 3), jnp.int32), method=JD.ACEStepDiT.embed_lyrics))
    p = tiny.filled(tpl, seed)
    tm = tiny._load(TD.ACEStepDiT(TD.ACEStepDiTConfig(**cfg)), W.acestep_dit_from_jax(p))
    return jm, p, tpl, tm


@functools.lru_cache(maxsize=None)
def lyric_pair(seed=31, **kw):
    cfg = dict(LYRIC, **kw)
    jm = JD.LyricConformerEncoder(**cfg)
    tpl = _tpl(jm, jnp.zeros((1, 4, cfg["dim"])), jnp.ones((1, 4)))
    p = tiny.filled(tpl, seed)
    tm = tiny._load(TD.LyricConformerEncoder(**cfg), W.acestep_lyric_from_jax(p))
    return jm, p, tpl, tm


def _cond(c, b=2, s=3, t=6, seed=0):
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((b, s, c.text_embedding_dim)).astype(np.float32)
    tmask = np.ones((b, s), np.int32)
    tmask[1, -1] = 0
    spk = rng.standard_normal((b, c.speaker_embedding_dim)).astype(np.float32)
    lyr = rng.standard_normal((b, 4, c.lyric_hidden_size)).astype(np.float32)
    lmask = np.ones((b, 4), np.int32)
    lat = rng.standard_normal((b, c.in_channels, c.patch_height, t)).astype(np.float32)
    return text, tmask, spk, lyr, lmask, lat


@pytest.mark.parametrize("erg", [False, True])
def test_checkpoint_dit_matches_jax(erg):
    """encode + decode with the SSL projections (and ERG's q_tau on blocks 1
    and 2), 1e-5 of max|y|; the converter maps the port's state_dict back."""
    jm, p, tpl, tm = dit_pair()
    c = jm.cfg
    text, tmask, spk, lyr, lmask, lat = _cond(c)
    # a latent position masked out has no key left in the cross-attention's
    # -inf mask, and both packages (and upstream) give NaN there, so every
    # latent position is kept, as generation keeps them
    amask = np.ones((2, lat.shape[-1]), np.float32)
    ts = np.array([0.3, 700.0], np.float32)
    kw = {"q_tau": 0.01, "q_tau_blocks": (1, 2)} if erg else {}
    enc, emask = jm.apply({"params": p}, jnp.asarray(text), jnp.asarray(tmask), jnp.asarray(spk),
                          jnp.asarray(lyr), jnp.asarray(lmask), method=JD.ACEStepDiT.encode)
    want, want_h = jm.apply({"params": p}, jnp.asarray(lat), jnp.asarray(amask), enc, emask,
                            jnp.asarray(ts), return_hidden=True, method=JD.ACEStepDiT.decode, **kw)
    with torch.no_grad():
        enc_t, emask_t = tm.encode(_t(text), _t(tmask, torch.long), _t(spk), _t(lyr),
                                   _t(lmask, torch.long))
        got, got_h = tm.decode(_t(lat), _t(amask), enc_t, emask_t, _t(ts), return_hidden=True, **kw)
    close(_n(enc_t), enc, 1e-5, "encode")
    close(_n(got), want, 1e-5, "decode")
    for g, w in zip(got_h, want_h):
        close(_n(g), w, 1e-5, "ssl projection")
    if not erg:
        tree_equal(convert_acestep_dit(tiny.numpy_state(tm), tpl), p)


def test_checkpoint_dit_pieces_match_jax():
    """The rope tables and interleaved rotation, the time embedding and the
    lyric token embedding."""
    jm, p, _tpl_, tm = dit_pair()
    cos, sin = TD.rope_tables(7, 8, 1e6)
    jcos, jsin = JD.rope_tables(7, 8, 1e6)
    close(cos, jcos, 1e-6, "cos")
    close(sin, jsin, 1e-6, "sin")
    x = RNG.standard_normal((2, 3, 7, 8)).astype(np.float32)
    close(TD.apply_rope(_t(x), cos, sin), JD.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6,
          "rope")
    ts = np.array([0.0, 1.5, 999.0], np.float32)
    with torch.no_grad():
        got = tm.time_embedding(_t(ts))
        ids = RNG.integers(0, 32, (2, 5))
        emb = tm.embed_lyrics(_t(ids, torch.long))
    close(_n(got), jm.apply({"params": p}, jnp.asarray(ts), method=JD.ACEStepDiT.time_embedding),
          1e-5, "time embedding")
    close(_n(emb), jm.apply({"params": p}, jnp.asarray(ids, jnp.int32),
                            method=JD.ACEStepDiT.embed_lyrics), 0, "lyric embedding")


@pytest.mark.parametrize("q_tau", [1.0, 0.01])
def test_lyric_conformer_matches_jax(q_tau):
    jm, p, tpl, tm = lyric_pair()
    x = RNG.standard_normal((2, 5, 16)).astype(np.float32)
    mask = np.ones((2, 5), np.int32)
    mask[1, 3:] = 0
    kw = {"q_tau": q_tau, "q_tau_layers": (1,)} if q_tau != 1.0 else {}
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask), **kw)
    with torch.no_grad():
        got = tm(_t(x), _t(mask, torch.long), **kw)
    close(_n(got), want, 1e-5, f"conformer q_tau={q_tau}")
    close(TD.espnet_rel_pe(5, 16), JD.espnet_rel_pe(5, 16), 1e-6, "rel pe")
    tree_equal(convert_acestep_lyric(tiny.numpy_state(tm), tpl), p)


@functools.lru_cache(maxsize=None)
def dcae_pair(down="conv", up="interpolate", seed=32):
    cfg = dict(DCAE, downsample_block_type=down, upsample_block_type=up)
    jm = JC.AutoencoderDC(JC.DCAEConfig(**cfg))
    tpl = _tpl(jm, jnp.zeros((1, 8, 8, cfg["in_channels"])))
    p = tiny.filled(tpl, seed)
    tm = tiny._load(TC.AutoencoderDC(TC.DCAEConfig(**cfg)), W.dcae_from_jax(p))
    return jm, p, tpl, tm


@pytest.mark.parametrize("down,up", [("conv", "interpolate"),
                                     ("pixel_unshuffle", "pixel_shuffle")])
def test_dcae_matches_jax(down, up):
    """Encode and decode (NHWC in JAX, NCHW here) on a 16 x 12 image, with
    both linear-attention forms (16 x 12 / 2 positions > head width 8, and a
    4 x 2 latent grid's 8 <= 8), 1e-4 of max|y|; the converter round trip."""
    jm, p, tpl, tm = dcae_pair(down, up)
    x = RNG.standard_normal((2, 16, 12, 2)).astype(np.float32)
    z_want = jm.apply({"params": p}, jnp.asarray(x), method=JC.AutoencoderDC.encode)
    zq = RNG.standard_normal((1, 4, 2, 4)).astype(np.float32)
    y_want = jm.apply({"params": p}, jnp.asarray(zq), method=JC.AutoencoderDC.decode)
    with torch.no_grad():
        z_got = tm.encode(_t(x).permute(0, 3, 1, 2))
        y_got = tm.decode(_t(zq).permute(0, 3, 1, 2))
    close(_n(z_got.permute(0, 2, 3, 1)), z_want, 1e-4, "encode")
    close(_n(y_got.permute(0, 2, 3, 1)), y_want, 1e-4, "decode")
    tree_equal(convert_dcae(tiny.numpy_state(tm), tpl), p)
    assert TC.spatial_compression(tm.cfg) == JC.spatial_compression(jm.cfg) == 2


def test_pixel_shuffles_match_the_jax_channel_order():
    """The JAX module's channels-last shuffles order channels as torch's
    NCHW ``F.pixel_(un)shuffle``, which the port's DCAE calls."""
    x = RNG.standard_normal((2, 6, 4, 12)).astype(np.float32)       # NHWC
    got = F.pixel_unshuffle(_t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    close(got, JC.pixel_unshuffle(jnp.asarray(x), 2), 0, "unshuffle")
    got = F.pixel_shuffle(_t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    close(got, JC.pixel_shuffle(jnp.asarray(x), 2), 0, "shuffle")


@functools.lru_cache(maxsize=None)
def adamos_pair(seed=33):
    jm = JV.AdamosVocoder(JV.AdamosConfig(**ADAMOS))
    tpl = _tpl(jm, jnp.zeros((1, 6, 16)))
    p = tiny.filled(tpl, seed)
    tm = tiny._load(TV.AdamosVocoder(TV.AdamosConfig(**ADAMOS)), W.adamos_from_jax(p))
    return jm, p, tpl, tm


def test_adamos_matches_jax():
    jm, p, tpl, tm = adamos_pair()
    mel = RNG.standard_normal((2, 7, 16)).astype(np.float32)
    want = jm.apply({"params": p}, jnp.asarray(mel))
    with torch.no_grad():
        got = tm(_t(mel))
    assert got.shape == (2, 7 * 8)
    close(_n(got), want, 1e-4, "adamos")
    tree_equal(convert_adamos(tiny.numpy_state(tm), tpl), p)


def test_music_dcae_matches_jax():
    """The 44.1 kHz log-mel, its normalisation, and MusicDCAE's encode and
    decode through the DCAE (an f2 codec here) and ADaMoS."""
    jd, dp, _d, td = dcae_pair()
    jv, vp, _v, tv = adamos_pair()
    audio = (0.3 * RNG.standard_normal((1, 2, 9000))).astype(np.float32)
    close(_n(TM.log_mel_44k(_t(audio))), JM.log_mel_44k(jnp.asarray(audio)), 1e-5, "log-mel")
    mel = RNG.standard_normal((1, 2, 8, 128)).astype(np.float32)
    close(_n(TM.denormalize_mel(TM.normalize_mel(_t(mel)))), mel, 1e-6, "mel normalisation")

    class Vocoder16:
        """ADaMoS over the first 16 of the 128 bins (the tiny vocoder's input)."""

        def __init__(self, fn):
            self.fn = fn

        def __call__(self, m):
            return self.fn(m[..., :16])

    jenc, jdec = JM.dcae_codec_fns(dp, jd.cfg)
    jmd = JM.MusicDCAE(jenc, jdec, tiny.Jitted(jv), vp)
    jmd.vocoder = type("V", (), {"apply": lambda self, v, m: jv.apply(v, m[..., :16])})()
    tenc, tdec = TM.dcae_codec_fns(td)
    tmd = TM.MusicDCAE(tenc, tdec, Vocoder16(tv))
    z_want = jmd.encode(jnp.asarray(audio))
    z_got = tmd.encode(_t(audio))
    close(_n(z_got), z_want, 1e-4, "MusicDCAE.encode")
    lat = RNG.standard_normal((1, 4, 64, 3)).astype(np.float32)
    close(tmd.decode(_t(lat)), jmd.decode(jnp.asarray(lat)), 1e-4, "MusicDCAE.decode")
    assert tmd.latent_frames(441000) == jmd.latent_frames(441000)


class JittedDiT(tiny.Jitted):
    """The JAX pipeline names the DiT's methods through ``type(model)``."""
    embed_lyrics = JD.ACEStepDiT.embed_lyrics
    encode = JD.ACEStepDiT.encode
    decode = JD.ACEStepDiT.decode


@functools.lru_cache(maxsize=None)
def ckpt_pair():
    """The JAX CheckpointACEStep at random_checkpoint_acestep's widths (its
    modules jitted) and the port's on the same weights, JAX's draws."""
    jp = JP.random_checkpoint_acestep()
    c = jp.cfg
    dit_tpl = dict(_tpl(jp.model, jnp.zeros((1, 2, 4, 4)), jnp.ones((1, 4)), jnp.zeros((1, 2, 8)),
                        jnp.ones((1, 2)), jnp.zeros((1, 8)), jnp.full((1,), 0.5),
                        jnp.zeros((1, 3, 16)), jnp.ones((1, 3)), return_hidden=True))
    dit_tpl |= dict(_tpl(jp.model, jnp.zeros((1, 3), jnp.int32),
                         method=JD.ACEStepDiT.embed_lyrics))
    jp.params = tiny.filled(dit_tpl, 34)
    jp.lyric_params = tiny.filled(jp.lyric_params, 35)
    jp.model, jp.lyric_enc = JittedDiT(jp.model), tiny.Jitted(jp.lyric_enc)
    tm = TD.ACEStepDiT(TD.ACEStepDiTConfig(**{k: getattr(c, k) for k in DIT}))
    tiny._load(tm, W.acestep_dit_from_jax(jp.params))
    lyr = tiny._load(TD.LyricConformerEncoder(dim=16, heads=2, ffn_dim=32, num_blocks=1),
                     W.acestep_lyric_from_jax(jp.lyric_params))
    tp = TP.CheckpointACEStep(tm, lyr, latent_rate=2.0, device="cpu", draws=JaxDraws())
    return jp, tp


@pytest.mark.parametrize("case", ["published", "no_erg", "decay"])
def test_checkpoint_generate_matches_jax(case):
    """``generate`` at checkpoint_pcfg's sampler (8 steps: shift-3 sigmas,
    omega, APG per channel, guidance on the middle half, ERG on), with ERG
    off, and with the interval's decay; 1e-4 of max|y|."""
    jp, tp = ckpt_pair()
    pcfg = dict(steps=8)
    if case == "no_erg":
        pcfg.update(use_erg_tag=False, use_erg_lyric=False, use_erg_diffusion=False)
    if case == "decay":
        pcfg.update(guidance_interval=0.75, guidance_interval_decay=1.0, min_guidance_scale=4.0)
    base = vars(JP.checkpoint_pcfg())
    jp.pcfg = JP.ACEStepPipelineConfig(**dict(base, **pcfg))
    tp.pcfg = TP.ACEStepPipelineConfig(**dict(base, **pcfg))
    rng = np.random.default_rng(5)
    text = rng.standard_normal((1, 3, 8)).astype(np.float32)
    null = rng.standard_normal((1, 3, 8)).astype(np.float32)
    tmask = np.ones((1, 3), np.int32)
    spk = rng.standard_normal((1, 8)).astype(np.float32)
    toks = rng.integers(1, 32, (1, 5)).astype(np.int32)
    lmask = np.ones((1, 5), np.int32)
    want = jp.generate(jnp.asarray(text), jnp.asarray(tmask), jnp.asarray(spk), jnp.asarray(toks),
                       jnp.asarray(lmask), duration=3.0, seed=3,
                       text_hidden_null=jnp.asarray(null))
    got = tp.generate(_t(text), _t(tmask, torch.long), _t(spk), _t(toks, torch.long),
                      _t(lmask, torch.long), duration=3.0, seed=3, text_hidden_null=_t(null))
    assert got.shape == want.shape == (1, 2, 4, 6)
    close(_n(got), want, 1e-4, case)


def test_checkpoint_pcfg_is_the_jax_one():
    assert vars(TP.checkpoint_pcfg()) == vars(JP.checkpoint_pcfg())
    assert vars(TP.ACEStepPipelineConfig()) == vars(JP.ACEStepPipelineConfig())


T5_TINY = dict(vocab_size=12, dim=16, d_kv=8, heads=2, d_ff=24, layers=10, gated=True,
               per_layer_bias=True)


@pytest.fixture(scope="module")
def spm_model(tmp_path_factory):
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.0, 1),
              ("▁a", -1.0, 1), ("▁b", -1.5, 1), ("a", -2.5, 1), ("b", -2.5, 1),
              ("▁lo", -1.0, 1), ("fi", -1.2, 1), ("s", -2.0, 1)]
    path = tmp_path_factory.mktemp("spm") / "umt5.model"
    path.write_bytes(TSpm.build_model_proto(pieces, model_type=TSpm.UNIGRAM, unk_id=2,
                                            bos_id=-1, eos_id=1, pad_id=0))
    return str(path)


def test_text_encoder_matches_jax(spm_model):
    """A 10-layer UMT5 (ERG-tag's null states scale q on layers 8 and 9):
    hidden states, masks and null embeddings, 1e-5 of max|y|."""
    cfg = JT.T5Config(**T5_TINY)
    jm = JT.T5Encoder(cfg)
    tpl = _tpl(jm, jnp.zeros((1, 4), jnp.int32))
    p = tiny.filled(tpl, 36)
    tm = tiny._load(TT.T5Encoder(TT.T5Config(**T5_TINY)), W.t5_from_jax(p))
    je = JP.ACEStepTextEncoder(p, spm_model, cfg=cfg)
    je.model = tiny.Jitted(je.model)
    te = TP.ACEStepTextEncoder(tm, spm_model, device="cpu")
    texts = ["lofi beats", "a b a"]
    (h_w, m_w), (h_g, m_g) = je(texts, 4), te(texts, 4)
    np.testing.assert_array_equal(_n(m_g), np.asarray(m_w))
    close(_n(h_g), h_w, 1e-5, "umt5 hidden")
    close(_n(te.null_embeddings(texts)), je.null_embeddings(texts), 1e-5, "null embeddings")
    tree_equal(convert_t5(tiny.numpy_state(tm), tpl), p)
