"""The port's checkpoint loaders of the music models (audiolab_tpu_torch/
utils/convert.py: stable-audio-open's DiT, Oobleck decoder, seconds
embedders and T5 with their one-call pipeline; the checkpoint-layout
ACE-Step's transformer, lyric conformer, DCAE, ADaMoS and UMT5 with theirs;
CLAP's two branches and Vocos) against the JAX package's
(audiolab_tpu/utils/convert.py), on the CPU, on files the tests write in
the upstream layouts from seeded port modules at small widths.

Each case reads one file or directory with both packages: the JAX tree
reaches the port through ``utils/weights.py``'s ``*_from_jax``, and its
state_dict must equal, bit for bit, the one the port's loader gives; both
packages then run the loaded model on one seeded input at the tolerance of
the module's parity test: 1e-5 of max|y| for T5 and UMT5, the seconds
embedder, the Oobleck decoder (tests/test_torch_port_music.py), the
stable-audio DiT, the lyric conformer, CLAP (tests/test_torch_port_clap.py)
and Vocos (tests/test_torch_port_acestep.py); the ACE-Step transformer
1e-5, the DCAE and ADaMoS 1e-4 (tests/test_torch_port_acestep_ckpt.py); a
one-call pipeline's parts at the same tolerances, run through the
assembled pipelines.

The files hold what the JAX converters fold (the Oobleck decoder's and
ADaMoS's weight-norm pairs, each gain off its weight's norm, in both of
torch's forms), tensors they ignore (the stable-audio encoder beside the
decoder, the lyric encoder beside the transformer, T5's decoder and head,
CLAP's other branch with ``logit_scale_*``, ``position_ids``, HTSAT's
extractors, ``bn0`` and TSCAM head, Vocos's feature extractor) and the
prefixes they strip.  The one-call pipelines hard-code the published
configurations: their cases swap the configuration classes each loader
looks up, in both packages, for small ones that keep stable-audio's fixed
widths (64 latent channels, 768-d cross tokens, a 1536-d global vector).
Every JAX template comes from ``jax.eval_shape``, traced once per
configuration; no flax ``init`` runs.
"""

import functools
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import acestep_dit as JD
from audiolab_tpu.models import adamos_vocoder as JA
from audiolab_tpu.models import clap as JC
from audiolab_tpu.models import codecs as JCo
from audiolab_tpu.models import dcae as JDc
from audiolab_tpu.models import stable_audio as JS
from audiolab_tpu.models import stable_audio_dit as JSD
from audiolab_tpu.models import t5 as JT
from audiolab_tpu.utils import convert as JV
from audiolab_tpu_torch.models import acestep_dit as TD
from audiolab_tpu_torch.models import adamos_vocoder as TA
from audiolab_tpu_torch.models import clap as TC
from audiolab_tpu_torch.models import codecs as TCo
from audiolab_tpu_torch.models import dcae as TDc
from audiolab_tpu_torch.models import stable_audio as TS
from audiolab_tpu_torch.models import stable_audio_dit as TSD
from audiolab_tpu_torch.models import t5 as TT
from audiolab_tpu_torch.utils import convert as TV
from audiolab_tpu_torch.utils import weights as W
from audiolab_tpu_torch.utils.spm import UNIGRAM, build_model_proto
from chip_smoke import (
    ADAMOS_WN,
    OOBLECK_WN,
    cpu_state,
    gains_off,
    laion_clap_state,
    stable_audio_state,
    t5_file_state,
    vocos_file_state,
    weight_norm_pairs,
    write_acestep_dir,
    write_safetensors,
)
from tests import torch_port_tiny as tiny
from tests.test_torch_port_acestep_ckpt import JittedDiT
from tests.test_torch_port_loaders import _states_equal
from tests.test_torch_port_loaders_listen import _close, _parametrized
from tests.test_torch_port_loaders_voice import _traced_once
from tests.test_torch_port_music import tamed_oobleck
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

# stable-audio-open at small depth and widths, its fixed input widths kept
# (the DiT's cross-attention takes 768 / 64 = 12 key heads, repeated over
# its query heads: at head width 64 that needs 12 of them)
T5_V = dict(vocab_size=40, dim=768, d_kv=8, heads=2, d_ff=32, layers=2)
SAO_V = dict(io_channels=64, embed_dim=768, depth=1, num_heads=12, cond_token_dim=768,
             global_cond_dim=1536)
VAE_V = dict(out_channels=2, channels=4, latent_dim=64, c_mults=(1, 2, 2, 4, 4),
             strides=(2, 4, 4, 8, 8))
# the checkpoint-layout ACE-Step: the DCAE's latent is the transformer's
# (2 channels, 4 high) and its image 8 bins high, ADaMoS's input
UMT5_V = dict(vocab_size=12, dim=16, d_kv=8, heads=2, d_ff=24, layers=2, gated=True,
              per_layer_bias=True)
DIT_V = dict(num_layers=2, num_attention_heads=2, attention_head_dim=8, in_channels=2,
             out_channels=2, patch_height=4, speaker_embedding_dim=8, text_embedding_dim=16,
             lyric_vocab_size=32, lyric_hidden_size=16, ssl_latent_dims=(8,),
             ssl_encoder_depths=(0,))
LYRIC_V = dict(dim=16, heads=2, ffn_dim=32, num_blocks=1)
DCAE_V = dict(in_channels=2, latent_channels=2, attention_head_dim=8,
              encoder_block_types=("ResBlock", "EfficientViTBlock"),
              encoder_block_out_channels=(8, 16), encoder_layers_per_block=(1, 1),
              encoder_qkv_multiscales=((), (3,)),
              decoder_block_types=("ResBlock", "EfficientViTBlock"),
              decoder_block_out_channels=(8, 16), decoder_layers_per_block=(1, 1),
              decoder_qkv_multiscales=((), (3,)))
ADAMOS_V = dict(input_channels=8, depths=(1, 2), dims=(8, 12), kernel_size=7,
                upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
                num_mels=12, upsample_initial_channel=16, pre_conv_kernel_size=5,
                post_conv_kernel_size=5)
# tests/test_torch_port_clap.py's branches at fewer layers (a shifted window
# and a patch merging kept); Vocos over 12 mel bins
CLAP_TEXT = dict(vocab_size=60, dim=16, layers=1, heads=2, ffn_dim=32, max_positions=24,
                 joint_dim=8)
CLAP_AUDIO = dict(spec_size=64, patch_size=4, patch_stride=4, embed_dim=8, depths=(2, 1),
                  heads=(2, 2), window=4, joint_dim=8)
VOCOS_V = dict(dim=16, n_layers=2, n_fft=64, hop=16)
VOCOS_IN = 12

PROMPT = "warm pads"
SPM_PIECES = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.0, 1),
              ("▁a", -1.0, 1), ("▁b", -1.5, 1), ("a", -2.5, 1), ("b", -2.5, 1),
              ("▁warm", -1.0, 1), ("▁pad", -1.2, 1), ("s", -2.0, 1)]


@pytest.fixture(autouse=True, scope="module")
def _templates_traced_once():
    """The JAX modules whose templates the loaders and the tests here trace,
    each traced once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((JSD, "StableAudioDiT"), (JSD, "OobleckDecoder"),
                          (JS, "NumberEmbedder"), (JT, "T5Encoder"), (JD, "ACEStepDiT"),
                          (JD, "LyricConformerEncoder"), (JDc, "AutoencoderDC"),
                          (JA, "AdamosVocoder"), (JC, "ClapTextBranch"),
                          (JC, "ClapAudioBranch"), (JCo, "Vocos")):
            mp.setattr(mod, name, _traced_once(getattr(mod, name)))
        yield


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tpl(model, *args, method=None, **kw):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, method=method,
                                             **kw))["params"]


def _port(make, from_jax, tpl, seed):
    """A port module of ``tiny.filled(tpl, seed)``'s weights."""
    return tiny._load(make(), from_jax(tiny.filled(tpl, seed)))


def _write(path, sd: dict) -> str:
    path = str(path)
    if path.endswith(".safetensors"):
        write_safetensors(path, sd)
    else:
        torch.save(sd, path)
    return path


def _spm(path) -> str:
    path.write_bytes(build_model_proto(SPM_PIECES, model_type=UNIGRAM, unk_id=2, bos_id=-1,
                                       eos_id=1, pad_id=0))
    return str(path)


# ----------------------------------------------------------- Stable Audio

@functools.lru_cache(maxsize=None)
def _t5(umt5: bool):
    """(JAX config, template, port T5Encoder) at SAO's T5 or ACE-Step's UMT5."""
    kw = UMT5_V if umt5 else T5_V
    cfg = JT.T5Config(**kw)
    tpl = _tpl(JT.T5Encoder(cfg), jnp.zeros((1, 8), jnp.int32))
    return cfg, tpl, _port(lambda: TT.T5Encoder(TT.T5Config(**kw)), W.t5_from_jax, tpl, 50 + umt5)


@functools.lru_cache(maxsize=None)
def _sao_parts():
    """(template, port module) of the DiT, the decoder (tamed) and the two
    seconds embedders at SAO_V / VAE_V."""
    c = JSD.SAODiTConfig(**SAO_V)
    dit_tpl = _tpl(JSD.StableAudioDiT(c), jnp.zeros((1, 8, c.io_channels)), jnp.zeros((1,)),
                   jnp.zeros((1, 4, c.cond_token_dim)), jnp.zeros((1, c.global_cond_dim)))
    dec_tpl = _tpl(JSD.OobleckDecoder(JSD.OobleckConfig(**VAE_V)), jnp.zeros((1, 8, 64)))
    ne_tpl = _tpl(JS.NumberEmbedder(features=768), jnp.zeros((1,)))
    dec_p = tamed_oobleck(tiny.filled(dec_tpl, 53))
    return dict(
        dit=(dit_tpl, _port(lambda: TSD.StableAudioDiT(TSD.SAODiTConfig(**SAO_V)),
                            W.sao_dit_from_jax, dit_tpl, 52)),
        dec=(dec_tpl, tiny._load(TSD.OobleckDecoder(TSD.OobleckConfig(**VAE_V)),
                                 W.sao_oobleck_from_jax(dec_p))),
        ss=(ne_tpl, _port(lambda: TS.NumberEmbedder(features=768), W.number_embedder_from_jax,
                          ne_tpl, 54)),
        st=(ne_tpl, _port(lambda: TS.NumberEmbedder(features=768), W.number_embedder_from_jax,
                          ne_tpl, 55)))


@functools.lru_cache(maxsize=None)
def _sao_file(form: str = "weight_g") -> dict:
    """stable-audio-open's ``model.safetensors``: the DiT, the decoder with
    every convolution a weight-norm pair (gains off their weights' norms,
    in the old names or torch 2's), an encoder's pair beside it, and the
    two seconds embedders."""
    parts = _sao_parts()
    dec = gains_off(weight_norm_pairs(cpu_state(parts["dec"][1]), OOBLECK_WN), 56)
    assert sum(k.endswith("weight_g") for k in dec) == 37
    enc = gains_off(weight_norm_pairs({"layers.0.weight": torch.ones(4, 2, 7)}, OOBLECK_WN), 57)
    sd = stable_audio_state(cpu_state(parts["dit"][1]), dec, cpu_state(parts["ss"][1]),
                            cpu_state(parts["st"][1]), encoder=enc)
    return _parametrized(sd) if form == "parametrizations" else sd


@functools.lru_cache(maxsize=None)
def _jit(module, method=None):
    return jax.jit(functools.partial(module.apply, method=method))


@pytest.mark.parametrize("umt5,shared", [(False, True), (True, False)])
def test_t5_loader_matches_jax(tmp_path, umt5, shared):
    """T5 (relu FFN, one relative bias) with ``shared.weight`` and UMT5
    (gated FFN, a bias per layer) with only ``encoder.embed_tokens.weight``,
    each beside a decoder and ``lm_head``: equal to the JAX tree, the
    encoder's output on a padded batch within 1e-5 of max|y|."""
    cfg, _tpl_, tm = _t5(umt5)
    dec = {"decoder.final_layer_norm.weight": torch.ones(cfg.dim),
           "lm_head.weight": torch.zeros(cfg.vocab_size, cfg.dim)}
    path = _write(tmp_path / "model.safetensors",
                  t5_file_state(cpu_state(tm), shared, embed_tokens=True, decoder=dec))
    tree = JV.load_t5_encoder(path, cfg)
    got = TV.load_t5_encoder(path, TT.T5Config(**(UMT5_V if umt5 else T5_V)), device="cpu")
    _states_equal(got, tiny._load(TT.T5Encoder(tm.cfg), W.t5_from_jax(tree)))
    rng = np.random.default_rng(60)
    ids = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 5:] = 0
    with torch.no_grad():
        out = got(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    _close(out.numpy(), _jit(JT.T5Encoder(cfg))({"params": tree}, ids, mask), 1e-5)


@pytest.mark.parametrize("bare", [False, True])
def test_sao_number_embedders_match_jax(tmp_path, bare):
    """Both seconds embedders from stable-audio-open's file, and one from a
    bare ``embedder.*`` file: equal to the JAX trees, the embeddings of four
    normalised seconds within 1e-5 of max|y|."""
    tpl, _m = _sao_parts()["ss"]
    whiches = ("seconds_start",) if bare else ("seconds_start", "seconds_total")
    sd = ({f"embedder.{k}": v for k, v in cpu_state(_sao_parts()["ss"][1]).items()} if bare
          else _sao_file())
    path = _write(tmp_path / "model.safetensors", sd)
    x = np.array([0.0, 0.05, 0.5, 1.0], np.float32)
    for which in whiches:
        tree = JV.convert_sao_number(JV.torch_load_weights(path), tpl, which)
        got = TV.load_sao_number_state(TS.NumberEmbedder(features=768),
                                       TV.torch_load_weights(path), which).eval()
        _states_equal(got, tiny._load(TS.NumberEmbedder(features=768),
                                      W.number_embedder_from_jax(tree)))
        assert torch.equal(got.embedding[1].bias,
                           _sao_parts()["ss" if which == "seconds_start" else "st"][1]
                           .embedding[1].bias)
        with torch.no_grad():
            out = got(torch.from_numpy(x))
        _close(out.numpy(), _jit(JS.NumberEmbedder(features=768))({"params": tree}, x), 1e-5)


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
def test_oobleck_decoder_matches_jax(tmp_path, form):
    """The decoder from stable-audio-open's file, its 37 weight-norm pairs
    (the five transposed up-convolutions over their input channels) with
    the gains off, in both of torch's forms, the encoder's pair dropped:
    equal to the JAX tree.  Once, the decoder on 3 latent frames within
    1e-5 of max|y|."""
    tpl, _m = _sao_parts()["dec"]
    path = _write(tmp_path / "model.safetensors", _sao_file(form))
    tree = JV.convert_oobleck(JV.torch_load_weights(path), tpl)
    got = TV.load_oobleck_state(TSD.OobleckDecoder(TSD.OobleckConfig(**VAE_V)),
                                TV.torch_load_weights(path)).eval()
    _states_equal(got, tiny._load(TSD.OobleckDecoder(TSD.OobleckConfig(**VAE_V)),
                                  W.sao_oobleck_from_jax(tree)))
    if form != "weight_g":
        return
    z = _rand(1, 3, 64, seed=61)
    with torch.no_grad():
        out = got(torch.from_numpy(z))
    _close(out.numpy(), _jit(JSD.OobleckDecoder(JSD.OobleckConfig(**VAE_V)))(
        {"params": tree}, z), 1e-5)


def test_sao_dit_loader_matches_jax(tmp_path):
    """The DiT from stable-audio-open's file (``model.model.`` stripped, the
    other parts dropped): equal to the JAX tree, the velocity of 12 latent
    frames against 130 cross tokens (the pipeline's) within 1e-5 of
    max|y|."""
    path = _write(tmp_path / "model.safetensors", _sao_file())
    cfg = JSD.SAODiTConfig(**SAO_V)
    tree = JV.load_sao_dit_checkpoint(path, cfg)
    got = TV.load_sao_dit_checkpoint(path, TSD.SAODiTConfig(**SAO_V), device="cpu")
    _states_equal(got, tiny._load(TSD.StableAudioDiT(TSD.SAODiTConfig(**SAO_V)),
                                  W.sao_dit_from_jax(tree)))
    args = (_rand(2, 12, 64, seed=62), np.array([0.3, 0.8], np.float32),
            _rand(2, 130, 768, seed=63), _rand(2, 1536, seed=64))
    with torch.no_grad():
        out = got(*map(torch.from_numpy, args))
    _close(out.numpy(), _jit(JSD.StableAudioDiT(cfg))({"params": tree}, *args), 1e-5)


@pytest.fixture
def small_published(monkeypatch):
    """The configuration classes each one-call loader looks up, in both
    packages' modules, at the small widths."""
    umt5 = {JT: JT.T5Config(**UMT5_V), TT: TT.T5Config(**UMT5_V)}
    for mods, name, kw in (((JSD, TSD), "SAODiTConfig", SAO_V),
                           ((JSD, TSD), "OobleckConfig", VAE_V), ((JT, TT), "T5Config", T5_V),
                           ((JD, TD), "ACEStepDiTConfig", DIT_V),
                           ((JD, TD), "LyricConformerEncoder", LYRIC_V),
                           ((JA, TA), "AdamosConfig", ADAMOS_V)):
        for mod in mods:
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))
    for mod, cfg in umt5.items():
        monkeypatch.setattr(mod, "umt5_base", lambda cfg=cfg: cfg)


@pytest.fixture(scope="module")
def sao_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("stable_audio")
    dec = {"decoder.final_layer_norm.weight": torch.ones(768)}
    return (_write(root / "model.safetensors", _sao_file()),
            _write(root / "t5.safetensors", t5_file_state(cpu_state(_t5(False)[2]), decoder=dec)),
            _spm(root / "spiece.model"))


def test_stable_audio_pipeline_matches_jax(sao_files, small_published):
    """Both packages' pipelines from one ``model.safetensors``, T5 file and
    SentencePiece model: every module equal to the JAX tree's; the
    conditioning (the prompt through the SentencePiece model and T5, both
    seconds embedders) within 1e-5 of max|y|, the DiT's velocity on it
    within 1e-5 and the decoder's audio within 1e-5, each through the
    assembled pipeline's own modules.  ``generate`` runs at full width on
    the card (chip_smoke.py's phase loaders_music)."""
    j = JV.load_stable_audio_pipeline(*sao_files)
    t = TV.load_stable_audio_pipeline(*sao_files, device="cpu")
    for got, sd in ((t.dit, W.sao_dit_from_jax(j.params["dit"])),
                    (t.decoder, W.sao_oobleck_from_jax(j.params["dec"])),
                    (t.t5, W.t5_from_jax(j.params["t5"])),
                    (t.ss, W.number_embedder_from_jax(j.params["ss"])),
                    (t.st, W.number_embedder_from_jax(j.params["st"]))):
        _states_equal(got, tiny._load(type(got)(got.cfg) if hasattr(got, "cfg")
                                      else TS.NumberEmbedder(features=768), sd))
    j.t5, j.num_emb = tiny.Jitted(j.t5), tiny.Jitted(j.num_emb)
    cross, glob = j._conditioning([PROMPT], 2.0, 30.0)
    with torch.no_grad():
        tc, tg = t.conditioning([PROMPT], 2.0, 30.0)
        _close(tc.numpy(), cross, 1e-5)
        _close(tg.numpy(), glob, 1e-5)
        x, ts = _rand(2, 12, 64, seed=65), np.array([0.3, 0.8], np.float32)
        cross2, glob2 = np.concatenate([cross] * 2), np.concatenate([glob] * 2)
        v = t.dit(*map(torch.from_numpy, (x, ts, cross2, glob2)))
        _close(v.numpy(), _jit(j.dit)({"params": j.params["dit"]}, x, ts, cross2, glob2), 1e-5)
        z = _rand(1, 3, 64, seed=61)
        _close(t.decoder(torch.from_numpy(z)).numpy(),
               _jit(j.decoder)({"params": j.params["dec"]}, z), 1e-5)


@pytest.mark.parametrize("missing", [0, 1, 2])
def test_a_missing_stable_audio_file_raises_in_both(tmp_path, sao_files, small_published,
                                                    missing):
    paths = [str(tmp_path / "absent") if i == missing else p for i, p in enumerate(sao_files)]
    with pytest.raises(FileNotFoundError):
        JV.load_stable_audio_pipeline(*paths)
    with pytest.raises(FileNotFoundError, match="absent"):
        TV.load_stable_audio_pipeline(*paths, device="cpu")


# ------------------------------------------------ ACE-Step (checkpoint layout)

@functools.lru_cache(maxsize=None)
def _ace_parts():
    """(template, port module) of the transformer, the lyric conformer, the
    DCAE and ADaMoS at the small widths."""
    c = JD.ACEStepDiTConfig(**DIT_V)
    jm = JD.ACEStepDiT(c)
    dit_tpl = dict(_tpl(jm, jnp.zeros((1, c.in_channels, c.patch_height, 4)), jnp.ones((1, 4)),
                        jnp.zeros((1, 2, c.text_embedding_dim)), jnp.ones((1, 2)),
                        jnp.zeros((1, c.speaker_embedding_dim)), jnp.full((1,), 0.5),
                        jnp.zeros((1, 3, c.lyric_hidden_size)), jnp.ones((1, 3)),
                        return_hidden=True))
    dit_tpl |= dict(_tpl(jm, jnp.zeros((1, 3), jnp.int32), method=JD.ACEStepDiT.embed_lyrics))
    lyr_tpl = _tpl(JD.LyricConformerEncoder(**LYRIC_V), jnp.zeros((1, 4, 16)), jnp.ones((1, 4)))
    dcae_tpl = _tpl(JDc.AutoencoderDC(JDc.DCAEConfig(**DCAE_V)), jnp.zeros((1, 8, 8, 2)))
    voc_tpl = _tpl(JA.AdamosVocoder(JA.AdamosConfig(**ADAMOS_V)), jnp.zeros((1, 8, 8)))
    return dict(
        dit=(dit_tpl, _port(lambda: TD.ACEStepDiT(TD.ACEStepDiTConfig(**DIT_V)),
                            W.acestep_dit_from_jax, dit_tpl, 70)),
        lyric=(lyr_tpl, _port(lambda: TD.LyricConformerEncoder(**LYRIC_V),
                              W.acestep_lyric_from_jax, lyr_tpl, 71)),
        dcae=(dcae_tpl, _port(lambda: TDc.AutoencoderDC(TDc.DCAEConfig(**DCAE_V)),
                              W.dcae_from_jax, dcae_tpl, 72)),
        voc=(voc_tpl, _port(lambda: TA.AdamosVocoder(TA.AdamosConfig(**ADAMOS_V)),
                            W.adamos_from_jax, voc_tpl, 73)))


def _transformer_file(prefix: str = "") -> dict:
    """``ace_step_transformer``'s weights: the transformer with its lyric
    encoder under ``lyric_encoder.``, ``prefix`` on every key."""
    parts = _ace_parts()
    sd = cpu_state(parts["dit"][1])
    sd.update((f"lyric_encoder.{k}", v) for k, v in cpu_state(parts["lyric"][1]).items())
    return {f"{prefix}{k}": v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _vocoder_file(form: str = "weight_g") -> dict:
    """``music_vocoder``'s weights: the head's 20 weight-norm pairs with the
    gains off, in the old names or torch 2's."""
    sd = gains_off(weight_norm_pairs(cpu_state(_ace_parts()["voc"][1]), ADAMOS_WN), 74)
    assert sum(k.endswith("weight_g") for k in sd) == 20
    return _parametrized(sd) if form == "parametrizations" else sd


@functools.lru_cache(maxsize=None)
def _ace_apply():
    jm = JD.ACEStepDiT(JD.ACEStepDiTConfig(**DIT_V))

    def run(p, text, tmask, spk, lyr, lmask, lat, amask, ts):
        enc, emask = jm.apply({"params": p}, text, tmask, spk, lyr, lmask,
                              method=JD.ACEStepDiT.encode)
        return jm.apply({"params": p}, lat, amask, enc, emask, ts, method=JD.ACEStepDiT.decode)

    return jax.jit(run)


@pytest.mark.parametrize("prefix", ["", "model."])
def test_acestep_dit_loader_matches_jax(tmp_path, prefix):
    """The transformer beside its lyric encoder, bare or under ``model.``:
    equal to the JAX tree (``proj_in``'s Conv2d as the file holds it), the
    velocity of encode + decode on 6 latent frames within 1e-5 of max|y|."""
    path = _write(tmp_path / "diffusion_pytorch_model.safetensors", _transformer_file(prefix))
    tree = JV.load_acestep_dit_checkpoint(path, JD.ACEStepDiTConfig(**DIT_V))
    got = TV.load_acestep_dit_checkpoint(path, TD.ACEStepDiTConfig(**DIT_V), device="cpu")
    _states_equal(got, tiny._load(TD.ACEStepDiT(TD.ACEStepDiTConfig(**DIT_V)),
                                  W.acestep_dit_from_jax(tree)))
    rng = np.random.default_rng(75)
    args = (_rand(2, 3, 16, seed=76), np.ones((2, 3), np.int32), _rand(2, 8, seed=77),
            _rand(2, 4, 16, seed=78), np.ones((2, 4), np.int32), _rand(2, 2, 4, 6, seed=79),
            np.ones((2, 6), np.float32), rng.uniform(1, 999, 2).astype(np.float32))
    with torch.no_grad():
        t = [torch.from_numpy(a) if a.dtype != np.int32 else torch.from_numpy(a).long()
             for a in args]
        enc, emask = got.encode(*t[:5])
        out = got.decode(t[5], t[6], enc, emask, t[7])
    _close(out.numpy(), _ace_apply()(tree, *args), 1e-5)


@pytest.mark.parametrize("whole", [True, False])
def test_acestep_lyric_loader_matches_jax(tmp_path, whole):
    """The lyric conformer from the whole transformer file (``lyric_encoder.``
    stripped, the transformer dropped) or from bare keys: equal to the JAX
    tree, its output on a padded batch within 1e-5 of max|y|."""
    tpl, tm = _ace_parts()["lyric"]
    sd = _transformer_file("model.") if whole else cpu_state(tm)
    path = _write(tmp_path / "diffusion_pytorch_model.safetensors", sd)
    tree = JV.load_acestep_lyric_checkpoint(path, **LYRIC_V)
    got = TV.load_acestep_lyric_checkpoint(path, device="cpu", **LYRIC_V)
    _states_equal(got, tiny._load(TD.LyricConformerEncoder(**LYRIC_V),
                                  W.acestep_lyric_from_jax(tree)))
    x = _rand(2, 5, 16, seed=80)
    mask = np.ones((2, 5), np.int32)
    mask[1, 3:] = 0
    with torch.no_grad():
        out = got(torch.from_numpy(x), torch.from_numpy(mask).long())
    _close(out.numpy(), _jit(JD.LyricConformerEncoder(**LYRIC_V))({"params": tree}, x, mask),
           1e-5)


def _dcae_dir(root) -> str:
    write_acestep_dir(root, {}, cpu_state(_ace_parts()["dcae"][1]), TDc.DCAEConfig(**DCAE_V),
                      {}, {}, b"")
    return str(root / "music_dcae_f8c8")


@functools.lru_cache(maxsize=None)
def _dcae_round_trip():
    jm = JDc.AutoencoderDC(JDc.DCAEConfig(**DCAE_V))
    return jax.jit(lambda p, x: jm.apply({"params": p}, jm.apply(
        {"params": p}, x, method=JDc.AutoencoderDC.encode), method=JDc.AutoencoderDC.decode))


@pytest.mark.parametrize("given", ["directory", "file"])
def test_dcae_loader_matches_jax(tmp_path, given):
    """``music_dcae_f8c8`` as a directory (its ``config.json`` gives the
    configuration) or its weights file with the configuration given: equal
    to the JAX tree, the configuration the written one; once, encode then
    decode of a 8 x 12 two-channel image within 1e-4 of max|y|."""
    d = _dcae_dir(tmp_path)
    cfg_kw = {}
    if given == "file":
        d = f"{d}/diffusion_pytorch_model.safetensors"
        cfg_kw = dict(cfg=JDc.DCAEConfig(**DCAE_V))
    tree, jcfg = JV.load_dcae_checkpoint(d, **cfg_kw)
    got, tcfg = TV.load_dcae_checkpoint(d, device="cpu", **(
        {"cfg": TDc.DCAEConfig(**DCAE_V)} if cfg_kw else {}))
    assert tcfg == TDc.DCAEConfig(**DCAE_V) and jcfg == JDc.DCAEConfig(**DCAE_V)
    _states_equal(got, tiny._load(TDc.AutoencoderDC(tcfg), W.dcae_from_jax(tree)))
    if given == "file":
        return
    x = _rand(2, 8, 12, 2, seed=81)
    with torch.no_grad():
        out = got.decode(got.encode(torch.from_numpy(x).permute(0, 3, 1, 2)))
    _close(out.permute(0, 2, 3, 1).numpy(), _dcae_round_trip()(tree, x), 1e-4)


def test_dcae_weights_file_without_a_config(tmp_path, monkeypatch):
    """A weights file and no ``cfg``: the JAX loader opens the weights file as
    JSON (``config_from_json``) and raises, where its ``except
    FileNotFoundError`` meant to fall back to ``DCAEConfig()``; the port
    takes ``DCAEConfig()`` (the small one here, in both packages' modules)
    (ROADMAP queue 3)."""
    for mod in (JDc, TDc):
        monkeypatch.setattr(mod, "DCAEConfig", functools.partial(mod.DCAEConfig, **DCAE_V))
    path = f"{_dcae_dir(tmp_path)}/diffusion_pytorch_model.safetensors"
    with pytest.raises(ValueError):
        JV.load_dcae_checkpoint(path)
    got, cfg = TV.load_dcae_checkpoint(path, device="cpu")
    assert cfg == TDc.DCAEConfig()
    _states_equal(got, _ace_parts()["dcae"][1])


@functools.lru_cache(maxsize=None)
def _adamos_apply():
    return _jit(JA.AdamosVocoder(JA.AdamosConfig(**ADAMOS_V)))


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
@pytest.mark.parametrize("prefix", ["", "vocoder."])
def test_adamos_state_matches_jax(tmp_path, form, prefix):
    """``music_vocoder``'s weights, bare or under ``vocoder.``, the head's
    pairs (the transposed ``ups`` over their input channels) with the gains
    off, in both of torch's forms: equal to the JAX tree.  Once, the
    waveform of 7 mel frames within 1e-4 of max|y|."""
    tpl, _m = _ace_parts()["voc"]
    sd = {f"{prefix}{k}": v for k, v in _vocoder_file(form).items()}
    path = _write(tmp_path / "diffusion_pytorch_model.safetensors", sd)
    tree = JV.convert_adamos(JV.torch_load_weights(path), tpl)
    got = TV.load_adamos_state(TA.AdamosVocoder(TA.AdamosConfig(**ADAMOS_V)),
                               TV.torch_load_weights(path)).eval()
    _states_equal(got, tiny._load(TA.AdamosVocoder(TA.AdamosConfig(**ADAMOS_V)),
                                  W.adamos_from_jax(tree)))
    if form != "weight_g" or prefix:
        return
    mel = _rand(2, 7, 8, seed=82)
    with torch.no_grad():
        out = got(torch.from_numpy(mel))
    _close(out.numpy(), _adamos_apply()({"params": tree}, mel), 1e-4)


@pytest.fixture(scope="module")
def acestep_dir(tmp_path_factory):
    """ACE-Step's published directory of the small modules."""
    root = tmp_path_factory.mktemp("acestep")
    spm = _spm(root / "spm.model")
    write_acestep_dir(root, _transformer_file(), cpu_state(_ace_parts()["dcae"][1]),
                      TDc.DCAEConfig(**DCAE_V), _vocoder_file(),
                      t5_file_state(cpu_state(_t5(True)[2])), open(spm, "rb").read())
    return root


def test_acestep_pipeline_matches_jax(acestep_dir, small_published):
    """Both packages' pipelines from one directory: every module equal to the
    JAX tree's; the prompt's text states (SentencePiece and UMT5) within
    1e-5 of max|y|, the conditioning (the lyric tokens through the
    transformer's embedding and the conformer, then the transformer's
    encoder) within 1e-5, and ``decode_fn`` (the DCAE, then ADaMoS a channel
    at a time) on seeded latents within 1e-4, each through the assembled
    pipeline's own modules.  The transformer's decode is held by
    test_acestep_dit_loader_matches_jax; ``generate`` runs at full width on
    the card (chip_smoke.py's phase loaders_music)."""
    j = JV.load_acestep_pipeline(str(acestep_dir))
    t = TV.load_acestep_pipeline(str(acestep_dir), device="cpu")
    codec = j.decode_fn.__self__
    for got, sd in ((t.model, W.acestep_dit_from_jax(j.params)),
                    (t.lyric_enc, W.acestep_lyric_from_jax(j.lyric_params)),
                    (t.text_encoder.model, W.t5_from_jax(j.text_encoder.params)),
                    (t.decode_fn.__self__.vocoder, W.adamos_from_jax(codec.vocoder_params))):
        _states_equal(got, tiny._load(type(got)(**LYRIC_V) if got is t.lyric_enc
                                      else type(got)(got.cfg), sd))
    dcae = JV.load_dcae_checkpoint(str(acestep_dir / "music_dcae_f8c8"))[0]
    _states_equal(t.decode_fn.__self__.decoder_fn.model,
                  tiny._load(TDc.AutoencoderDC(TDc.DCAEConfig(**DCAE_V)), W.dcae_from_jax(dcae)))
    j.model, j.lyric_enc = JittedDiT(j.model), tiny.Jitted(j.lyric_enc)
    j.text_encoder.model = tiny.Jitted(j.text_encoder.model)
    codec.vocoder = tiny.Jitted(codec.vocoder)
    hidden, mask = j.text_embeddings([PROMPT])
    th, tmask = t.text_embeddings([PROMPT])
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    _close(th.numpy(), hidden, 1e-5)
    spk = _rand(1, 8, seed=83)
    toks = np.random.default_rng(84).integers(1, 32, (1, 5)).astype(np.int32)
    lmask = np.ones((1, 5), np.int32)
    enc, emask = j.encode_cond(hidden, mask, jnp.asarray(spk), jnp.asarray(toks),
                               jnp.asarray(lmask))
    tenc, temask = t.encode_cond(th, tmask, torch.from_numpy(spk),
                                 torch.from_numpy(toks).long(), torch.from_numpy(lmask).long())
    np.testing.assert_array_equal(temask.numpy(), np.asarray(emask))
    _close(tenc.numpy(), enc, 1e-5)
    lat = _rand(1, 2, 4, 3, seed=85)
    want = j.decode_fn(jnp.asarray(lat))
    got = t.decode_fn(torch.from_numpy(lat))
    assert got.shape == want.shape == (1, 2, 3 * 2 * 8)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("part", ["", "ace_step_transformer", "music_dcae_f8c8",
                                  "music_vocoder", "umt5-base"])
def test_a_missing_acestep_part_raises_in_both(tmp_path, acestep_dir, small_published, part):
    """An empty directory, or the directory without one of its four parts:
    ``FileNotFoundError`` naming the part in both packages."""
    if part:
        shutil.copytree(acestep_dir, tmp_path, dirs_exist_ok=True)
        shutil.rmtree(tmp_path / part)
    name = re.escape(part or "ace_step_transformer")
    with pytest.raises(FileNotFoundError, match=name):
        JV.load_acestep_pipeline(str(tmp_path))
    with pytest.raises(FileNotFoundError, match=name):
        TV.load_acestep_pipeline(str(tmp_path), device="cpu")


# ------------------------------------------------------------ CLAP, Vocos

@functools.lru_cache(maxsize=None)
def _clap():
    """(text template, port text branch, audio template, port audio branch)."""
    ttpl = _tpl(JC.ClapTextBranch(JC.ClapTextConfig(**CLAP_TEXT)), jnp.zeros((1, 4), jnp.int32),
                jnp.ones((1, 4), jnp.int32))
    atpl = _tpl(JC.ClapAudioBranch(JC.ClapAudioConfig(**CLAP_AUDIO)), jnp.zeros((1, 64, 64, 1)))
    return (ttpl, _port(lambda: TC.ClapTextBranch(TC.ClapTextConfig(**CLAP_TEXT)),
                        W.clap_text_from_jax, ttpl, 90),
            atpl, _port(lambda: TC.ClapAudioBranch(TC.ClapAudioConfig(**CLAP_AUDIO)),
                        W.clap_audio_from_jax, atpl, 91))


def _clap_file() -> dict:
    _t, text, _a, audio = _clap()
    return laion_clap_state(cpu_state(text), cpu_state(audio), 92, n_mels=16, n_fft=32,
                            classes=5)


def _clap_loaders(branch: str):
    """(the JAX loader, the port loader) of a branch, each on a file's path."""
    if branch == "text":
        return (lambda p: JV.load_clap_text_checkpoint(p, cfg=JC.ClapTextConfig(**CLAP_TEXT)),
                lambda p: TV.load_clap_text_checkpoint(p, device="cpu",
                                                       cfg=TC.ClapTextConfig(**CLAP_TEXT)))
    return (lambda p: JV.load_clap_audio_checkpoint(p, cfg=JC.ClapAudioConfig(**CLAP_AUDIO)),
            lambda p: TV.load_clap_audio_checkpoint(p, device="cpu",
                                                    cfg=TC.ClapAudioConfig(**CLAP_AUDIO)))


@pytest.mark.parametrize("branch", ["text", "audio"])
def test_clap_loaders_match_jax(tmp_path, branch):
    """Each branch from one laion_clap file (``module.`` on every key, the
    other branch, ``logit_scale_*``, ``position_ids``, HTSAT's extractors,
    ``bn0`` and TSCAM head beside it): equal to the JAX tree, the embedding
    within 1e-5 of max|y| (the text of a padded batch, the audio of a 64 x 64
    mel image)."""
    path = _write(tmp_path / "630k-audioset-best.pt", _clap_file())
    jax_load, port_load = _clap_loaders(branch)
    tree, got = jax_load(path), port_load(path)
    if branch == "text":
        _states_equal(got, tiny._load(TC.ClapTextBranch(got.cfg), W.clap_text_from_jax(tree)))
        ids = np.random.default_rng(93).integers(3, 60, (2, 7)).astype(np.int32)
        ids[:, 0] = 0
        ids[1, 5:] = 1
        mask = (ids != 1).astype(np.int32)
        with torch.no_grad():
            out = got(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        want = _jit(JC.ClapTextBranch(JC.ClapTextConfig(**CLAP_TEXT)))({"params": tree},
                                                                      ids, mask)
    else:
        _states_equal(got, tiny._load(TC.ClapAudioBranch(got.cfg), W.clap_audio_from_jax(tree)))
        img = _rand(2, 64, 64, 1, seed=94)
        with torch.no_grad():
            out = got(torch.from_numpy(img).permute(0, 3, 1, 2))
        want = _jit(JC.ClapAudioBranch(JC.ClapAudioConfig(**CLAP_AUDIO)))({"params": tree}, img)
    _close(out.numpy(), want, 1e-5)


@functools.lru_cache(maxsize=None)
def _vocos():
    tpl = _tpl(JCo.Vocos(JCo.VocosConfig(**VOCOS_V)), jnp.zeros((1, 8, VOCOS_IN)))
    return tpl, _port(lambda: TCo.Vocos(TCo.VocosConfig(**VOCOS_V), in_dim=VOCOS_IN),
                      W.vocos_from_jax, tpl, 95)


def _vocos_file() -> dict:
    return vocos_file_state(cpu_state(_vocos()[1]), VOCOS_IN, 96)


def test_vocos_loader_matches_jax(tmp_path):
    """charactr/vocos' ``pytorch_model.bin`` with its feature extractor's and
    iSTFT's buffers: the configuration read from the file's shapes equal in
    both, the model equal to the JAX tree, the audio of 10 mel frames within
    1e-5 of max|y|."""
    path = _write(tmp_path / "pytorch_model.bin", _vocos_file())
    tree, jcfg = JV.load_vocos_checkpoint(path)
    got, tcfg = TV.load_vocos_checkpoint(path, device="cpu")
    assert vars(jcfg) == vars(tcfg) == dict(VOCOS_V, ffn_mult=3)
    _states_equal(got, tiny._load(TCo.Vocos(tcfg, in_dim=VOCOS_IN), W.vocos_from_jax(tree)))
    mel = _rand(1, 10, VOCOS_IN, seed=97)
    with torch.no_grad():
        out = got(torch.from_numpy(mel))
    _close(out.numpy(), _jit(JCo.Vocos(jcfg))({"params": tree}, mel), 1e-5)


def test_vocos_with_a_config_reads_the_input_width_from_the_file(tmp_path):
    """Given a ``cfg``, the JAX loader traces its template on ``cfg.dim``
    input channels and refuses a file whose input width differs (12 mel bins
    into 16 channels here); the port reads the width from the file and
    loads it (ROADMAP queue 3)."""
    path = _write(tmp_path / "pytorch_model.bin", _vocos_file())
    with pytest.raises(ValueError, match="backbone/embed|embed/kernel"):
        JV.load_vocos_checkpoint(path, JCo.VocosConfig(**VOCOS_V))
    got, cfg = TV.load_vocos_checkpoint(path, TCo.VocosConfig(**VOCOS_V), device="cpu")
    assert cfg == TCo.VocosConfig(**VOCOS_V)
    _states_equal(got, _vocos()[1])


# --------------------------------------------- a missing key, a wrong shape

def _state_loaders(jax_convert, port_load, make):
    return (lambda p: jax_convert(JV.torch_load_weights(p)),
            lambda p: port_load(make(), TV.torch_load_weights(p)))


def _dcae_file() -> dict:
    return cpu_state(_ace_parts()["dcae"][1])


# format: (the upstream state_dict, a key the loader reads (the file's name,
#          the port module's), the JAX loader, the port loader); each loader
#          takes the file's path
FORMATS = {
    "t5": (lambda: t5_file_state(cpu_state(_t5(False)[2])),
           ("encoder.final_layer_norm.weight",) * 2,
           lambda p: JV.load_t5_encoder(p, JT.T5Config(**T5_V)),
           lambda p: TV.load_t5_encoder(p, TT.T5Config(**T5_V), device="cpu")),
    "sao_number": (_sao_file, ("conditioner.conditioners.seconds_total.embedder.embedding.1.bias",
                               "embedding.1.bias"),
                   *_state_loaders(lambda sd: JV.convert_sao_number(
                       sd, _sao_parts()["st"][0], "seconds_total"),
                       lambda m, sd: TV.load_sao_number_state(m, sd, "seconds_total"),
                       lambda: TS.NumberEmbedder(features=768))),
    "oobleck": (_sao_file, ("pretransform.model.decoder.layers.1.layers.0.alpha",
                            "layers.1.layers.0.alpha"),
                *_state_loaders(lambda sd: JV.convert_oobleck(sd, _sao_parts()["dec"][0]),
                                TV.load_oobleck_state,
                                lambda: TSD.OobleckDecoder(TSD.OobleckConfig(**VAE_V)))),
    "sao_dit": (_sao_file, ("model.model.transformer.layers.0.ff.ff.2.bias",
                            "transformer.layers.0.ff.ff.2.bias"),
                lambda p: JV.load_sao_dit_checkpoint(p, JSD.SAODiTConfig(**SAO_V)),
                lambda p: TV.load_sao_dit_checkpoint(p, TSD.SAODiTConfig(**SAO_V),
                                                     device="cpu")),
    "acestep_dit": (_transformer_file, ("final_layer.linear.bias",) * 2,
                    lambda p: JV.load_acestep_dit_checkpoint(p, JD.ACEStepDiTConfig(**DIT_V)),
                    lambda p: TV.load_acestep_dit_checkpoint(p, TD.ACEStepDiTConfig(**DIT_V),
                                                             device="cpu")),
    "acestep_lyric": (_transformer_file, ("lyric_encoder.after_norm.bias", "after_norm.bias"),
                      lambda p: JV.load_acestep_lyric_checkpoint(p, **LYRIC_V),
                      lambda p: TV.load_acestep_lyric_checkpoint(p, device="cpu", **LYRIC_V)),
    "dcae": (_dcae_file, ("decoder.conv_out.bias",) * 2,
             lambda p: JV.load_dcae_checkpoint(p, JDc.DCAEConfig(**DCAE_V)),
             lambda p: TV.load_dcae_checkpoint(p, TDc.DCAEConfig(**DCAE_V), device="cpu")),
    "adamos": (_vocoder_file, ("head.conv_post.bias",) * 2,
               *_state_loaders(lambda sd: JV.convert_adamos(sd, _ace_parts()["voc"][0]),
                               TV.load_adamos_state,
                               lambda: TA.AdamosVocoder(TA.AdamosConfig(**ADAMOS_V)))),
    "clap_text": (_clap_file, ("module.text_projection.2.bias", "text_projection.2.bias"),
                  *_clap_loaders("text")),
    "clap_audio": (_clap_file, ("module.audio_projection.2.bias", "audio_projection.2.bias"),
                   *_clap_loaders("audio")),
    "vocos": (_vocos_file, ("head.out.bias",) * 2, lambda p: JV.load_vocos_checkpoint(p),
              lambda p: TV.load_vocos_checkpoint(p, device="cpu")),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_missing_key_raises_in_both(tmp_path, fmt):
    source, (key, port_key), jax_load, port_load = FORMATS[fmt]
    sd = dict(source())
    del sd[key]
    path = _write(tmp_path / "missing.safetensors", sd)
    with pytest.raises(ValueError, match="missing torch key"):
        jax_load(path)
    with pytest.raises(KeyError, match=re.escape(repr(port_key))):
        port_load(path)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_wrong_shape_raises_in_both(tmp_path, fmt):
    source, (key, _), jax_load, port_load = FORMATS[fmt]
    sd = dict(source())
    sd[key] = torch.zeros(sd[key].shape[0] + 1)
    path = _write(tmp_path / "wrong.safetensors", sd)
    with pytest.raises(ValueError, match="shape"):
        jax_load(path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_load(path)
