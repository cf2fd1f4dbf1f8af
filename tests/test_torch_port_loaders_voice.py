"""The port's checkpoint loaders of the rest of the speech and cloning engines
(audiolab_tpu_torch/utils/convert.py: Zonos's state and prefix bank,
OpenVoice's converter, Chatterbox's five converters and its one-call
pipeline) and its repaired ``ChatterboxTokenizer`` against the JAX package's
(audiolab_tpu/utils/convert.py, audiolab_tpu/pipelines/tts.py), on the CPU,
on files the tests write in the upstream layouts from seeded port modules at
small widths (``tests/torch_port_tiny.py``'s ``ZONOS`` with the Mamba2
mixer and the Chatterbox ``*_TINY`` modules, ``tests/test_torch_port_
cloning.py``'s ``OV``, the published prefix bank at width 32).

Each case reads one file or directory with both packages: the JAX tree
reaches the port through ``utils/weights.py``'s ``*_from_jax``, and its
state_dict must equal, bit for bit, the one the port's loader gives; both
packages then run the loaded model on one seeded input at the tolerance of
the module's parity test (Zonos's prefill logits and the prefix bank 1e-5
of max|y|, the OpenVoice conversion 1e-4 and its speaker embedding 1e-5, T3's
logits, the voice encoder's and CAMPPlus's embeddings 1e-5, S3Gen's
waveform 1e-4, the S3 tokenizer's ids identical, the pipeline's waveform
1e-4 under the JAX keys' draws).

The files hold what the JAX converter folds (weight-norm pairs with each
gain off its weight's norm, in both of torch's forms; the reference GRU's
biases), what it keeps (CAMPPlus's batch-norm statistics, off their
initial values), tensors it ignores (S3Gen's bundled encoders beside the
flow, Zonos's backbone beside the bank) and the prefixes it strips.  The
one-call pipeline hard-codes the published configurations: its case swaps
the config classes each loader looks up in both packages for the small
ones, and one case holds the published geometries of the voice encoder,
CAMPPlus and HiFT without a forward.  Every JAX template comes from
``jax.eval_shape``; no flax ``init`` runs.
"""

import copy
import dataclasses
import functools
import json
import pathlib
import re
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import campplus as JCp
from audiolab_tpu.models import chatterbox_s3gen as JS
from audiolab_tpu.models import chatterbox_t3 as JT3
from audiolab_tpu.models import openvoice as JO
from audiolab_tpu.models import s3tokenizer as JS3
from audiolab_tpu.models import zonos as JZ
from audiolab_tpu.pipelines import tts as JT
from audiolab_tpu.utils import convert as JV
from audiolab_tpu_torch.models import campplus as TCp
from audiolab_tpu_torch.models import chatterbox_s3gen as TS
from audiolab_tpu_torch.models import chatterbox_t3 as TT3
from audiolab_tpu_torch.models import openvoice as TO
from audiolab_tpu_torch.models import s3tokenizer as TS3
from audiolab_tpu_torch.models import zonos as TZ
from audiolab_tpu_torch.pipelines import tts as TT
from audiolab_tpu_torch.utils import convert as TV
from audiolab_tpu_torch.utils import weights as W
from chip_smoke import (
    HIFT_WN,
    OPENVOICE_WN,
    ZONOS_OWN,
    bpe_tokenizer_json,
    chatterbox_conds,
    cpu_state,
    gains_off,
    weight_norm_pairs,
    write_chatterbox_dir,
    write_safetensors,
    zonos_config_conditioners,
)
from tests import torch_port_tiny as tiny
from tests.test_torch_port_loaders import _states_equal
from tests.test_torch_port_loaders_listen import _close, _parametrized, _save
from tests.test_torch_port_zonos import _cond, _prefix_inputs
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
# tests/test_torch_port_cloning.py's converter with two up-sampling stages
# (the JAX mapping takes three residual kernels of three dilations a stage)
OV = dict(sr=8000, n_fft=128, hop=32, spec_channels=65, inter_channels=8, hidden_channels=8,
          gin_channels=16, upsample_rates=(8, 4), upsample_kernel_sizes=(16, 8),
          upsample_initial_channel=32)
# S3TokenizerConfig's fields the pipeline cannot read from the file
S3TOK_REST = {k: tiny.S3TOK_TINY[k] for k in ("n_head", "n_ctx", "fsmn_kernel", "fsq_dim")}


def _traced_once(cls):
    """``cls`` (a flax module) whose ``init`` is traced once per configuration
    and argument shapes: later calls give the first trace's shapes.  Every
    JAX loader and template here takes only shapes from ``init`` (through
    ``jax.eval_shape``), and a trace of the larger models costs seconds."""
    cache: dict = {}

    class TracedOnce(cls):
        def init(self, rng, *args, **kw):
            key = (repr(self), repr(kw), tuple((np.shape(a), str(getattr(a, "dtype", "")))
                                               for a in args))
            if key not in cache:
                cache[key] = jax.tree_util.tree_map(
                    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                    cls.init(self, rng, *args, **kw))
            return cache[key]

    return TracedOnce


@pytest.fixture(autouse=True, scope="module")
def _templates_traced_once():
    """The JAX modules whose templates the loaders and tests here trace,
    each traced once for the module (tests/torch_port_tiny.py's model makers and
    the JAX loaders trace the same configurations)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((JO, "ToneColorConverter"), (JT3, "T3"), (JT3, "VoiceEncoder"),
                          (JS, "CausalMaskedDiffWithXvec"), (JS, "HiFTGenerator"),
                          (JCp, "CAMPPlus"), (JS3, "S3TokenizerV2"), (JZ, "ZonosModel"),
                          (JZ, "ZonosPrefixConditioner")):
            mp.setattr(mod, name, _traced_once(getattr(mod, name)))
        yield


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _write(path, sd: dict) -> str:
    path = str(path)
    if path.endswith(".safetensors"):
        write_safetensors(path, sd)
    else:
        torch.save(sd, path)
    return path


# ------------------------------------------------------------------ Zonos

def _zonos(seed: int):
    """(JAX config, flax params, port model) of the Mamba2 hybrid at ZONOS."""
    return tiny.zonos("mamba2", seed=seed)


@functools.lru_cache(maxsize=None)
def _zonos_file() -> dict:
    """Zyphra's ``model.safetensors`` from the seed-6 model (the backbone,
    ``embeddings.q``, ``heads.q``), its prefix bank under
    ``prefix_conditioner.``, and the port's own conditioning names at other
    values (no loader may read them)."""
    sd = {k: v for k, v in cpu_state(_zonos(6)[2]).items() if not k.startswith(ZONOS_OWN)}
    sd.update((k, v + 1.0) for k, v in cpu_state(_zonos(6)[2]).items()
              if k.startswith(ZONOS_OWN))
    sd.update((f"prefix_conditioner.{k}", v) for k, v in cpu_state(_bank("mlp")[3]).items())
    return sd


@functools.lru_cache(maxsize=None)
def _zonos_prefill():
    jm = JZ.ZonosModel(_zonos(6)[0])
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, 12, method=JZ.ZonosModel.prefill))


def test_zonos_state_matches_jax(tmp_path):
    """The seed-6 file into the seed-7 model: its backbone, embeddings and
    heads become the file's, its conditioning branches (``text_emb``,
    ``spk_proj``, ``emotion``, ``rate``, ``pitch``) stay the module's in both
    packages; the prefill logits within 1e-5 of max|logit|."""
    path = _write(tmp_path / "model.safetensors", _zonos_file())
    cfg, p7, tm7 = _zonos(7)
    tree = JV.convert_zonos(JV.torch_load_weights(path), p7, cfg)
    got = TV.load_zonos_state(copy.deepcopy(tm7), TV.torch_load_weights(path))
    _states_equal(got, tiny._load(TZ.ZonosModel(tm7.cfg), W.zonos_from_jax(tree)))
    own, file6 = tm7.state_dict(), _zonos(6)[2].state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, own[k] if k.startswith(ZONOS_OWN) else file6[k]), k
    x = _prefix_inputs(cfg)
    bos = np.full((2, cfg.n_codebooks, 1), cfg.masked_id, np.int32)
    args = (x["text_ids"], x["spk"], x["emotion"], x["rate"], x["pitch"], bos)
    ref = _zonos_prefill()(tree, *args)[0]
    with torch.no_grad():
        out = got.prefill(*(torch.from_numpy(a).long() if a.dtype == np.int32
                            else torch.from_numpy(a) for a in args), 12)[0]
    _close(out.numpy(), ref, 1e-5)


def test_zonos_mamba1_layers_are_refused_by_both():
    """A Mamba1 model: both converters refuse it before they read a key."""
    kw = dict(tiny.ZONOS, mixer="mamba1")
    cfg = JZ.ZonosConfig(**kw)
    bos = jnp.full((1, cfg.n_codebooks, 1), cfg.masked_id, jnp.int32)
    tpl = jax.eval_shape(lambda: JZ.ZonosModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, cfg.spk_dim)),
        jnp.zeros((1, 8)), jnp.zeros((1, 1)), jnp.zeros((1, 1)), bos, 16,
        method=JZ.ZonosModel.prefill))["params"]
    with pytest.raises(ValueError, match="mixer='mamba2'"):
        JV.convert_zonos(_zonos_file(), tpl, cfg)
    with pytest.raises(ValueError, match="mixer='mamba2'"):
        TV.load_zonos_state(TZ.ZonosModel(TZ.ZonosConfig(**kw)), _zonos_file())


def test_zonos_wrong_shapes_pass_the_jax_converter_and_not_the_port(tmp_path):
    """The JAX converter fills non-strictly: a wrong-shaped ``norm_f`` comes
    back in the file's shape, and a file without one codebook's embedding
    gives a short offset table.  The port refuses both (ROADMAP queue 3)."""
    cfg, p7, tm7 = _zonos(7)
    wrong = dict(_zonos_file())
    wrong["backbone.norm_f.weight"] = torch.zeros(cfg.dim + 1)
    tree = JV.convert_zonos(JV.torch_load_weights(_write(tmp_path / "w.safetensors", wrong)),
                            p7, cfg)
    assert np.asarray(tree["backbone"]["final_norm"]["weight"]).shape == (cfg.dim + 1,)
    with pytest.raises(RuntimeError, match="size mismatch"):
        TV.load_zonos_state(copy.deepcopy(tm7), wrong)
    short = {k: v for k, v in _zonos_file().items() if k != "embeddings.1.weight"}
    tree = JV.convert_zonos(JV.torch_load_weights(_write(tmp_path / "s.safetensors", short)),
                            p7, cfg)
    assert np.asarray(tree["code_embs"]["embedding"]).shape == (2 * cfg.codebook_size, cfg.dim)
    with pytest.raises(KeyError, match=re.escape("'embeddings.1.weight'")):
        TV.load_zonos_state(copy.deepcopy(tm7), short)


# ------------------------------------------------------- Zonos prefix bank

@functools.lru_cache(maxsize=None)
def _bank(projection: str, seed: int = 12):
    """(flax module, its eval_shape template, flax params, port bank) of the
    published conditioner list at width 32 (test_torch_port_zonos's)."""
    jm = JZ.ZonosPrefixConditioner(32, JZ.DEFAULT_ZONOS_CONDITIONERS, projection)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jax.tree_util.tree_map(
        jnp.asarray, _cond(128, 0))))["params"]
    p = tiny.filled(tpl, seed)
    specs = tuple(TZ.CondSpec(**dataclasses.asdict(s)) for s in JZ.DEFAULT_ZONOS_CONDITIONERS)
    tm = TZ.ZonosPrefixConditioner(32, specs, projection)
    return jm, tpl, p, tiny._load(tm, W.zonos_prefix_from_jax(p, specs, projection))


@functools.lru_cache(maxsize=None)
def _bank_apply(projection: str):
    return jax.jit(lambda p, cond: _bank(projection)[0].apply({"params": p}, cond))


def _specs():
    """Both packages' specs from one ``config.json`` conditioner list."""
    listed = json.loads(json.dumps(zonos_config_conditioners(TZ.DEFAULT_ZONOS_CONDITIONERS)))
    jspecs, tspecs = (JV.zonos_prefix_specs_from_config(listed),
                      TV.zonos_prefix_specs_from_config(listed))
    assert jspecs == JZ.DEFAULT_ZONOS_CONDITIONERS and tspecs == TZ.DEFAULT_ZONOS_CONDITIONERS
    return jspecs, tspecs


@pytest.mark.parametrize("projection", ["none", "mlp"])
@pytest.mark.parametrize("prefix", ["model.prefix_conditioner.", "prefix_conditioner."])
def test_zonos_prefix_bank_matches_jax(tmp_path, prefix, projection):
    """The bank under either prefix beside the backbone's tensors, its specs
    read from a ``config.json`` conditioner list: equal to the JAX tree, its
    output for every slot within 1e-5 of max|y|."""
    _jm, tpl, _p, tm = _bank(projection)
    sd = {f"{prefix}{k}": v for k, v in cpu_state(tm).items()}
    sd["backbone.norm_f.weight"] = torch.ones(32)
    path = _write(tmp_path / "model.safetensors", sd)
    jspecs, tspecs = _specs()
    tree = JV.convert_zonos_prefix(JV.torch_load_weights(path), tpl, jspecs, projection)
    got = TV.load_zonos_prefix_state(TZ.ZonosPrefixConditioner(32, tspecs, projection),
                                     TV.torch_load_weights(path))
    _states_equal(got, tiny._load(TZ.ZonosPrefixConditioner(32, tspecs, projection),
                                  W.zonos_prefix_from_jax(tree, tspecs, projection)))
    cond = _cond(128, 1)
    ref = _bank_apply(projection)(tree, cond)
    with torch.no_grad():
        out = got({k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()})
    _close(out.numpy(), ref, 1e-5)


# -------------------------------------------------------------- OpenVoice

@functools.lru_cache(maxsize=None)
def _openvoice_file(form: str) -> dict:
    """The converter's names with every weight-norm pair's gain off its
    weight's norm (the reference encoder's 2-D convolutions, the WaveNet
    layers, HiFiGAN's residual convolutions, ``conv_post`` and transposed
    up-convolutions), the GRU's biases off their init, in the old names or
    torch 2's."""
    src = tiny.seeded(lambda: TO.ToneColorConverter(TO.ToneColorConfig(**OV)), 9, 0.05)
    sd = gains_off(weight_norm_pairs(cpu_state(src), OPENVOICE_WN), 97)
    assert sum(k.endswith("weight_g") for k in sd) > 10
    return _parametrized(sd) if form == "parametrizations" else sd


def _write_openvoice(path, sd: dict, nested: bool) -> str:
    """``converter.pth`` as OpenVoice saves it (``{"model": state_dict}``
    beside the trainer's entries), or flat with ``model.`` on every key."""
    torch.save({"model": sd, "iteration": 1000} if nested
               else {f"model.{k}": v for k, v in sd.items()}, path)
    return str(path)


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
@pytest.mark.parametrize("nested", [True, False])
def test_openvoice_loader_matches_jax(tmp_path, form, nested):
    """Both packages' converters from one ``converter.pth``, nested under
    ``model`` or flat: equal to the JAX tree.  The JAX loader reads torch
    2's pairs everywhere but in the reference encoder's 2-D convolutions
    (``convwn2d_w`` knows only ``weight_g`` / ``weight_v``), so in that form
    the port's load is held against the JAX load of the same numbers in the
    old names, and the JAX loader's refusal of the file is shown (ROADMAP
    queue 3).  Once, the speaker embeddings of two reference spectrograms
    through the reference encoder (its 2-D convolutions and GRU are what
    this format alone folds) within 1e-5 of max|g|; the conversion path's
    layouts are RVC's, held by test_torch_port_cloning.py."""
    cfg = TO.ToneColorConfig(**OV)
    path = _write_openvoice(tmp_path / "converter.pth", _openvoice_file(form), nested)
    got = TV.load_openvoice_checkpoint(path, cfg, device="cpu")
    if form == "parametrizations":
        with pytest.raises(ValueError, match=r"ref_enc\.convs\.0"):
            JV.load_openvoice_checkpoint(path, JO.ToneColorConfig(**OV))
        path = _write_openvoice(tmp_path / "old.pth", _openvoice_file("weight_g"), nested)
    params = JV.load_openvoice_checkpoint(path, JO.ToneColorConfig(**OV))
    _states_equal(got, tiny._load(TO.ToneColorConverter(cfg), W.openvoice_from_jax(params)))
    if form != "weight_g" or not nested:
        return
    spec = np.abs(_rand(2, 24, OV["spec_channels"], seed=30))
    ref = jax.jit(lambda p, x: JO.ToneColorConverter(JO.ToneColorConfig(**OV)).apply(
        {"params": p}, x, method=JO.ToneColorConverter.extract_se))(params, spec)
    with torch.no_grad():
        _close(got.extract_se(torch.from_numpy(spec)).numpy(), ref, 1e-5)


# ------------------------------------------------------------- Chatterbox
#
# The Chatterbox modules at tests/torch_port_tiny.py's widths with fewer
# layers (the JAX side's traces cost about a second a block): T3 of one
# layer, the flow of one conformer layer, one mid block and one CFM step,
# HiFT with one residual kernel of one dilation a stage.  Each JAX template
# is the one the pipeline's loader traces (T3 at max_seq_len 4096, the same
# arguments), so each is traced once.
T3_V = dict(tiny.T3_TINY, n_layers=1)
FLOW_V = dict(tiny.FLOW_TINY, n_layers=1, est_mid_blocks=1, n_timesteps=1)
HIFT_V = dict(tiny.HIFT_TINY, resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
              source_resblock_dilations=((1,), (1,), (1,)))


@functools.lru_cache(maxsize=None)
def _t3(seed: int = 40):
    """(JAX config, template, port T3 of ``filled`` weights) at T3_V."""
    cfg = JT3.T3CkptConfig(**T3_V)
    tpl = jax.eval_shape(lambda: JT3.T3(cfg, max_seq_len=4096).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, cfg.speaker_embed_size)), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1,))))["params"]
    return cfg, tpl, tiny._load(TT3.T3(TT3.T3CkptConfig(**T3_V), max_seq_len=4096),
                                W.chatterbox_t3_from_jax(tiny.filled(tpl, seed)))


@functools.lru_cache(maxsize=None)
def _s3gen(seed: int = 42):
    """(flow template, HiFT template, port S3Token2Wav) at FLOW_V / HIFT_V,
    HiFT's variances and Snake alphas positive (torch_port_tiny.s3gen)."""
    fcfg, hcfg = JS.FlowConfig(**FLOW_V), JS.HiFTConfig(**HIFT_V)
    ftpl = jax.eval_shape(lambda: JS.CausalMaskedDiffWithXvec(fcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32), jnp.zeros((1, fcfg.xvector_dim)),
        jnp.zeros((1, 2, fcfg.mel_dim)), jnp.zeros((1, 6, fcfg.mel_dim))))["params"]
    htpl = jax.eval_shape(lambda: JS.HiFTGenerator(hcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, hcfg.in_channels)),
        jax.random.PRNGKey(1)))["params"]
    fp, hp = tiny.filled(ftpl, seed), tiny._positive(tiny.filled(htpl, seed + 1), seed + 2)
    sd = {**W.s3gen_flow_from_jax(fp, "flow."), **W.hift_from_jax(hp, "mel2wav.")}
    return ftpl, htpl, tiny._load(_small_s3gen(), sd)


def _small_s3gen(hift=None):
    return TS.S3Token2Wav(TS.FlowConfig(**FLOW_V), hift or TS.HiFTConfig(**HIFT_V))


def _t3_file() -> dict:
    """``t3_cfg.safetensors`` (``tfmr.layers.N``) with the LlamaModel's unused
    ``tfmr.embed_tokens`` beside them."""
    sd = cpu_state(_t3()[2])
    sd["tfmr.embed_tokens.weight"] = torch.zeros(8, T3_V["dim"])
    return sd


@functools.lru_cache(maxsize=None)
def _t3_apply():
    return jax.jit(JT3.T3(_t3()[0], max_seq_len=4096).apply)


def test_chatterbox_t3_state_matches_jax(tmp_path):
    """``t3_cfg.safetensors`` into a freshly made T3: equal to the JAX tree,
    the teacher-forced logits (7 text, 4 prompt, 9 speech tokens) within
    1e-5 of max|logit|."""
    cfg, tpl, tm = _t3()
    path = _write(tmp_path / "t3_cfg.safetensors", _t3_file())
    tree = JV.convert_chatterbox_t3(JV.torch_load_weights(path), tpl)
    got = TV.load_chatterbox_t3_state(TT3.T3(tm.cfg, max_seq_len=4096),
                                      TV.torch_load_weights(path)).eval()
    _states_equal(got, tiny._load(TT3.T3(tm.cfg, max_seq_len=4096),
                                  W.chatterbox_t3_from_jax(tree)))
    rng = np.random.default_rng(20)
    speech = rng.integers(0, 30, (1, 9))
    speech[:, 0] = cfg.start_speech_token
    args = (rng.integers(1, cfg.text_vocab, (1, 7)), speech,
            _rand(1, cfg.speaker_embed_size, seed=21), rng.integers(0, 30, (1, 4)),
            np.asarray([0.7], np.float32))
    ref = _t3_apply()({"params": tree}, *args)
    with torch.no_grad():
        out = got(*map(torch.from_numpy, args))
    for o, r in zip(out, ref):
        _close(o.numpy(), r, 1e-5)


@functools.lru_cache(maxsize=None)
def _ve_apply():
    return jax.jit(JT3.VoiceEncoder().apply)


def test_voice_encoder_state_matches_jax(tmp_path):
    """``ve.safetensors`` (torch's LSTM layout, ``proj``): equal to the JAX
    tree, the embeddings of 40 mel frames within 1e-5."""
    tpl, _p, tm = tiny.voice_encoder()
    path = _write(tmp_path / "ve.safetensors", cpu_state(tm))
    tree = JV.convert_voice_encoder(JV.torch_load_weights(path), tpl)
    got = TV.load_voice_encoder_state(TT3.VoiceEncoder(), TV.torch_load_weights(path)).eval()
    _states_equal(got, tiny._load(TT3.VoiceEncoder(), W.voice_encoder_from_jax(tree)))
    mels = np.abs(_rand(2, 40, 40, seed=23))
    with torch.no_grad():
        out = got(torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(out, _ve_apply()({"params": tree}, mels), atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _s3gen_file(form: str = "weight_g") -> dict:
    """``s3gen.safetensors``: the flow and HiFT (every HiFT weight-norm pair's
    gain off its weight's norm, in the old names or torch 2's) with CAMPPlus
    under ``speaker_encoder.`` and the S3 tokenizer under ``tokenizer.``."""
    sd = gains_off(weight_norm_pairs(cpu_state(_s3gen()[2]), HIFT_WN), 98)
    assert sum(k.endswith("weight_g") for k in sd) > 10
    sd = _parametrized(sd) if form == "parametrizations" else sd
    sd.update((f"speaker_encoder.{k}", v) for k, v in cpu_state(tiny.campplus()[3]).items())
    sd.update((f"tokenizer.{k}", v) for k, v in cpu_state(tiny.s3tokenizer()[3]).items())
    return sd


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
def test_s3gen_state_matches_jax(tmp_path, form):
    """``s3gen.safetensors`` with its bundled encoders: the flow and HiFT
    equal to the JAX trees (HiFT's pairs folded), the fixed noise the
    module's own.  Both run, loaded by the same function from this file, in
    the pipeline's case (``synthesize``)."""
    ftpl, htpl, _tm = _s3gen()
    path = _write(tmp_path / "s3gen.safetensors", _s3gen_file(form))
    fp, hp = JV.convert_s3gen(JV.torch_load_weights(path), ftpl, htpl)
    fresh = _small_s3gen()
    noise = fresh.rand_noise.clone()
    got = TV.load_s3gen_state(fresh, TV.torch_load_weights(path)).eval()
    _states_equal(got, tiny._load(_small_s3gen(), {**W.s3gen_flow_from_jax(fp, "flow."),
                                                   **W.hift_from_jax(hp, "mel2wav.")}))
    assert torch.equal(got.rand_noise, noise)


@functools.lru_cache(maxsize=None)
def _campplus_apply():
    return jax.jit(JCp.CAMPPlus(tiny.campplus()[0]).apply)


def test_campplus_state_matches_jax(tmp_path):
    """CAMPPlus under ``speaker_encoder.`` in ``s3gen.safetensors``: its
    batch norms with their statistics (off their init; the affine-free
    dense norm too) equal to the JAX tree, the embedding of 50 frames within
    1e-5 of max|y|."""
    cfg, tpl, _p, tm = tiny.campplus()
    assert float((tm.state_dict()["xvector.dense.nonlinear.batchnorm.running_var"] - 1)
                 .abs().min()) > 0
    path = _write(tmp_path / "s3gen.safetensors", _s3gen_file())
    tree = JV.convert_campplus(JV.torch_load_weights(path), tpl, prefix="speaker_encoder.")
    got = TV.load_campplus_state(TCp.CAMPPlus(tm.cfg), TV.torch_load_weights(path),
                                 prefix="speaker_encoder.").eval()
    _states_equal(got, tiny._load(TCp.CAMPPlus(tm.cfg), W.campplus_from_jax(tree)))
    feat = _rand(2, 50, cfg.feat_dim, seed=24)
    with torch.no_grad():
        out = got(torch.from_numpy(feat)).numpy()
    _close(out, _campplus_apply()({"params": tree}, feat), 1e-5)


@functools.lru_cache(maxsize=None)
def _s3tok_apply():
    return jax.jit(JS3.S3TokenizerV2(tiny.s3tokenizer()[0]).apply)


def _s3tok_file(fsq: str) -> dict:
    """The S3 tokenizer under ``tokenizer.`` with its FSQ projection spelled
    ``fsq``."""
    return {f"tokenizer.{k.replace('quantizer.vq.', fsq + '.')}": v
            for k, v in cpu_state(tiny.s3tokenizer()[3]).items()}


@pytest.mark.parametrize("fsq", ["quantizer.vq", "quantizer._codebook", "quantizer"])
def test_s3tokenizer_state_matches_jax(tmp_path, fsq):
    """The S3 tokenizer under each spelling of its FSQ projection: equal to
    the JAX tree, the ids of a 40-frame log-mel identical."""
    cfg, tpl, _p, tm = tiny.s3tokenizer()
    path = _write(tmp_path / "s3gen.safetensors", _s3tok_file(fsq))
    tree = JV.convert_s3tokenizer(JV.torch_load_weights(path), tpl, prefix="tokenizer.")
    got = TV.load_s3tokenizer_state(TS3.S3TokenizerV2(tm.cfg), TV.torch_load_weights(path),
                                    prefix="tokenizer.").eval()
    _states_equal(got, tiny._load(TS3.S3TokenizerV2(tm.cfg), W.s3tokenizer_from_jax(tree)))
    mel = _rand(1, 40, cfg.n_mels, seed=25)
    with torch.no_grad():
        out = got(torch.from_numpy(mel)).numpy()
    np.testing.assert_array_equal(out, np.asarray(_s3tok_apply()({"params": tree}, mel)))


def test_published_chatterbox_states_match_jax(tmp_path):
    """The voice encoder and HiFT at ``HiFTConfig()``, the published
    geometries the pipeline hard-codes (CAMPPlus, T3, the flow and the S3
    tokenizer are held at theirs on the card, chip_smoke.py's phase
    loaders_voice): ``ve.safetensors`` and an ``s3gen.safetensors`` of
    seeded modules, HiFT's pairs with the gains off; each port module equal
    to the JAX tree, without a forward (HiFT's weights torch's seeded
    initialisers, the folds' gains drawn off)."""
    with torch.random.fork_rng():
        torch.manual_seed(99)
        hift = cpu_state(TS.HiFTGenerator(TS.HiFTConfig()))
    sd = {f"flow.{k}": v for k, v in cpu_state(_s3gen()[2].flow).items()}
    sd.update((f"mel2wav.{k}", v) for k, v in hift.items())
    path = _write(tmp_path / "s3gen.safetensors", gains_off(weight_norm_pairs(sd, HIFT_WN), 101))
    hcfg = JS.HiFTConfig()
    htpl = jax.eval_shape(lambda: JS.HiFTGenerator(hcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, hcfg.in_channels)),
        jax.random.PRNGKey(1)))["params"]
    hp = JV.convert_hift(JV.torch_load_weights(path), htpl, prefix="mel2wav.")
    got = TV.load_s3gen_state(_small_s3gen(TS.HiFTConfig()), TV.torch_load_weights(path))
    _states_equal(got.mel2wav, tiny._load(TS.HiFTGenerator(TS.HiFTConfig()), W.hift_from_jax(hp)))
    ve = tiny.seeded(TT3.VoiceEncoder, 102)
    path = _write(tmp_path / "ve.safetensors", cpu_state(ve))
    tree = JV.convert_voice_encoder(JV.torch_load_weights(path), tiny.voice_encoder()[0])
    got = TV.load_voice_encoder_state(TT3.VoiceEncoder(), TV.torch_load_weights(path))
    _states_equal(got, tiny._load(TT3.VoiceEncoder(), W.voice_encoder_from_jax(tree)))


# ----------------------------------------------------- the one-call pipeline

CB_TEXT = "the other one, then"
# the tiny T3 reads ids below its start token 38: [STOP] 0 is its stop token
CB_TOKENS = bpe_tokenizer_json("the or,n.", ("t h", "th e", "o n"))


@pytest.fixture
def tiny_published(monkeypatch):
    """The config classes each pipeline loader looks up, in both packages'
    modules, at the small widths: T3, the flow, HiFT, CAMPPlus, and the S3
    tokenizer's fields the loaders cannot read from the file."""
    for mods, name, kw in (((JT3, TT3), "T3CkptConfig", T3_V), ((JS, TS), "FlowConfig", FLOW_V),
                           ((JS, TS), "HiFTConfig", HIFT_V),
                           ((JCp, TCp), "CAMPPlusConfig", tiny.CAMPPLUS_TINY),
                           ((JS3, TS3), "S3TokenizerConfig", S3TOK_REST)):
        for mod in mods:
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))


def _conds() -> dict:
    """``conds.pt``: a T3 prompt of exactly ``perceiver_tokens`` (4) tokens,
    where the JAX decode's positions are right (ROADMAP queue 3), and an
    S3Gen reference of 5 tokens and their 10 mel frames."""
    rng = np.random.default_rng(26)
    return chatterbox_conds(_rand(T3_V["speaker_embed_size"], seed=27),
                            rng.integers(0, 30, (1, 4)), rng.integers(0, 27, (1, 5)),
                            _rand(1, 10, FLOW_V["mel_dim"], seed=28),
                            _rand(FLOW_V["xvector_dim"], seed=29))


@pytest.fixture(scope="module")
def chatterbox_dir(tmp_path_factory):
    """resemble-ai's directory of the small modules (the voice encoder at
    its published widths), ``tokenizer.json`` and ``conds.pt``."""
    root = tmp_path_factory.mktemp("chatterbox")
    write_chatterbox_dir(
        root, _t3_file(), cpu_state(tiny.voice_encoder()[2]), cpu_state(_s3gen()[2]),
        cpu_state(tiny.campplus()[3]), cpu_state(tiny.s3tokenizer()[3]), CB_TOKENS, _conds())
    return root


def test_chatterbox_pipeline_matches_jax(chatterbox_dir, tiny_published):
    """Both packages' engines from one directory: every module equal to the
    JAX tree's, the builtin voice and the text ids equal, and ``synthesize``
    from the builtin voice (the text through tokenizer.json; T3, the flow
    and HiFT) within 1e-4 of max|y| under the JAX keys' draws."""
    j = JV.load_chatterbox_pipeline(str(chatterbox_dir))
    t = TV.load_chatterbox_pipeline(str(chatterbox_dir), device="cpu")
    for got, sd in ((t.t3, W.chatterbox_t3_from_jax(j.t3_params)),
                    (t.ve, W.voice_encoder_from_jax(j.ve_params)),
                    (t.s3gen, {**W.s3gen_flow_from_jax(j.s3gen.flow_params, "flow."),
                               **W.hift_from_jax(j.s3gen.hift_params, "mel2wav.")}),
                    (t.campplus, W.campplus_from_jax(j.campplus_params)),
                    (t.s3tok, W.s3tokenizer_from_jax(j.s3tok_params))):
        _states_equal(got, tiny._load(copy.deepcopy(got), sd))
    assert t.s3tok.cfg == TS3.S3TokenizerConfig(**tiny.S3TOK_TINY)
    assert set(t.builtin) == set(j.builtin) == {"speaker_emb", "prompt_tokens", "ref_tokens",
                                                "ref_mel", "ref_xvector"}
    for k, v in j.builtin.items():
        assert t.builtin[k].dtype == v.dtype and np.array_equal(t.builtin[k], v), k
    norm = TT.chatterbox_punc_norm(CB_TEXT)
    assert t.tokenize(norm) == j.tokenize(norm) and len(t.tokenize(norm)) < len(norm)
    hcfg = t.s3gen.hift_cfg
    j.s3gen.flow = SimpleNamespace(apply=jax.jit(j.s3gen.flow.apply))
    j.s3gen.hift = SimpleNamespace(apply=jax.jit(j.s3gen.hift.apply))
    # seed 2: the decode's 10 tokens all within the flow's 30 codes, no stop
    jw, jsr = j.synthesize(CB_TEXT, max_tokens=10, seed=2)
    tw, tsr = t.synthesize(CB_TEXT, max_tokens=10,
                           draws=tiny.jax_t3_draws(2, 10, t.t3.cfg.speech_vocab),
                           source_draws=tiny.jax_hift_draws(2, 1, len(jw),
                                                            hcfg.nb_harmonics + 1))
    assert tsr == jsr == 24000 and len(jw) == 10 * 2 * hcfg.total_upsample
    _close(tw, jw, 1e-4)


@pytest.mark.parametrize("name", ["t3_cfg.safetensors", "ve.safetensors", "s3gen.safetensors"])
def test_a_missing_chatterbox_file_raises_in_both(tmp_path, chatterbox_dir, tiny_published,
                                                   name):
    for p in chatterbox_dir.iterdir():
        if p.name != name:
            (tmp_path / p.name).write_bytes(p.read_bytes())
    with pytest.raises(FileNotFoundError, match=re.escape(name)):
        JV.load_chatterbox_pipeline(str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(name)):
        TV.load_chatterbox_pipeline(str(tmp_path), device="cpu")


# --------------------------------------------- a missing key, a wrong shape

def _zonos_loaders():
    return (lambda p: JV.convert_zonos(JV.torch_load_weights(p), _zonos(7)[1], _zonos(7)[0]),
            lambda p: TV.load_zonos_state(copy.deepcopy(_zonos(7)[2]), TV.torch_load_weights(p)))


def _state_loaders(jax_convert, port_load, make, **kw):
    """(the JAX converter, the port's ``load_*_state``) of a format, each on
    a file's path."""
    return (lambda p: jax_convert(JV.torch_load_weights(p), **kw),
            lambda p: port_load(make(), TV.torch_load_weights(p), **kw))


def _bank_loaders():
    return (lambda p: JV.convert_zonos_prefix(JV.torch_load_weights(p), _bank("mlp")[1],
                                              _specs()[0], "mlp"),
            lambda p: TV.load_zonos_prefix_state(
                TZ.ZonosPrefixConditioner(32, _specs()[1], "mlp"), TV.torch_load_weights(p)))


# format: (the upstream state_dict, how it is written, a key the loader
#          reads (the file's name, the port module's), the JAX loader, the
#          port loader, the JAX loader's error for a missing key); each
#          loader takes the file's path
FORMATS = {
    "zonos": (_zonos_file, _write, ("backbone.layers.0.mixer.D",) * 2, *_zonos_loaders(),
              KeyError),
    "zonos_prefix": (_zonos_file, _write, ("prefix_conditioner.norm.weight", "norm.weight"),
                     *_bank_loaders(), ValueError),
    "openvoice": (lambda: _openvoice_file("weight_g"), _save(lambda sd: {"model": sd}),
                  ("dec.conv_pre.bias",) * 2,
                  lambda p: JV.load_openvoice_checkpoint(p, JO.ToneColorConfig(**OV)),
                  lambda p: TV.load_openvoice_checkpoint(p, TO.ToneColorConfig(**OV),
                                                         device="cpu"), ValueError),
    "chatterbox_t3": (_t3_file, _write, ("text_head.bias",) * 2,
                      *_state_loaders(lambda sd: JV.convert_chatterbox_t3(sd, _t3()[1]),
                                      TV.load_chatterbox_t3_state,
                                      lambda: TT3.T3(_t3()[2].cfg, max_seq_len=4096)),
                      ValueError),
    "voice_encoder": (lambda: cpu_state(tiny.voice_encoder()[2]), _write, ("proj.bias",) * 2,
                      *_state_loaders(lambda sd: JV.convert_voice_encoder(
                          sd, tiny.voice_encoder()[0]), TV.load_voice_encoder_state,
                          TT3.VoiceEncoder), ValueError),
    "s3gen": (_s3gen_file, _write, ("mel2wav.conv_post.bias",) * 2,
              *_state_loaders(lambda sd: JV.convert_s3gen(sd, *_s3gen()[:2]),
                              TV.load_s3gen_state, _small_s3gen), ValueError),
    "campplus": (_s3gen_file, _write,
                 ("speaker_encoder.xvector.dense.nonlinear.batchnorm.running_mean",
                  "xvector.dense.nonlinear.batchnorm.running_mean"),
                 *_state_loaders(lambda sd, prefix: JV.convert_campplus(
                     sd, tiny.campplus()[1], prefix=prefix), TV.load_campplus_state,
                     lambda: TCp.CAMPPlus(tiny.campplus()[3].cfg), prefix="speaker_encoder."),
                 ValueError),
    "s3tokenizer": (lambda: _s3tok_file("quantizer"), _write,
                    ("tokenizer.encoder.ln_post.bias", "encoder.ln_post.bias"),
                    *_state_loaders(lambda sd, prefix: JV.convert_s3tokenizer(
                        sd, tiny.s3tokenizer()[1], prefix=prefix), TV.load_s3tokenizer_state,
                        lambda: TS3.S3TokenizerV2(tiny.s3tokenizer()[3].cfg),
                        prefix="tokenizer."), ValueError),
}


def _file_name(fmt: str) -> str:
    return "converter.pth" if fmt == "openvoice" else "model.safetensors"


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_missing_key_raises_in_both(tmp_path, fmt):
    source, write, (key, port_key), jax_load, port_load, jax_error = FORMATS[fmt]
    sd = dict(source())
    del sd[key]
    path = str(tmp_path / _file_name(fmt))
    write(path, sd)
    with pytest.raises(jax_error, match="missing torch key"):
        jax_load(path)
    with pytest.raises(KeyError, match=re.escape(repr(port_key))):
        port_load(path)


@pytest.mark.parametrize("fmt", sorted(set(FORMATS) - {"zonos"}))
def test_a_wrong_shape_raises_in_both(tmp_path, fmt):
    """Zonos's own case is test_zonos_wrong_shapes_pass_the_jax_converter_and_not_the_port."""
    source, write, (key, _), jax_load, port_load, _e = FORMATS[fmt]
    sd = dict(source())
    sd[key] = torch.zeros(sd[key].shape[0] + 1)
    path = str(tmp_path / _file_name(fmt))
    write(path, sd)
    with pytest.raises(ValueError, match="shape"):
        jax_load(path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_load(path)


# ------------------------------------------------- the repaired tokenizer

def test_chatterbox_tokenizer_matches_jax(tmp_path, monkeypatch):
    """The port's ChatterboxTokenizer (``BpeTokenizer``) against the JAX one
    (the ``tokenizers`` package) on a tokenizer.json with four added tokens,
    on texts with added tokens inside words and characters outside the
    vocab; the port's needs no ``tokenizers`` package."""
    spec = bpe_tokenizer_json("hello world, the other one.",
                              ("l l", "h e", "he ll", "o r", "w or", "t h", "th e"),
                              added=("[STOP]", "[UNK]", "[SPACE]", "[START]"))
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    jt = JT.ChatterboxTokenizer(str(path))
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    tt = TT.ChatterboxTokenizer(str(path))
    unk = spec["model"]["vocab"]["[UNK]"]
    for text in ("Hello world, the other one.", "hello[STOP]world [START]the",
                 "wörld 42 — ZZ hello", "the[SPACE]other  one", ""):
        norm = TT.chatterbox_punc_norm(text)
        for s in (text, norm):
            assert tt.encode(s) == jt.encode(s), s
    assert unk in tt.encode("wörld 42") and spec["model"]["vocab"]["[STOP]"] in tt.encode("a[STOP]")


@pytest.mark.parametrize("part,value", [("model", {"type": "WordPiece", "vocab": {"a": 0}}),
                                        ("pre_tokenizer", {"type": "ByteLevel"})])
def test_a_tokenizer_json_the_port_cannot_read_raises(tmp_path, part, value):
    """No fallback to the UTF-8 bytes: a model that is not BPE, or a
    pre-tokenizer that is not ``Whitespace``, raises."""
    spec = bpe_tokenizer_json("ab")
    spec[part] = value
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=value["type"]):
        TT.ChatterboxTokenizer(str(path))


def test_the_port_imports_no_tokenizers():
    """No module of the port, and not chip_smoke.py, imports ``tokenizers``."""
    paths = sorted((REPO / "audiolab_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert REPO / "audiolab_tpu_torch/pipelines/tts.py" in paths
    pattern = re.compile(r"^\s*(import|from)\s+tokenizers\b", re.M)
    found = [str(p.relative_to(REPO)) for p in paths if pattern.search(p.read_text())]
    assert not found, found
