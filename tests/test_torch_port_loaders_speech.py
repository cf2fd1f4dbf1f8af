"""The port's checkpoint loaders of the speech engines (audiolab_tpu_torch/
utils/convert.py: descript-audio-codec's DAC, nari-labs Dia, XTTS-v2's
``model.pth`` and ``dvae.pth``) against the JAX package's
(audiolab_tpu/utils/convert.py), on the CPU, on files the tests write in the
upstream containers and names from seeded port modules at small widths
(``tests/torch_port_tiny.py``'s ``DIA`` and ``DAC``;
``tests/test_torch_port_xtts.py``'s ``GPT``, ``COND``, ``PERC``, ``SPK``,
``HIFI`` and ``DVAE``).

Each case reads one file with both packages: the JAX loader's tree reaches
the port through ``utils/weights.py``'s ``*_from_jax``, and its state_dict
must equal, bit for bit, the one the port's loader gives; both packages then
run the loaded models on one seeded input at the tolerance of the module's
parity test (the DAC's audio, Dia's logits, the XTTS-v2 modules' outputs
1e-5 of max|y|, the HiFi waveform 1e-4; the DVAE's codes identical).

The files hold what the JAX converter must fold (weight-norm pairs with a
gain off the weight's norm, in both of torch's forms: the DAC's convolutions,
transposed up-convolutions and 1x1 ``out_proj``, the HiFi decoder's
up-convolutions and residual blocks), what it keeps (the speaker encoder's
batch-norm statistics, off their initial values), tensors it ignores (the
DAC's encoder and ``in_proj``, the DVAE's EMA buffers, XTTS-v2's mel front
ends) and the prefixes it strips.  The JAX HiFi and speaker loaders
hard-code the published geometry: the outputs are held at the small widths
by swapping the class each loader looks up in both packages, and the
state_dicts once at the published geometry.  Every JAX loader here builds
its template by ``jax.eval_shape``, so no flax ``init`` runs.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import codecs as JC
from audiolab_tpu.models import dia as JD
from audiolab_tpu.models import xtts as JX
from audiolab_tpu.utils import convert as JV
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.models import dia as TD
from audiolab_tpu_torch.models import xtts as TX
from audiolab_tpu_torch.utils import convert as TV
from audiolab_tpu_torch.utils import weights as W
from chip_smoke import (
    DAC_WN,
    XTTS_HIFI_WN,
    cpu_state,
    gains_off,
    weight_norm_pairs,
    write_safetensors,
)
from tests import torch_port_tiny as tiny
from tests.test_torch_port_loaders import _states_equal
from tests.test_torch_port_loaders_listen import _close, _parametrized, _save
from tests.test_torch_port_xtts import COND, DVAE, GPT, HIFI, PERC, SPK, _module
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

# XTTS-v2's model.pth: each part's prefix (Coqui's module paths)
XTTS_PREFIX = {"gpt": "gpt.", "cond": "gpt.conditioning_encoder.",
               "perc": "gpt.conditioning_perceiver.", "spk": "hifigan_decoder.speaker_encoder.",
               "hifi": "hifigan_decoder.waveform_decoder."}
XTTS_FROM_JAX = {"gpt": W.xtts_gpt2_from_jax, "cond": W.xtts_conditioner_from_jax,
                 "perc": W.xtts_perceiver_from_jax, "hifi": W.xtts_hifigan_from_jax,
                 "spk": lambda v: W.xtts_speaker_from_jax(v["params"], v["batch_stats"])}
XTTS_PORT = {"gpt": (TX.XttsGPT2, GPT), "cond": (TX.XttsConditioningEncoder, COND),
             "perc": (TX.XttsPerceiverResampler, PERC), "spk": (TX.XttsSpeakerEncoder, SPK),
             "hifi": (TX.XttsHifiganDecoder, HIFI)}


def _via_jax(part: str, tree) -> torch.nn.Module:
    cls, kw = XTTS_PORT[part]
    return tiny._load(cls(**kw), XTTS_FROM_JAX[part](tree))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -------------------------------------------------------------------- DAC

@functools.lru_cache(maxsize=None)
def _dac_upstream(form: str) -> dict:
    """descript-audio-codec's decode-path names with every convolution a
    weight-norm pair (gains off), in the old names or torch 2's, and the
    tensors the decode path drops: the encoder's and each quantizer's
    ``in_proj`` pair."""
    _cfg, _p, tm = tiny.dac()
    sd = gains_off(weight_norm_pairs(cpu_state(tm), DAC_WN), 90)
    g = torch.Generator().manual_seed(91)
    for i in range(tiny.DAC["n_q"]):
        q = f"quantizer.quantizers.{i}.in_proj"
        sd[f"{q}.weight_g"] = torch.rand(tiny.DAC["codebook_dim"], 1, 1, generator=g)
        sd[f"{q}.weight_v"] = torch.randn(tiny.DAC["codebook_dim"], tiny.DAC["dim"], 1,
                                          generator=g)
        sd[f"{q}.bias"] = torch.randn(tiny.DAC["codebook_dim"], generator=g)
    sd["encoder.block.0.weight_g"] = torch.rand(8, 1, 1, generator=g)
    sd["encoder.block.0.weight_v"] = torch.randn(8, 1, 7, generator=g)
    sd["encoder.block.0.bias"] = torch.randn(8, generator=g)
    sd["encoder.block.1.block.0.block.0.alpha"] = torch.rand(1, 8, 1, generator=g)
    return _parametrized(sd) if form == "parametrizations" else sd


def _dac_cfgs():
    return JC.DACConfig(**tiny.DAC), TC.DACConfig(**tiny.DAC)


@functools.lru_cache(maxsize=None)
def _dac_apply():
    return jax.jit(JC.DACDecoder(_dac_cfgs()[0]).apply)


def _write_dac(path, sd: dict, nested: bool = True) -> None:
    """``weights.pth`` as descript-audio-codec saves it: the tensors under
    ``state_dict`` beside the ``metadata`` of its kwargs."""
    torch.save({"state_dict": sd, "metadata": {"kwargs": {"sample_rate": 44100}}}
               if nested else sd, path)


@pytest.mark.parametrize("form,nested", [("weight_g", True), ("parametrizations", False)])
def test_dac_loader_matches_jax(tmp_path, form, nested):
    """Both packages' decoders from one ``weights.pth``: the port's equal to
    the JAX tree's, the audio of 6 frames within 1e-5 of max|y|."""
    path = str(tmp_path / "weights.pth")
    _write_dac(path, _dac_upstream(form), nested)
    jcfg, tcfg = _dac_cfgs()
    params, jc = JV.load_dac_checkpoint(path, jcfg)
    got, tc = TV.load_dac_checkpoint(path, tcfg, device="cpu")
    assert jc is jcfg and tc is tcfg
    _states_equal(got, tiny._load(TC.DACDecoder(tcfg), W.dac_from_jax(params)))
    codes = np.random.default_rng(13).integers(0, tcfg.codebook_size, (2, tcfg.n_q, 6))
    want = _dac_apply()({"params": params}, jnp.asarray(codes, jnp.int32))
    with torch.no_grad():
        _close(got(torch.from_numpy(codes)).numpy(), want, 1e-5)


# -------------------------------------------------------------------- Dia

def _dia_state(dtype=torch.float32) -> dict:
    """nari-labs' names and DenseGeneral layouts (the decoder's GQA k/v over
    2 of 4 heads, per-codebook embeddings) of tiny.dia()'s port model."""
    return {k: v.to(dtype) for k, v in cpu_state(tiny.dia()[3]).items()}


def _write_dia(path, sd: dict) -> None:
    if str(path).endswith(".safetensors"):
        write_safetensors(path, sd)
    else:
        torch.save(sd, path)


@functools.lru_cache(maxsize=None)
def _dia_apply():
    jm = tiny.dia()[1]
    return jax.jit(lambda p, i, c, m: jm.apply({"params": p}, i, c, m))


def _dia_loaders():
    jcfg, _jm, _p, tm = tiny.dia()
    return (lambda p: JV.load_dia_checkpoint(p, jcfg),
            lambda p: TV.load_dia_checkpoint(p, tm.cfg, device="cpu"))


@pytest.mark.parametrize("name,dtype", [("dia.pth", torch.float16),
                                        ("model.safetensors", torch.float32)])
def test_dia_loader_matches_jax(tmp_path, name, dtype):
    """An fp16 ``.pth`` (made fp32 by both) and an fp32 ``.safetensors``: the
    port's model equal to the JAX tree's, the teacher-forced logits of a
    6-frame prompt within 1e-5 of max|logit|."""
    path = str(tmp_path / name)
    _write_dia(path, _dia_state(dtype))
    jax_load, port_load = _dia_loaders()
    params = jax_load(path)
    got = port_load(path)
    jcfg, _jm, _p, tm = tiny.dia()
    _states_equal(got, tiny._load(TD.DiaModel(tm.cfg), W.dia_from_jax(params, tm.cfg)))
    rng = np.random.default_rng(14)
    ids = np.zeros((2, 9), np.int32)
    ids[0] = JD.tokenize_dialogue("[S1] hey!")
    ids[1, :6] = JD.tokenize_dialogue("[S2] a")
    codes = rng.integers(0, jcfg.codebook_size, (2, jcfg.n_codebooks, 6))
    want = _dia_apply()(params, jnp.asarray(ids), jnp.asarray(codes, jnp.int32),
                        jnp.asarray(ids != 0))
    with torch.no_grad():
        out = got(torch.from_numpy(ids).long(), torch.from_numpy(codes),
                  torch.from_numpy(ids != 0))
    _close(out.numpy(), want, 1e-5)


def test_dia_encoder_of_the_published_head_count_is_refused(tmp_path):
    """The published Dia-1.6B encoder's case at small widths: q/k/v/o with
    twice the heads the config derives (dim_enc // n_heads_enc), at the same
    head dim.  Both packages refuse the file."""
    sd = _dia_state()
    dim, heads = tiny.DIA["dim_enc"], 2 * tiny.DIA["n_heads_enc"]
    hd = dim // tiny.DIA["n_heads_enc"]
    g = torch.Generator().manual_seed(92)
    for i in range(tiny.DIA["n_layers_enc"]):
        b = f"encoder.layers.{i}.self_attention"
        for name in ("q_proj", "k_proj", "v_proj"):
            sd[f"{b}.{name}.weight"] = torch.randn(dim, heads, hd, generator=g)
        sd[f"{b}.o_proj.weight"] = torch.randn(heads, hd, dim, generator=g)
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, sd)
    jax_load, port_load = _dia_loaders()
    with pytest.raises(ValueError, match="shape"):
        jax_load(path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_load(path)


# ---------------------------------------------------------------- XTTS-v2

def _xtts_parts() -> dict:
    """Each XTTS-v2 part's state_dict under Coqui's module names, from
    test_torch_port_xtts's seeded modules (the speaker encoder's batch-norm
    statistics off their initial values), the HiFi decoder's up-convolutions
    and residual convolutions as weight-norm pairs with the gains off."""
    parts = {name: cpu_state(_module(name)[2]) for name in XTTS_PREFIX}
    parts["hifi"] = gains_off(weight_norm_pairs(parts["hifi"], XTTS_HIFI_WN), 93)
    assert float((parts["spk"]["bn1.running_var"] - 1).abs().min()) > 0
    return parts


def _model_pth(parts: dict) -> dict:
    """One whole ``model.pth``: the five parts under their prefixes (the
    inner GPT-2 at ``gpt.gpt.h.N``), the DVAE under ``dvae.``, and the mel
    front ends' buffers, which no loader reads."""
    sd = {f"{XTTS_PREFIX[name]}{k}": v for name, part in parts.items() for k, v in part.items()}
    sd.update({f"dvae.{k}": v for k, v in cpu_state(_module("dvae")[2]).items()})
    sd["torch_mel_spectrogram_style_encoder.mel_stft.mel_basis"] = torch.rand(80, 513)
    sd["hifigan_decoder.speaker_encoder.torch_spec.1.mel_scale.fb"] = torch.rand(257, 64)
    return sd


@pytest.fixture(scope="module")
def model_pth(tmp_path_factory):
    """The XTTS-v2 modules (the JAX ones built before any class is swapped)
    and one whole ``model.pth`` written from them."""
    path = tmp_path_factory.mktemp("xtts") / "model.pth"
    torch.save(_model_pth(_xtts_parts()), path)
    return str(path)


@pytest.fixture
def tiny_published(monkeypatch):
    """Both packages' ``XttsHifiganDecoder`` and ``XttsSpeakerEncoder``, which
    the HiFi and speaker loaders build at the published geometry, at the
    small widths; the JAX decoder's template traced on latents and a
    d-vector of those widths (its loader traces 1024 and 512)."""
    base = JX.XttsHifiganDecoder

    class SmallHifi(base):
        def init(self, rng, latents, g, **kw):
            return base.init(self, rng, jnp.zeros(latents.shape[:-1] + (HIFI["input_dim"],)),
                             jnp.zeros((g.shape[0], HIFI["cond_dim"])), **kw)

    monkeypatch.setattr(JX, "XttsHifiganDecoder", functools.partial(SmallHifi, **HIFI))
    monkeypatch.setattr(JX, "XttsSpeakerEncoder", functools.partial(JX.XttsSpeakerEncoder, **SPK))
    monkeypatch.setattr(TX, "XttsHifiganDecoder", functools.partial(TX.XttsHifiganDecoder, **HIFI))
    monkeypatch.setattr(TX, "XttsSpeakerEncoder", functools.partial(TX.XttsSpeakerEncoder, **SPK))


# part: (the JAX loader, the port loader), each on the file's path
XTTS_LOADERS = {
    "gpt": (lambda p: JV.load_xtts_gpt_checkpoint(p, **GPT),
            lambda p: TV.load_xtts_gpt_checkpoint(p, device="cpu", **GPT)),
    "cond": (lambda p: JV.load_xtts_conditioner_checkpoint(p, **COND),
             lambda p: TV.load_xtts_conditioner_checkpoint(p, device="cpu", **COND)),
    "perc": (lambda p: JV.load_xtts_perceiver_checkpoint(p, **PERC),
             lambda p: TV.load_xtts_perceiver_checkpoint(p, device="cpu", **PERC)),
    "spk": (JV.load_xtts_speaker_checkpoint,
            lambda p: TV.load_xtts_speaker_checkpoint(p, device="cpu")),
    "hifi": (JV.load_xtts_hifigan_checkpoint,
             lambda p: TV.load_xtts_hifigan_checkpoint(p, device="cpu")),
}


def _xtts_outputs_match(part: str, tree, got) -> None:
    """The JAX module on the loaded tree against the port's loaded module, on
    test_torch_port_xtts's inputs, at its tolerances."""
    jm = _module(part)[0]
    variables = tree if part == "spk" else {"params": tree}
    if part == "gpt":
        rng = np.random.default_rng(15)
        text, mel = rng.integers(0, GPT["n_text"], (2, 5)), rng.integers(0, GPT["n_audio"], (2, 7))
        cond = _rand(2, 6, GPT["dim"], seed=16)
        ref = jm.apply(variables, jnp.asarray(text), jnp.asarray(mel), jnp.asarray(cond),
                       return_latents=True)
        with torch.no_grad():
            out = got(torch.from_numpy(text), torch.from_numpy(mel), torch.from_numpy(cond),
                      return_latents=True)
        for o, r in zip(out, ref):
            _close(o.numpy(), r, 1e-5)
        return
    args = {"cond": (_rand(2, 20, 80, seed=17),), "perc": (_rand(2, 20, PERC["dim"], seed=18),),
            "spk": (np.abs(_rand(2, 40, 64, seed=19)) + 0.01,),
            "hifi": (_rand(2, 6, HIFI["input_dim"], seed=20), _rand(2, HIFI["cond_dim"], seed=21))
            }[part]
    kw = {"l2_norm": True} if part == "spk" else {}
    ref = jm.apply(variables, *map(jnp.asarray, args), **kw)
    with torch.no_grad():
        out = got(*map(torch.from_numpy, args), **kw)
    _close(out.numpy(), ref, 1e-4 if part == "hifi" else 1e-5)


@pytest.mark.parametrize("part", sorted(XTTS_LOADERS))
def test_xtts_model_pth_matches_jax(model_pth, tiny_published, part):
    """Each of the five loaders on one whole ``model.pth``: the other parts'
    tensors dropped, the port's module equal to the JAX tree's, the outputs
    within the module's parity tolerance."""
    jax_load, port_load = XTTS_LOADERS[part]
    tree = jax_load(model_pth)
    got = port_load(model_pth)
    _states_equal(got, _via_jax(part, tree))
    _xtts_outputs_match(part, tree, got)


@pytest.mark.parametrize("part", sorted(XTTS_LOADERS))
def test_a_nested_model_pth_is_refused_by_both(tmp_path, model_pth, tiny_published, part):
    """A ``model.pth`` as Coqui's trainer saves it, the weights nested under
    ``model`` beside the trainer's state: both packages take the file's top
    level as the state_dict, and refuse it for the keys it lacks."""
    path = str(tmp_path / "model.pth")
    torch.save({"config": {"model": "xtts"}, "model": torch.load(model_pth, weights_only=True),
                "step": 1000, "epoch": 3}, path)
    jax_load, port_load = XTTS_LOADERS[part]
    with pytest.raises(ValueError, match="missing torch key"):
        jax_load(path)
    with pytest.raises(KeyError, match="lacks"):
        port_load(path)


@pytest.mark.parametrize("prefix", ["", "dvae."])
def test_xtts_dvae_loader_matches_jax(tmp_path, prefix):
    """``dvae.pth`` as published (no prefix) and the ``dvae.`` part of a
    whole file, with the codebook's other EMA buffers: the codes of a mel
    identical, its reconstruction within 1e-5."""
    sd = cpu_state(_module("dvae")[2])
    sd["codebook.cluster_size"] = torch.rand(DVAE["num_tokens"])
    sd["codebook.embed_avg"] = torch.rand(DVAE["codebook_dim"], DVAE["num_tokens"])
    path = str(tmp_path / "dvae.pth")
    torch.save({f"{prefix}{k}": v for k, v in sd.items()}, path)
    tree = JV.load_xtts_dvae_checkpoint(path, **DVAE)
    got = TV.load_xtts_dvae_checkpoint(path, device="cpu", **DVAE)
    _states_equal(got, tiny._load(TX.XttsDVAE(**DVAE), W.xtts_dvae_from_jax(tree)))
    jm = _module("dvae")[0]
    mel = _rand(2, 16, 80, seed=22)
    codes = jm.apply({"params": tree}, jnp.asarray(mel), method=JX.XttsDVAE.encode)
    with torch.no_grad():
        tcodes = got.encode(torch.from_numpy(mel))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
        _close(got.decode(tcodes).numpy(),
               jm.apply({"params": tree}, codes, method=JX.XttsDVAE.decode), 1e-5)


def test_published_hifi_and_speaker_states_match_jax(tmp_path):
    """The HiFi and speaker loaders at the published geometry they hard-code
    (no class swapped): one file of both parts from seeded port modules, the
    HiFi pairs' gains off and the speaker statistics off their init; each
    port module equal to the JAX tree's, without a forward."""
    hifi = cpu_state(tiny.seeded(TX.XttsHifiganDecoder, 94, 0.02))
    spk = cpu_state(tiny.seeded(TX.XttsSpeakerEncoder, 95, 0.02))
    sd = {f"{XTTS_PREFIX['hifi']}{k}": v
          for k, v in gains_off(weight_norm_pairs(hifi, XTTS_HIFI_WN), 96).items()}
    sd.update({f"{XTTS_PREFIX['spk']}{k}": v for k, v in spk.items()})
    path = str(tmp_path / "model.pth")
    torch.save(sd, path)
    got = TV.load_xtts_hifigan_checkpoint(path, device="cpu")
    _states_equal(got, tiny._load(TX.XttsHifiganDecoder(),
                                  W.xtts_hifigan_from_jax(JV.load_xtts_hifigan_checkpoint(path))))
    v = JV.load_xtts_speaker_checkpoint(path)
    got = TV.load_xtts_speaker_checkpoint(path, device="cpu")
    _states_equal(got, tiny._load(TX.XttsSpeakerEncoder(),
                                  W.xtts_speaker_from_jax(v["params"], v["batch_stats"])))
    assert torch.equal(got.bn1.running_var, spk["bn1.running_var"])


# --------------------------------------------- a missing key, a wrong shape

@functools.lru_cache(maxsize=None)
def _xtts_whole() -> dict:
    return _model_pth(_xtts_parts())


# format: (the upstream state_dict, how it is written, a key no fold reads
#          (the file's name, the port module's), the JAX loader, the port
#          loader); each loader takes the file's path
FORMATS = {
    "dac": (lambda: _dac_upstream("weight_g"), _write_dac, ("decoder.model.6.bias",) * 2,
            lambda p: JV.load_dac_checkpoint(p, _dac_cfgs()[0]),
            lambda p: TV.load_dac_checkpoint(p, _dac_cfgs()[1], device="cpu")),
    "dia": (_dia_state, _write_dia, ("decoder.norm.weight",) * 2, *_dia_loaders()),
    "xtts_dvae": (lambda: cpu_state(_module("dvae")[2]), _save(dict), ("decoder.0.bias",) * 2,
                  lambda p: JV.load_xtts_dvae_checkpoint(p, **DVAE),
                  lambda p: TV.load_xtts_dvae_checkpoint(p, device="cpu", **DVAE)),
}
for _part, _key in (("gpt", "final_norm.bias"), ("cond", "init.bias"), ("perc", "norm.gamma"),
                    ("spk", "fc.bias"), ("hifi", "conds.1.bias")):
    FORMATS[f"xtts_{_part}"] = (_xtts_whole, _save(dict), (XTTS_PREFIX[_part] + _key, _key),
                                *XTTS_LOADERS[_part])


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_missing_key_raises_in_both(tmp_path, tiny_published, fmt):
    source, write, (key, port_key), jax_load, port_load = FORMATS[fmt]
    sd = dict(source())
    del sd[key]
    path = str(tmp_path / ("missing.safetensors" if fmt == "dia" else "missing.pth"))
    write(path, sd)
    with pytest.raises(ValueError, match="missing torch key"):
        jax_load(path)
    with pytest.raises(KeyError, match=re.escape(repr(port_key))):
        port_load(path)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_wrong_shape_raises_in_both(tmp_path, tiny_published, fmt):
    source, write, (key, _), jax_load, port_load = FORMATS[fmt]
    sd = dict(source())
    sd[key] = torch.zeros(sd[key].shape[0] + 1)
    path = str(tmp_path / ("wrong.safetensors" if fmt == "dia" else "wrong.pth"))
    write(path, sd)
    with pytest.raises(ValueError, match="shape"):
        jax_load(path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_load(path)
