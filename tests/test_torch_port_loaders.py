"""The port's checkpoint loaders of the Separate -> Clone chain
(audiolab_tpu_torch/utils/convert.py) against the JAX package's
(audiolab_tpu/utils/convert.py), on the CPU, on files the tests write in the
upstream containers and names (chip_smoke.py's writers: weight-norm pairs,
process_ckpt's fp16 dict, ZFTurbo's MDX23C names) from seeded port modules
at small widths.

Each case reads one file with both packages: the JAX loader's tree reaches
the port through ``utils/weights.py``'s ``*_from_jax``, and its state_dict
must equal, bit for bit, the one the port's loader gives; both packages then
run the loaded models on one seeded input at the tolerance of the module's
parity test (RoFormer stems, RVC audio, RMVPE and CREPE salience 1e-5;
HuBERT features 2e-5; HTDemucs and MDX23C 1e-5 of max|y|; the VR mask 1e-5).

The files hold what the JAX converter must fold (weight-norm pairs with a
gain off the weight's norm, RMVPE's GRU and VR's LSTM hidden biases, VR's
batch-norm statistics and auxiliary heads), extra tensors it ignores (RVC's
``enc_q``, fairseq's ``mask_emb``) and the prefixes it strips.

Where the JAX loader builds its template with a flax ``init`` at full size
(RVC's ``config_for``, RMVPE's ``E2E``) or at any size (the HuBERT
trainer), the test swaps in the small configuration and a template by
``jax.eval_shape`` in both packages, so the loaders' own code runs on a small
file: a flax init costs 10-30 s on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import crepe as JCr
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models import rmvpe as JRm
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.models.separation import htdemucs as JHt
from audiolab_tpu.models.separation import mdx23c as JMc
from audiolab_tpu.models.separation import roformer as JRo
from audiolab_tpu.models.separation import vr as JVr
from audiolab_tpu.train import rvc_train as JT
from audiolab_tpu.utils import convert as JV
from audiolab_tpu_torch.models import crepe as TCr
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import rmvpe as TRm
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.models.separation import htdemucs as THt
from audiolab_tpu_torch.models.separation import mdx23c as TMc
from audiolab_tpu_torch.models.separation import roformer as TRo
from audiolab_tpu_torch.models.separation import vr as TVr
from audiolab_tpu_torch.train import rvc_train as TT
from audiolab_tpu_torch.utils import convert as TV
from audiolab_tpu_torch.utils import weights as W
from chip_smoke import (
    HUBERT_WN,
    cpu_state,
    mdx23c_upstream_names,
    off_their_init,
    rvc_process_ckpt,
    weight_norm_pairs,
)
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

ROFORMER = dict(dim=32, depth=2, heads=2, dim_head=16, freqs_per_bands=(16, 16, 32, 65),
                n_fft=256, hop=64, dtype="float32")
ROFORMER_VARIANTS = {
    "bs_residual": dict(stems=("vocals",), residual_stem="other"),
    "mel_bands": dict(stems=("vocals", "other"), band_bins=JRo.mel_band_bins(8, 256, 44100)),
}
# RVC's widths cut for the CPU; config_for's rates, kernels and feature width stay
SYNTH_SMALL = dict(inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
                   n_layers=1, upsample_initial_channel=32, spk_embed_dim=4, gin_channels=16)
HUBERT_SETTINGS = {"feat_channels": 64, "version": "v2"}      # the trainer's small HuBERT
HUBERT_CFG = TH.HubertConfig(dim=64, ffn_dim=256, heads=1, layers=2, final_dim=256)
CONFIG_FOR = TSy.config_for
VR_TINY = {"cascaded_net": dict(arch="cascaded_net", nout=8, nout_lstm=8),
           "cascaded_asppnet": dict(arch="cascaded_asppnet", ch=4)}


def _states_equal(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _eval_shape_init(cls):
    """``cls`` (a flax module) whose ``init`` gives the template by
    ``jax.eval_shape``: shapes only, no parameter computed."""
    class Traced(cls):
        def init(self, *args, **kw):
            return jax.eval_shape(lambda: cls.init(self, *args, **kw))

    Traced.__name__ = cls.__name__
    return Traced


# ------------------------------------------------------------ BS-RoFormer

@functools.lru_cache(maxsize=None)
def _roformer_source(variant: str) -> dict:
    tcfg = TRo.RoformerConfig(**ROFORMER, **ROFORMER_VARIANTS[variant])
    return cpu_state(tiny.seeded(lambda: TRo.BSRoformer(tcfg), 20))


def _write_roformer(path, sd: dict, container: str) -> None:
    if container == "state_dict":      # ZFTurbo's training checkpoints
        torch.save({"state_dict": sd, "epoch": 3}, path)
    elif container == "state":
        torch.save({"state": sd}, path)
    else:                              # Lightning: model. on every key
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, path)


@pytest.mark.parametrize("container", ["state_dict", "state", "model_prefix"])
@pytest.mark.parametrize("variant", sorted(ROFORMER_VARIANTS))
def test_roformer_loader_matches_jax(tmp_path, variant, container):
    kw = dict(ROFORMER, **ROFORMER_VARIANTS[variant])
    jcfg, tcfg = JRo.RoformerConfig(**kw), TRo.RoformerConfig(**kw)
    path = str(tmp_path / "model.ckpt")
    _write_roformer(path, _roformer_source(variant), container)
    params = JV.load_roformer_checkpoint(path, jcfg)
    via_jax = TRo.BSRoformer(tcfg)
    via_jax.load_state_dict(W.roformer_from_jax(params, tcfg.stems), strict=True)
    got = TV.load_roformer_checkpoint(path, tcfg, device="cpu")
    _states_equal(got, via_jax)
    if container == "state_dict":
        x = (0.3 * np.random.default_rng(0).standard_normal((1, 2, 1024))).astype(np.float32)
        jm = JRo.BSRoformer(jcfg)
        ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
        with torch.no_grad():
            out = got(torch.from_numpy(x))
        assert set(out) == set(ref)
        for stem in ref:
            np.testing.assert_allclose(out[stem].numpy(), np.asarray(ref[stem]), atol=1e-5,
                                       rtol=0)


def test_a_missing_key_or_a_wrong_shape_raises_in_both(tmp_path):
    """Strict in both packages: a file without one of the module's tensors
    raises and names it, and a tensor of the wrong shape raises."""
    kw = dict(ROFORMER, **ROFORMER_VARIANTS["bs_residual"])
    jcfg, tcfg = JRo.RoformerConfig(**kw), TRo.RoformerConfig(**kw)
    sd = dict(_roformer_source("bs_residual"))
    key = "layers.1.0.layers.0.0.to_gates.bias"
    path = str(tmp_path / "missing.ckpt")
    torch.save({"state_dict": {k: v for k, v in sd.items() if k != key}}, path)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        TV.load_roformer_checkpoint(path, tcfg, device="cpu")
    with pytest.raises(ValueError, match="missing torch key"):
        JV.load_roformer_checkpoint(path, jcfg)
    sd[key] = torch.zeros(sd[key].shape[0] + 1)
    torch.save({"state_dict": sd}, path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        TV.load_roformer_checkpoint(path, tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        JV.load_roformer_checkpoint(path, jcfg)


# -------------------------------------------------------------------- RVC

@pytest.fixture
def small_rvc(monkeypatch):
    """Both packages' ``config_for`` at SYNTH_SMALL's widths (the rates,
    kernels and feature width of the tag's preset kept), the JAX template by
    eval_shape; returns the calls each package made."""
    calls = {"jax": [], "port": []}
    real_j, real_t = JSy.config_for, TSy.config_for

    def small(real, who):
        def config_for(sr, version="v2"):
            calls[who].append((sr, version))
            return dataclasses.replace(real(sr, version), **SYNTH_SMALL)
        return config_for

    monkeypatch.setattr(JSy, "config_for", small(real_j, "jax"))
    monkeypatch.setattr(TSy, "config_for", small(real_t, "port"))
    monkeypatch.setattr(JSy, "SynthesizerTrn", _eval_shape_init(JSy.SynthesizerTrn))
    return calls


def _voice_file(path, version: str, sr: int, tag: str, **kw) -> dict:
    """A process_ckpt .pth of a seeded training synthesizer (``enc_q`` in
    it), the weight-norm gains moved off the weights' norms."""
    cfg = dataclasses.replace(CONFIG_FOR(sr, version), **SYNTH_SMALL)
    src = tiny.seeded(lambda: TSy.SynthesizerTrn(cfg, posterior=True), 31, 0.05)
    cpt = rvc_process_ckpt(cpu_state(src), cfg, tag, version, **kw)
    g = torch.Generator().manual_seed(32)
    for k, v in cpt["weight"].items():
        if k.endswith("weight_g"):
            cpt["weight"][k] = (v.float() * (1.0 + 0.2 * torch.rand(v.shape, generator=g))).half()
    assert any(k.startswith("enc_q.") for k in cpt["weight"])
    torch.save(cpt, path)
    return cpt


@pytest.mark.parametrize("version,sr,tag", [("v1", 40000, "40k"), ("v2", 48000, "48k")])
def test_rvc_loader_matches_jax(tmp_path, small_rvc, version, sr, tag):
    path = str(tmp_path / "voice.pth")
    _voice_file(path, version, sr, tag)
    params, jcfg = JV.load_rvc_checkpoint(path)
    got, cfg = TV.load_rvc_checkpoint(path, device="cpu")
    assert small_rvc["jax"] == small_rvc["port"] == [(sr, version)]
    assert cfg.sr == jcfg.sr == sr and cfg.feat_channels == jcfg.feat_channels
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    via_jax = TSy.SynthesizerTrn(cfg)
    via_jax.load_state_dict(W.synthesizer_from_jax(params), strict=True)
    _states_equal(got, via_jax)
    if version == "v2":
        b, t = 1, 6
        rng = np.random.default_rng(6)
        phone = rng.standard_normal((b, t, cfg.feat_channels)).astype(np.float32)
        f0 = rng.uniform(100, 400, (b, t)).astype(np.float32)
        pitch = rng.integers(1, 255, (b, t)).astype(np.int32)
        lengths, sid = np.array([t], np.int32), np.array([1], np.int32)
        jm = JSy.SynthesizerTrn(jcfg)
        ref = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a, None,
                                                         method=JSy.SynthesizerTrn.infer))(
            params, phone, lengths, pitch, f0, sid))
        with torch.no_grad():
            out = got.infer(torch.from_numpy(phone), torch.from_numpy(lengths).long(),
                            torch.from_numpy(pitch).long(), torch.from_numpy(f0),
                            torch.from_numpy(sid).long()).numpy()
        assert out.shape == ref.shape == (b, t * 480)
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["f0_0", "v1_without_a_version"])
def test_rvc_files_neither_loader_takes(tmp_path, small_rvc, case):
    """A pitchless voice (``f0: 0``, upstream's *_nono synthesizer: no
    ``emb_pitch``, no harmonic source) and a v1 voice saved before
    process_ckpt wrote ``version`` (upstream reads it as v1; both loaders
    default to v2, whose 768-wide features do not fit).  The JAX loader
    fails on a missing key or a shape; the port's refuses the first by its
    tag and fails on the second's shape."""
    path = str(tmp_path / "voice.pth")
    cpt = _voice_file(path, "v2" if case == "f0_0" else "v1", 48000 if case == "f0_0" else 40000,
                      "48k" if case == "f0_0" else "40k", f0=0 if case == "f0_0" else 1)
    if case == "f0_0":
        pitched = ("enc_p.emb_pitch", "dec.m_source", "dec.noise_convs")
        cpt["weight"] = {k: v for k, v in cpt["weight"].items() if not k.startswith(pitched)}
    else:
        del cpt["version"]
    torch.save(cpt, path)
    with pytest.raises(ValueError, match="missing torch key" if case == "f0_0" else "shape"):
        JV.load_rvc_checkpoint(path)
    with pytest.raises(ValueError if case == "f0_0" else RuntimeError,
                       match="without pitch" if case == "f0_0" else "size mismatch"):
        TV.load_rvc_checkpoint(path, device="cpu")


# ----------------------------------------------------------------- HuBERT

@functools.lru_cache(maxsize=None)
def _hubert_source() -> dict:
    """fairseq names of a seeded small HuBERT: pos_conv as a weight-norm
    pair over dim 2 (the gain off the norm), and fairseq's mask embedding."""
    src = tiny.seeded(lambda: TH.HubertFeatureExtractor("v2", HUBERT_CFG), 21)
    sd = weight_norm_pairs(cpu_state(src), HUBERT_WN, dim=2)
    g = sd["encoder.pos_conv.0.weight_g"]
    gen = torch.Generator().manual_seed(22)
    sd["encoder.pos_conv.0.weight_g"] = g * (1.0 + 0.3 * torch.rand(g.shape, generator=gen))
    sd["mask_emb"] = torch.rand(64)
    return sd


def _jax_trainer_params(fn) -> dict:
    """The flax params the JAX trainer's ``_hubert_apply_for`` closed over."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))["params"]


@pytest.mark.parametrize("fmt", [".pt", ".npz"])
def test_trainer_hubert_matches_jax(tmp_path, monkeypatch, fmt):
    """The trainers' HuBERT from ``AUDIOLAB_WEIGHTS_DIR``: hubert_base.pt as
    fairseq saves it (``model`` in a dict) or hubert_base.npz (flat)."""
    sd = _hubert_source()
    if fmt == ".pt":
        torch.save({"model": sd, "args": None}, tmp_path / "hubert_base.pt")
    else:
        np.savez(tmp_path / "hubert_base.npz", **{k: v.numpy() for k, v in sd.items()})
    monkeypatch.setenv("AUDIOLAB_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(JH, "HubertFeatureExtractor", _eval_shape_init(JH.HubertFeatureExtractor))
    fn = JT._hubert_apply_for(HUBERT_SETTINGS)
    got = TT._hubert_apply_for(HUBERT_SETTINGS, "cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), _jax_trainer_params(fn))
    via_jax = TH.HubertFeatureExtractor("v2", HUBERT_CFG)
    via_jax.load_state_dict(W.hubert_from_jax(params), strict=True)
    _states_equal(got, via_jax)
    wav = (0.3 * np.random.default_rng(1).standard_normal((1, 4000))).astype(np.float32)
    ref = np.asarray(jax.jit(fn)(jnp.asarray(wav)))
    with torch.no_grad():
        out = got(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_trainer_hubert_keeps_its_own_values_where_the_file_has_none(tmp_path, monkeypatch):
    """``strict=False`` in both trainers: a key the file lacks keeps the
    module's initial value, every other is the file's."""
    missing = "encoder.layers.1.fc2.bias"
    torch.save({"model": {k: v for k, v in _hubert_source().items() if k != missing}},
               tmp_path / "hubert_base.pt")
    monkeypatch.delenv("AUDIOLAB_WEIGHTS_DIR", raising=False)
    init = TT._hubert_apply_for(HUBERT_SETTINGS, "cpu").state_dict()
    monkeypatch.setenv("AUDIOLAB_WEIGHTS_DIR", str(tmp_path))
    got = TT._hubert_apply_for(HUBERT_SETTINGS, "cpu").state_dict()
    assert torch.equal(got[missing], init[missing])
    want = TV.fold_state_dict(dict(_hubert_source()), dim=2)
    for k, v in got.items():
        if k != missing:
            assert torch.equal(v, want[k]), k
    monkeypatch.setattr(JH, "HubertFeatureExtractor", _eval_shape_init(JH.HubertFeatureExtractor))
    fc2 = _jax_trainer_params(JT._hubert_apply_for(HUBERT_SETTINGS))["hubert"]["layer_1"]["fc2"]
    np.testing.assert_array_equal(fc2["kernel"], want["encoder.layers.1.fc2.weight"].numpy().T)


# ------------------------------------------------------------------ RMVPE

def test_rmvpe_loader_matches_jax(tmp_path, monkeypatch):
    """``load_rmvpe_checkpoint`` and ``RMVPE.from_checkpoint`` of both
    packages at tiny_port's RM_SIZES (the JAX template by eval_shape)."""
    src = tiny.seeded(lambda: TRm.RMVPE(dtype=None, **tiny.RM_SIZES), 23)
    assert float(src.state_dict()["fc.0.gru.bias_hh_l0"][:8].abs().min()) > 0
    path = str(tmp_path / "rmvpe.pt")
    torch.save(cpu_state(off_their_init(src, 24)), path)

    full = TRm.RMVPE

    class Small(full):
        def __init__(self, dtype="bfloat16"):
            super().__init__(dtype, **tiny.RM_SIZES)

    monkeypatch.setattr(TRm, "RMVPE", Small)
    monkeypatch.setattr(JRm, "E2E", functools.partial(_eval_shape_init(JRm.E2E), **tiny.RM_SIZES))
    v = JV.load_rmvpe_checkpoint(path)
    j = JRm.RMVPE.from_checkpoint(path)
    got = TV.load_rmvpe_checkpoint(path, device="cpu")
    assert isinstance(got, Small) and got.unet.dtype == torch.bfloat16
    via_jax = full(dtype=None, **tiny.RM_SIZES)
    via_jax.load_state_dict(W.rmvpe_from_jax(v["params"], v["batch_stats"]), strict=True)
    _states_equal(got, via_jax)
    _states_equal(Small.from_checkpoint(path, device="cpu"), via_jax)
    for a, b in zip(jax.tree_util.tree_leaves(j.variables), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    mel = np.random.default_rng(3).standard_normal((1, 32, 128)).astype(np.float32)
    e2e = JRm.E2E.func(**tiny.RM_SIZES, dtype=None)
    ref = np.asarray(jax.jit(e2e.apply)(v, jnp.asarray(mel)))
    with torch.no_grad():
        out = via_jax(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ CREPE

def test_crepe_loader_matches_jax(tmp_path):
    """A file without ``num_batches_tracked`` (as torch before 0.4.1 saved
    batch norms), which neither package reads: the count stays the
    module's own."""
    src = off_their_init(tiny.seeded(lambda: TCr.Crepe("tiny"), 25, 0.3), 26)
    path = str(tmp_path / "tiny.pth")
    torch.save({k: v for k, v in cpu_state(src).items()
                if not k.endswith("num_batches_tracked")}, path)
    v = JV.load_crepe_checkpoint(path, "tiny")
    via_jax = TCr.Crepe("tiny")
    via_jax.load_state_dict(W.crepe_from_jax(v["params"], v["batch_stats"]), strict=True)
    got = TV.load_crepe_checkpoint(path, "tiny", device="cpu")
    _states_equal(got, via_jax)
    predictor = TCr.CrepePredictor.from_checkpoint(path, "tiny", device="cpu")
    _states_equal(predictor.net, via_jax)
    jp = JCr.CrepePredictor.from_checkpoint(path, "tiny")
    frames = np.random.default_rng(0).standard_normal((8, JCr.WINDOW)).astype(np.float32)
    ref = np.asarray(jp._salience(jp.variables, jnp.asarray(frames)))
    with torch.no_grad():
        out = got(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# --------------------------------------------------------------- HTDemucs

def test_htdemucs_loader_matches_jax(tmp_path):
    """A demucs state_dict under a bag's ``models.0.`` prefix."""
    src = tiny.seeded(lambda: THt.HTDemucs(THt.HTDemucsConfig(**tiny.HTD)), 27)
    path = str(tmp_path / "htdemucs.th")
    torch.save({f"models.0.{k}": v for k, v in cpu_state(src).items()}, path)
    params = JV.load_htdemucs_checkpoint(path, JHt.HTDemucsConfig(**tiny.HTD))
    cfg = THt.HTDemucsConfig(**tiny.HTD)
    via_jax = THt.HTDemucs(cfg)
    via_jax.load_state_dict(W.htdemucs_from_jax(params), strict=True)
    got = TV.load_htdemucs_checkpoint(path, cfg, device="cpu")
    _states_equal(got, via_jax)
    x = (0.3 * np.random.default_rng(5).standard_normal((1, 2, 1000))).astype(np.float32)
    jm = JHt.HTDemucs(JHt.HTDemucsConfig(**tiny.HTD))
    ref = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x)))
    with torch.no_grad():
        out = got(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


# ----------------------------------------------------------------- MDX23C

def test_mdx23c_loader_matches_jax(tmp_path):
    """ZFTurbo's names (the down/upscale Sequential under ``.conv``), the
    config given as a dict of its fields."""
    src = tiny.seeded(lambda: TMc.TFCTDFNetV3(TMc.MDX23CConfig(**tiny.MDXC)), 28)
    sd = mdx23c_upstream_names(cpu_state(src))
    assert any(".downscale.conv." in k for k in sd)
    path = str(tmp_path / "mdx23c.ckpt")
    torch.save(sd, path)
    params, jm = JV.load_mdx23c_checkpoint(path, dict(tiny.MDXC))
    got = TV.load_mdx23c_checkpoint(path, dict(tiny.MDXC), device="cpu")
    via_jax = TMc.TFCTDFNetV3(TMc.MDX23CConfig(**tiny.MDXC))
    via_jax.load_state_dict(W.mdx23c_from_jax(params), strict=True)
    _states_equal(got, via_jax)
    n = jm.good_length(0.25)
    x = (0.3 * np.random.default_rng(11).standard_normal((1, 2, n))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x)))
    with torch.no_grad():
        out = got(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


# --------------------------------------------------------------------- VR

def _vr_file(path, arch: str, prefix: str = "") -> None:
    """A seeded VR net's state_dict with its batch norms off their folded
    form, LSTM biases on both sides and the training heads, every key under
    ``prefix``."""
    src = off_their_init(tiny.seeded(lambda: TVr.make_vr_net(TVr.VRConfig(n_fft=128,
                                                                      **VR_TINY[arch])), 29), 30)
    torch.save({f"{prefix}{k}": v for k, v in cpu_state(src).items()}, path)


@pytest.mark.parametrize("arch", sorted(VR_TINY))
def test_vr_loader_matches_jax(tmp_path, arch):
    """The arch and widths sniffed from the tensors by both loaders
    (``n_fft`` given for the old arch)."""
    path = str(tmp_path / "vr.pth")
    _vr_file(path, arch)
    n_fft = 128 if arch == "cascaded_asppnet" else None
    params, jm = JV.load_vr_checkpoint(path, n_fft=n_fft)
    got = TV.load_vr_checkpoint(path, n_fft=n_fft, device="cpu")
    assert got.cfg == TVr.VRConfig(n_fft=128, **VR_TINY[arch])
    via_jax = TVr.make_vr_net(got.cfg)
    via_jax.load_state_dict(W.vr_from_jax(params), strict=True)
    _states_equal(got, via_jax)
    mag = np.abs(np.random.default_rng(1).standard_normal((1, 2, 64, 32))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(mag.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        out = got(torch.from_numpy(mag)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", sorted(VR_TINY))
def test_vr_prefixed_file_loads_with_its_config(tmp_path, arch):
    """A ``module.``-prefixed file: both loaders sniff the arch from the
    file's own keys, before the prefix goes, so without ``cfg`` both raise
    the KeyError of the key they look for; with it both strip the prefix
    and load the same tensors."""
    path = str(tmp_path / "vr.pth")
    _vr_file(path, arch, "module.")
    with pytest.raises(KeyError, match="out.weight"):
        JV.load_vr_checkpoint(path, n_fft=128)
    with pytest.raises(KeyError, match="out.weight"):
        TV.load_vr_checkpoint(path, n_fft=128, device="cpu")
    cfg = dict(n_fft=128, **VR_TINY[arch])
    params, _ = JV.load_vr_checkpoint(path, cfg=JVr.VRConfig(**cfg))
    got = TV.load_vr_checkpoint(path, cfg=TVr.VRConfig(**cfg), device="cpu")
    via_jax = TVr.make_vr_net(got.cfg)
    via_jax.load_state_dict(W.vr_from_jax(params), strict=True)
    _states_equal(got, via_jax)
