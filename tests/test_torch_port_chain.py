"""The port's separate -> RVC chain against the JAX package's, on the CPU,
fp32, tiny configurations: the ensemble StemSeparator (two distinct
BS-RoFormer members, four chunks in two device groups), the mono mix, the
44.1 -> 16 kHz resample and VoiceConverter.convert (v2, rmvpe f0, retrieval
on), each stage fed by the one before it in its own package, with the
stage boundaries compared.  Noise is zero on both sides (the _Noise patch).
The RoFormer weights are seeded in port modules, mapped onto the flax tree
by the JAX package's ``convert_roformer`` and carried back by
``roformer_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolab_tpu.kernels.resample import resample as j_resample
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.models.separation import roformer as JRo
from audiolab_tpu.pipelines import rvc as JP
from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu.utils.convert import convert_roformer
from audiolab_tpu_torch.core.chunking import plan_chunks
from audiolab_tpu_torch.kernels.resample import resample
from audiolab_tpu_torch.models.separation import roformer as TRo
from audiolab_tpu_torch.pipelines import rvc as TP
from audiolab_tpu_torch.pipelines import separate as TSep
from audiolab_tpu_torch.utils.weights import roformer_from_jax
from tests import torch_port_tiny as tiny
from tests.test_torch_port_rvc import _mel_l1, _Noise

ROFORMER = dict(dim=32, depth=2, heads=2, dim_head=16, freqs_per_bands=(16, 16, 32, 65),
                n_fft=256, hop=64, dtype="float32", stems=("vocals",), residual_stem="other")
SEP_SR, RVC_SR = 44100, 16000
MEL_L1_GATE = 1e-2


def _members():
    """Two members with distinct weights, as (JAX, port) EnsembleMember
    pairs: the first hands the JAX separator its params (its one-graph
    member), the second closes over them (its group loop)."""
    jcfg, tcfg = JRo.RoformerConfig(**ROFORMER), TRo.RoformerConfig(**ROFORMER)
    model = JRo.BSRoformer(jcfg)
    tpl = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2560))))
    j_members, t_members = [], []
    for i, (wv, wi) in enumerate([(8.6, 16.0), (8.4, 16.0)]):
        src = tiny.seeded(lambda: TRo.BSRoformer(tcfg), 20 + i)
        sd = {k: v.detach().numpy() for k, v in src.state_dict().items()}
        p = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32),
            convert_roformer(sd, tpl["params"], stems=jcfg.stems))
        port = TRo.BSRoformer(tcfg)
        port.load_state_dict(roformer_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                               tcfg.stems), strict=True)
        if i == 0:
            j_members.append(JSep.EnsembleMember(
                f"m{i}", lambda pp, b: model.apply({"params": pp}, b), wv, wi, params=p))
        else:
            j_members.append(JSep.EnsembleMember(
                f"m{i}", lambda b, pp=p: model.apply({"params": pp}, b), wv, wi))
        t_members.append(TSep.EnsembleMember(f"m{i}", port.eval(), wv, wi))
    return j_members, t_members


def _converters(index):
    sp, tsy = tiny.synth()
    hp, thub = tiny.hubert()
    jrm, trm = tiny.rmvpe()
    kw = dict(sr=48000, f0_method="rmvpe", chunk_seconds=0.5, overlap_seconds=0.1,
              device_batch=2, matmul_precision="highest")
    jvc = JP.VoiceConverter(JSy.SynthesizerConfig(**tiny.SYNTH), sp, hp, rmvpe=jrm,
                            index_features=index, hubert_cfg=JH.HubertConfig(**tiny.HCFG),
                            cfg=JP.RVCPipelineConfig(**kw))
    tvc = TP.VoiceConverter(tsy, thub, trm, index_features=index, device="cpu",
                            cfg=TP.RVCPipelineConfig(**kw))
    return jvc, tvc


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_chain_matches_jax(monkeypatch):
    """Stems to 1e-5, the 16 kHz input to 1e-5, the 48 kHz output to 1e-3
    and mel-L1 < 1e-2 (BASELINE.md's gate, measured as
    tests/test_fidelity.py measures it)."""
    _Noise(zero=True).patch(monkeypatch)
    n = SEP_SR
    t = np.arange(n) / SEP_SR
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    rng = np.random.default_rng(0)
    x = np.stack([tone, 0.8 * tone]) + 0.05 * rng.standard_normal((2, n))
    x = x.astype(np.float32)
    index = rng.standard_normal((200, tiny.HCFG["dim"])).astype(np.float32)
    j_members, t_members = _members()
    skw = dict(sr=SEP_SR, chunk_seconds=0.3, overlap_seconds=0.05, device_batch=2,
               matmul_precision="highest")
    jsep = JSep.StemSeparator(j_members, **skw)
    tsep = TSep.StemSeparator(t_members, device="cpu", **skw)
    jvc, tvc = _converters(index)

    ref_stems = jsep.separate(x, as_numpy=False)
    ref16 = j_resample(ref_stems["vocals"].mean(axis=0), SEP_SR, RVC_SR)
    ref = np.asarray(jvc.convert(ref16, sid=1, transpose=2, seed=0, as_numpy=False))

    with torch.inference_mode():
        stems = tsep.separate(x, as_numpy=False)
        x16 = resample(stems["vocals"].mean(dim=0), SEP_SR, RVC_SR)
        out = tvc.convert(x16, sid=1, transpose=2, seed=0, as_numpy=False).numpy()

    plan = plan_chunks(n, int(0.3 * SEP_SR), int(0.05 * SEP_SR))
    assert plan.count > skw["device_batch"], "the separator must run two groups"
    for stem in ("vocals", "instrumental"):
        err = _maxdiff(stems[stem].numpy(), ref_stems[stem])
        assert stems[stem].shape == (2, n) and err < 1e-5, f"{stem}: max|diff| {err:.3e}"
    err16 = _maxdiff(x16.numpy(), ref16)
    assert x16.shape == ref16.shape and err16 < 1e-5, f"16 kHz input: max|diff| {err16:.3e}"
    assert out.shape == ref.shape and np.isfinite(out).all()
    err_out = _maxdiff(out, ref)
    mel = _mel_l1(out, ref, 48000)
    print(f"chain: {plan.count} separator chunks, stems max|diff| "
          f"{_maxdiff(stems['vocals'].numpy(), ref_stems['vocals']):.3e}, 16 kHz {err16:.3e}, "
          f"output max|diff| {err_out:.3e} (peak {np.abs(ref).max():.3e}), mel-L1 {mel:.3e}")
    assert mel < MEL_L1_GATE and err_out < 1e-3, (
        f"48 kHz output: mel-L1 {mel:.3e} (gate {MEL_L1_GATE}), max|diff| {err_out:.3e}")
