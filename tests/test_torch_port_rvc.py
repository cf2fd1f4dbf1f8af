"""Parity of the port's RVC path with the JAX package's, on the CPU, fp32,
tiny configurations: HuBERT (v1/v2), RMVPE salience and f0, the retrieval
blend, the synthesizer's infer with zero and with injected noise, coarse
pitch, the device high-pass, and ``VoiceConverter.convert`` end to end.

Weights come from flax inits and reach the port through utils/weights.py.
Noise: the JAX package draws from ``jax.random.normal``; the tests replace
it, and the port's ``_randn``, with the same arrays made by numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.dsp.f0 import coarse_f0 as j_coarse_f0
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models import rmvpe as JRm
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.pipelines import rvc as JP
from audiolab_tpu.retrieval.index import knn_blend as j_knn_blend
from audiolab_tpu.utils.convert import convert_hubert, convert_rmvpe, convert_rvc
from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.dsp.f0 import coarse_f0
from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import rmvpe as TRm
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.pipelines import rvc as TP
from audiolab_tpu_torch.retrieval.index import knn_blend
from audiolab_tpu_torch.utils import weights as W
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

HCFG = dict(dim=32, ffn_dim=64, heads=4, layers=2, final_dim=16)
RM_SIZES = dict(en_de_layers=2, inter_layers=1, n_blocks=1, en_out_channels=4, gru_hidden=8)
SYNTH = dict(spec_channels=129, segment_size=3840, inter_channels=16, hidden_channels=16,
             filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
             spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


def _leaves_equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=0, rtol=0)


# ------------------------------------------------------------------ HuBERT

def _hubert(version, seed=0):
    jm = JH.HubertFeatureExtractor(version=version, cfg=JH.HubertConfig(**HCFG))
    p = _perturb(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4000)))["params"], seed)
    tm = TH.HubertFeatureExtractor(version, TH.HubertConfig(**HCFG))
    tm.load_state_dict(W.hubert_from_jax(p), strict=True)
    return jm, p, tm.eval()


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_hubert_matches_jax(version):
    """Features to 2e-5 (fp32; LayerNorm/GroupNorm variance formulas differ)."""
    jm, p, tm = _hubert(version)
    wav = (0.3 * np.random.default_rng(1).standard_normal((2, 4000))).astype(np.float32)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(wav)))
    with torch.no_grad():
        out = tm(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    sd = {k: v.numpy() for k, v in W.hubert_from_jax(p).items()}
    _leaves_equal(convert_hubert(sd, p), p)


# ------------------------------------------------------------------- RMVPE

def _rmvpe(seed=0):
    e2e = JRm.E2E(**RM_SIZES)
    v = e2e.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 128)))
    params = _perturb(v["params"], seed)
    rng = np.random.default_rng(seed + 7)
    stats = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape) + (a if a.any() else 0)).astype(np.float32),
        v["batch_stats"])
    stats = jax.tree_util.tree_map(np.abs, stats)   # positive variances (means too: harmless)
    j = JRm.RMVPE(dtype=None)
    j.model = e2e
    j.variables = {"params": params, "batch_stats": stats}
    t = TRm.RMVPE(dtype=None, **RM_SIZES)
    t.load_state_dict(W.rmvpe_from_jax(params, stats), strict=True)
    return j, t.eval(), params, stats


def test_rmvpe_salience_and_f0_match_jax():
    """Salience to 1e-5 and f0 to 1e-3 Hz in fp32 (no bf16 argmax ties)."""
    j, t, params, stats = _rmvpe()
    sr = 16000
    n = np.arange(8000)
    wav = (0.4 * np.sin(2 * np.pi * 220 * n / sr)
           + 0.05 * np.random.default_rng(2).standard_normal(8000)).astype(np.float32)[None]
    mel_j = j.mel(jnp.asarray(wav))
    with torch.no_grad():
        mel_t = t.mel(torch.from_numpy(wav))
        np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=1e-4)
        sal = t(mel_t).numpy()
        f0 = t.infer(torch.from_numpy(wav)).numpy()
    sal_ref = np.array(j.model.apply(j.variables, mel_j))
    np.testing.assert_allclose(sal, sal_ref, atol=1e-5, rtol=0)
    f0_ref = np.asarray(j.infer(jnp.asarray(wav)))
    np.testing.assert_allclose(f0, f0_ref, atol=1e-3, rtol=0)
    dec = TRm.decode_f0(torch.from_numpy(sal_ref), 0.03).numpy()
    np.testing.assert_allclose(dec, np.asarray(JRm.decode_f0(jnp.asarray(sal_ref))), atol=1e-3)
    sd = {k: v.numpy() for k, v in W.rmvpe_from_jax(params, stats).items()}
    back = convert_rmvpe(sd, {"params": params, "batch_stats": stats})
    _leaves_equal(back["params"], params)
    _leaves_equal(back["batch_stats"], stats)


# --------------------------------------------------------------- retrieval

def test_knn_blend_matches_jax():
    """Blended features (not indices: ties may order differently) to 1e-5."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((50, 16)).astype(np.float32)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    for rate in (0.0, 0.5, 0.75):
        ref = np.asarray(j_knn_blend(jnp.asarray(q), jnp.asarray(data), rate))
        out = knn_blend(torch.from_numpy(q), torch.from_numpy(data), rate).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_coarse_f0_matches_jax():
    f0 = np.concatenate([[0.0, 30.0, 50.0, 1100.0, 2000.0],
                         np.random.default_rng(4).uniform(40, 1200, 200)]).astype(np.float32)
    ref = np.asarray(j_coarse_f0(jnp.asarray(f0)))
    np.testing.assert_array_equal(coarse_f0(torch.from_numpy(f0)).numpy(), ref)


# ------------------------------------------------------------- synthesizer

def _synth(seed=0, t=8):
    cfg = JSy.SynthesizerConfig(**SYNTH)
    jm = JSy.SynthesizerTrn(cfg)
    p = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, t, 32)),
                jnp.full((1,), t, jnp.int32), jnp.ones((1, t), jnp.int32),
                jnp.full((1, t), 200.0), jnp.zeros((1,), jnp.int32), None,
                method=JSy.SynthesizerTrn.infer)["params"]
    p = _perturb(p, seed, 0.05)
    tm = TSy.SynthesizerTrn(TSy.SynthesizerConfig(**SYNTH))
    tm.load_state_dict(W.synthesizer_from_jax(p), strict=True)
    return jm, p, tm.eval()


class _Noise:
    """The same normal draws for both frameworks, keyed by shape."""

    def __init__(self, zero: bool):
        self.zero, self.rng, self.cache = zero, np.random.default_rng(5), {}

    def array(self, shape):
        shape = tuple(int(s) for s in shape)
        if shape not in self.cache:
            self.cache[shape] = (np.zeros(shape, np.float32) if self.zero else
                                 self.rng.standard_normal(shape).astype(np.float32))
        return self.cache[shape]

    def patch(self, monkeypatch):
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                                self.array(shape), dtype))
        monkeypatch.setattr(TSy, "_randn",
                            lambda shape, gen, device: torch.from_numpy(self.array(shape)))


@pytest.mark.parametrize("noise", ["none", "zero", "injected"])
def test_synthesizer_infer_matches_jax(noise, monkeypatch):
    """Audio to 1e-5 (fp32); ``none`` passes rng=None / generator=None."""
    jm, p, tm = _synth()
    b, t = 2, 10
    rng = np.random.default_rng(6)
    phone = rng.standard_normal((b, t, 32)).astype(np.float32)
    f0 = np.where(rng.uniform(size=(b, t)) > 0.3, rng.uniform(100, 400, (b, t)), 0.0
                  ).astype(np.float32)
    pitch = np.array(j_coarse_f0(jnp.asarray(f0)))
    lengths = np.array([t, t - 3], np.int32)
    sid = np.array([1, 3], np.int32)
    key, gen = None, None
    if noise != "none":
        _Noise(noise == "zero").patch(monkeypatch)
        key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(phone), jnp.asarray(lengths),
                              jnp.asarray(pitch), jnp.asarray(f0), jnp.asarray(sid), key,
                              method=JSy.SynthesizerTrn.infer))
    with torch.no_grad():
        out = tm.infer(torch.from_numpy(phone), torch.from_numpy(lengths).long(),
                       torch.from_numpy(pitch).long(), torch.from_numpy(f0),
                       torch.from_numpy(sid).long(), generator=gen).numpy()
    assert out.shape == ref.shape == (b, t * 480)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    if noise == "none":
        sd = {k: v.numpy() for k, v in W.synthesizer_from_jax(p).items()}
        _leaves_equal(convert_rvc(sd, p), p)


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.9])
def test_mix_rms_matches_jax(rate):
    """The RMS-envelope mix to 1e-5 relative to max|y| (fp32)."""
    rng = np.random.default_rng(11)
    x16 = (0.3 * rng.standard_normal(40000)).astype(np.float32)
    y = (np.sin(np.arange(120000) / 50.0) * rng.uniform(0.1, 1.0, 120000)).astype(np.float32)
    ref = np.asarray(JP.VoiceConverter._mix_rms(jnp.asarray(x16), jnp.asarray(y), 48000, rate))
    out = TP._mix_rms(torch.from_numpy(x16), torch.from_numpy(y), 48000, rate).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_highpass_device_matches_jax():
    x = (0.3 * np.random.default_rng(7).standard_normal((2, 3000))).astype(np.float32)
    ref = np.asarray(JP._highpass_device(jnp.asarray(x)))
    np.testing.assert_allclose(TP._highpass_device(torch.from_numpy(x)).numpy(), ref, atol=1e-6)


# --------------------------------------------------------------- pipeline

def _mel_l1(a, b, sr):
    """tests/test_fidelity.py's measure: mean |log-mel difference|."""
    n = min(len(a), len(b))
    ma = log_mel(mel_spectrogram(torch.from_numpy(np.array(a[:n]))[None], sr=sr, n_fft=1024,
                                 hop=256, n_mels=80, power=1.0))
    mb = log_mel(mel_spectrogram(torch.from_numpy(np.array(b[:n]))[None], sr=sr, n_fft=1024,
                                 hop=256, n_mels=80, power=1.0))
    return float((ma - mb).abs().mean())


def _converters():
    jsy, sp, tsy = _synth(seed=1)
    jhub, hp, thub = _hubert("v2", seed=2)
    jrm, trm, _, _ = _rmvpe(seed=3)
    index = np.random.default_rng(8).standard_normal((200, 32)).astype(np.float32)
    cfg = dict(sr=48000, f0_method="rmvpe", chunk_seconds=1.0, overlap_seconds=0.2,
               device_batch=2)
    jvc = JP.VoiceConverter(JSy.SynthesizerConfig(**SYNTH), sp, hp, rmvpe=jrm,
                            index_features=index, hubert_cfg=JH.HubertConfig(**HCFG),
                            cfg=JP.RVCPipelineConfig(matmul_precision="highest", **cfg))
    tvc = {prec: TP.VoiceConverter(tsy, thub, trm, index_features=index, device="cpu",
                                   cfg=TP.RVCPipelineConfig(matmul_precision=prec, **cfg))
           for prec in ("highest", "bfloat16")}
    return jvc, tvc


def _audio():
    n = np.arange(40000)
    return (0.3 * np.sin(2 * np.pi * 220 * n / 16000)
            + 0.02 * np.random.default_rng(9).standard_normal(40000)).astype(np.float32)


def test_voice_converter_matches_jax(monkeypatch):
    """convert end to end (5 chunks in batches of 2 with a padded row,
    retrieval on, rmvpe f0, transpose +2) with zero noise on both sides:
    mel-L1 < 1e-2 (the BASELINE.md gate) and max|diff| < 1e-3."""
    _Noise(zero=True).patch(monkeypatch)
    jvc, tvc = _converters()
    x = _audio()
    ref = jvc.convert(x, sid=1, transpose=2, seed=0)
    out = tvc["highest"].convert(x, sid=1, transpose=2, seed=0)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _mel_l1(out, ref, 48000) < 1e-2
    assert np.abs(out - ref).max() < 1e-3


def _policy_case(op):
    rng = np.random.default_rng(10)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, call = {
        "linear": (t(3, 40, 32), lambda a, w: precision.linear(a, w)),
        "einsum": (t(2, 3, 20, 16), lambda a, w: precision.einsum("bhqd,bhkd->bhqk", a, w)),
        "conv1d_grouped": (t(2, 32, 49), lambda a, w: precision.conv1d(a, w, padding=64,
                                                                      groups=16)),
        "conv_transpose1d": (t(2, 16, 30), lambda a, w: precision.conv_transpose1d(
            a, w, stride=4, padding=2)),
        # HTDemucs's frequency-axis convolution and MDX23C's upscale
        "conv2d": (t(2, 8, 40, 6), lambda a, w: precision.conv2d(a, w, stride=(4, 1),
                                                                 padding=(2, 0))),
        "conv_transpose2d": (t(2, 16, 5, 6), lambda a, w: precision.conv_transpose2d(
            a, w, stride=2)),
        # an ONNX MatMul of broadcast batches
        "matmul_batched": (t(2, 3, 20, 16), lambda a, w: precision.matmul(a, w)),
    }[op]
    w = {"linear": t(24, 32), "einsum": t(2, 3, 25, 16), "conv1d_grouped": 0.1 * t(32, 2, 128),
         "conv_transpose1d": t(16, 8, 8), "conv2d": t(6, 8, 8, 1),
         "conv_transpose2d": t(16, 8, 2, 2), "matmul_batched": t(3, 16, 24)}[op]
    return x, w, call


POLICY_OPS = ["linear", "einsum", "conv1d_grouped", "conv_transpose1d", "conv2d",
              "conv_transpose2d", "matmul_batched"]


@pytest.mark.parametrize("op", POLICY_OPS)
def test_bf16_policy_rounds_operands_not_result(op):
    """``matmul_precision("bfloat16")`` computes the fp32 product of the
    bf16-rounded operands and returns it unrounded, as
    ``jax.default_matmul_precision("bfloat16")`` does; outside the block
    the product stays fp32.  The grouped convolution is HuBERT's positional
    one (k=128, 16 groups), which the CPU's own bf16 convolution gets wrong.
    Tolerance: 1e-6 of the largest output (fp32 sums in another order),
    while a bf16 rounding of the result would move it by up to 2^-9."""
    x, w, call = _policy_case(op)
    full = call(x, w)
    with precision.matmul_precision("bfloat16"):
        low = call(x, w)
    expect = call(x.bfloat16().float(), w.bfloat16().float())
    big = float(expect.abs().max())
    np.testing.assert_allclose(low.numpy(), expect.numpy(), atol=1e-6 * big, rtol=0)
    rounded = expect.bfloat16().float()
    assert float((low - rounded).abs().max()) > 1e-4 * big, "the result was rounded to bf16"
    assert float((low - full).abs().max()) <= 2.0 ** -6 * big
    np.testing.assert_array_equal(call(x, w).numpy(), full.numpy())


@pytest.mark.parametrize("op", POLICY_OPS)
def test_bf16_policy_matches_jax_on_rounded_operands(op):
    """The policy's product against the JAX function on the same operands
    rounded to bf16 (XLA:CPU computes fp32 products whatever precision is
    asked, so the rounding is fed to it explicitly), fp32 tolerance."""
    x, w, call = _policy_case(op)
    with precision.matmul_precision("bfloat16"):
        low = call(x, w).numpy()
    xr = jnp.asarray(x.bfloat16().float().numpy())
    wr = jnp.asarray(w.bfloat16().float().numpy())
    dn = ("NCH", "OIH", "NCH")
    if op == "linear":
        ref = xr @ wr.T
    elif op == "einsum":
        ref = jnp.einsum("bhqd,bhkd->bhqk", xr, wr)
    elif op == "conv1d_grouped":
        ref = jax.lax.conv_general_dilated(xr, wr, (1,), [(64, 64)], dimension_numbers=dn,
                                           feature_group_count=16)
    elif op == "conv_transpose1d":
        # torch's transposed conv as a dilated conv with the kernel flipped
        k = jnp.flip(jnp.transpose(wr, (1, 0, 2)), -1)
        pad = w.shape[-1] - 1 - 2
        ref = jax.lax.conv_general_dilated(xr, k, (1,), [(pad, pad)], lhs_dilation=(4,),
                                           dimension_numbers=dn)
    elif op == "matmul_batched":
        ref = jnp.matmul(xr, wr)
    elif op == "conv2d":
        ref = jax.lax.conv_general_dilated(xr, wr, (4, 1), [(2, 2), (0, 0)],
                                           dimension_numbers=("NCHW", "OIHW", "NCHW"))
    else:
        k = jnp.flip(jnp.transpose(wr, (1, 0, 2, 3)), (-2, -1))
        ref = jax.lax.conv_general_dilated(xr, k, (1, 1), [(1, 1), (1, 1)], lhs_dilation=(2, 2),
                                           dimension_numbers=("NCHW", "OIHW", "NCHW"))
    ref = np.asarray(ref, np.float32)
    assert low.shape == ref.shape
    np.testing.assert_allclose(low, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
