"""The port's CREPE (models/crepe.py) and the crepe f0 methods of its
VoiceConverter against the JAX package's, on the CPU, with torchcrepe's
'tiny' capacity: the net's weights carried by ``crepe_from_jax`` (batch
norm statistics included) and read back by the JAX ``convert_crepe``.

Tolerances: salience within 1e-5 (fp32 convolutions summed in another
order); the Viterbi path identical bin for bin on inputs whose salience has
no near-tie, so that f0 agrees to fp32 rounding (1e-4 Hz) and the
periodicity to 1e-5; the converter's f0 for every crepe method to 1e-4 Hz.
Every input is 1 s (101 frames at hop 160, 126 at hop 128), so the JAX
side compiles its salience and its Viterbi scan once per hop."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import crepe as JCr
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.pipelines import rvc as JP
from audiolab_tpu.utils.convert import convert_crepe
from audiolab_tpu_torch.models import crepe as TCr
from audiolab_tpu_torch.pipelines import rvc as TP
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

SR = 16000


@functools.lru_cache(maxsize=None)
def _crepe():
    """(variables, JAX CrepePredictor, port CrepePredictor) for 'tiny'."""
    tpl = jax.eval_shape(lambda: JCr.Crepe("tiny").init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, JCr.WINDOW))))
    src = tiny.seeded(lambda: TCr.Crepe("tiny"), 11, 0.3)
    v = tiny._f32(convert_crepe(tiny._numpy(src), {"params": tpl["params"],
                                                   "batch_stats": tpl["batch_stats"]}))
    net = TCr.Crepe("tiny")
    net.load_state_dict(W.crepe_from_jax(v["params"], v["batch_stats"]), strict=True)
    jp = JCr.CrepePredictor(v["params"], v["batch_stats"], "tiny")
    return v, jp, TCr.CrepePredictor(net, device="cpu")


def _glide(n, seed, f0=180.0, f1=420.0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    x = 0.4 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * t[-1])))
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_crepe_weights_round_trip_and_salience():
    v, jp, tp = _crepe()
    back = convert_crepe({k: t.numpy() for k, t in tp.net.state_dict().items()},
                         jax.eval_shape(lambda: v))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    frames = np.random.default_rng(0).standard_normal((20, JCr.WINDOW)).astype(np.float32)
    ref = np.asarray(jp._salience(jp.variables, jnp.asarray(frames)))
    with torch.no_grad():
        out = tp.net(torch.from_numpy(frames)).numpy()
    assert out.shape == ref.shape == (20, 360)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_viterbi_matches_jax():
    """Salience with one sharp peak a frame, wandering: the same path."""
    rng = np.random.default_rng(1)
    centre = np.clip(180 + np.cumsum(rng.integers(-3, 4, 101)), 10, 350)
    probs = 0.05 * rng.random((101, 360)).astype(np.float32)
    probs[np.arange(101), centre] = 1.0
    ref = np.asarray(JCr.viterbi_bins(jnp.asarray(probs)))
    out = TCr.viterbi_bins(torch.from_numpy(probs))
    assert out.dtype == torch.int64 and len(set(ref.tolist())) > 10
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(TCr.viterbi_bins(torch.from_numpy(np.stack([probs] * 3))),
                                  np.stack([ref] * 3))
    np.testing.assert_allclose(TCr.bins_to_f0(torch.from_numpy(ref)).numpy(),
                               np.asarray(JCr.bins_to_f0(jnp.asarray(ref))), atol=1e-4, rtol=0)


@pytest.mark.parametrize("hop", [160, 128])
def test_predict_and_mangio_match_jax(hop, monkeypatch):
    """predict (periodicity gate, filters) and predict_mangio (quantile
    normalisation, the curve resampled to n // hop frames) on a 1 s
    glide; the port takes two rows in one call and gives each row's JAX
    result, with the frames through the net in batches of 16."""
    monkeypatch.setattr(TCr, "FRAME_BATCH", 16)
    _v, jp, tp = _crepe()
    xs = [_glide(SR, 2), _glide(SR, 3, 300.0, 150.0)]
    f0, pd = tp.predict(np.stack(xs), hop=hop)
    mangio = tp.predict_mangio(np.stack(xs), hop=hop)
    for i, x in enumerate(xs):
        rf, rp = (np.asarray(a) for a in jp.predict(x, hop=hop))
        assert f0[i].shape == rf.shape == (1 + SR // hop,) and (rf > 0).any()
        np.testing.assert_allclose(f0[i].numpy(), rf, atol=1e-4, rtol=0)
        np.testing.assert_allclose(pd[i].numpy(), rp, atol=1e-5, rtol=0)
        rm = np.asarray(jp.predict_mangio(x, hop=hop))
        assert mangio[i].shape == rm.shape == (SR // hop,)
        np.testing.assert_allclose(mangio[i].numpy(), rm, atol=1e-4, rtol=0)
    one, _ = tp.predict(xs[0], hop=hop)
    np.testing.assert_array_equal(one.numpy(), f0[0].numpy())


def _pair(method, **kw):
    _v, jp, tp = _crepe()
    sp, tsy = tiny.synth()
    hp, thub = tiny.hubert()
    kw = dict(sr=48000, f0_method=method, chunk_seconds=1.0, overlap_seconds=0.2,
              device_batch=2, matmul_precision="highest", **kw)
    jvc = JP.VoiceConverter(JSy.SynthesizerConfig(**tiny.SYNTH), sp, hp, crepe=jp,
                            hubert_cfg=JH.HubertConfig(**tiny.HCFG),
                            cfg=JP.RVCPipelineConfig(**kw))
    tvc = TP.VoiceConverter(tsy, thub, crepe=tp, device="cpu", cfg=TP.RVCPipelineConfig(**kw))
    return jvc, tvc


@pytest.mark.parametrize("method,extra", [
    ("crepe", {}),
    ("crepe-tiny", {"crepe_hop": 128}),
    ("mangio-crepe", {}),
    ("mangio-crepe-tiny", {"crepe_hop": 128, "f0_autotune": True}),
    ("hybrid", {}),                           # no RMVPE: crepe + harvest
])
def test_converter_crepe_methods_match_jax(method, extra):
    """The f0 a converter hands one group of two chunks, transposed by +2,
    for each crepe method (and the hybrid's default pair without RMVPE):
    to 1e-4 Hz of the JAX converter's, on the host path (no YIN)."""
    jvc, tvc = _pair(method, **extra)
    assert jvc._f0_on_host() and tvc._f0_on_host()
    wav = np.stack([_glide(16000, 4), _glide(16000, 5, 260.0, 200.0)])
    ref = np.asarray(jvc._extract_f0(jnp.asarray(wav), 2))
    with torch.no_grad():
        out = tvc._extract_f0(torch.from_numpy(wav), 2).numpy()
        yin = tvc._yin(torch.from_numpy(wav)).numpy() * 2.0 ** (2 / 12)
    assert out.shape == ref.shape == (2, 101) and (ref > 0).any()
    np.testing.assert_allclose(out, ref, atol=1e-4 if method != "hybrid" else 1e-2, rtol=0)
    assert np.abs(out - yin).max() > 1.0
