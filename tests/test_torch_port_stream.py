"""The port's streaming voice conversion (pipelines/rvc_stream.py) against
the JAX package's, on the CPU: the tiny v2 converter of
tests/torch_port_tiny.py with harvest f0 (host numpy, bit for bit in both
packages) and the synthesizer's noise zeroed on both sides, pushed four
blocks of a tone: every block within 1e-4 of the JAX block's peak (fp32
HuBERT and synthesizer in another summation order; the SOLA search is the
same host code and picks the same shift)."""

import numpy as np

from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.pipelines import rvc as JP
from audiolab_tpu.pipelines import rvc_stream as JS
from audiolab_tpu_torch.pipelines import rvc as TP
from audiolab_tpu_torch.pipelines import rvc_stream as TS
from tests import torch_port_tiny as tiny
from tests.test_torch_port_rvc import _Noise


def test_streaming_vc_matches_jax(monkeypatch):
    _Noise(zero=True).patch(monkeypatch)
    sp, tsy = tiny.synth()
    hp, thub = tiny.hubert()
    kw = dict(sr=48000, f0_method="harvest", matmul_precision="highest")
    jvc = JP.VoiceConverter(JSy.SynthesizerConfig(**tiny.SYNTH), sp, hp,
                            hubert_cfg=JH.HubertConfig(**tiny.HCFG),
                            cfg=JP.RVCPipelineConfig(**kw))
    tvc = TP.VoiceConverter(tsy, thub, device="cpu", cfg=TP.RVCPipelineConfig(**kw))
    scfg = dict(block_seconds=0.1, context_seconds=0.3, sola_search_ms=5.0, crossfade_ms=10.0)
    js = JS.StreamingVC(jvc, JS.StreamConfig(**scfg), sid=1, transpose=3)
    ts = TS.StreamingVC(tvc, TS.StreamConfig(**scfg), sid=1, transpose=3)
    assert (ts.block, ts.context, ts.block_out, ts.fade) == (js.block, js.context,
                                                             js.block_out, js.fade)
    t = np.arange(4 * ts.block) / 16000
    x = (0.3 * np.sin(2 * np.pi * 210 * t) * (1 + 0.2 * np.sin(2 * np.pi * 2 * t))
         + 0.01 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    for i in range(4):
        block = x[i * ts.block:(i + 1) * ts.block]
        ref, out = js.push(block), ts.push(block)
        assert out.shape == ref.shape == (ts.block_out,) and np.isfinite(out).all()
        peak = float(np.abs(ref).max())
        assert peak > 1e-3
        assert np.abs(out - ref).max() <= 1e-4 * peak, (i, np.abs(out - ref).max() / peak)
    np.testing.assert_allclose(ts.buffer, js.buffer)
