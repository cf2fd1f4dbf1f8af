"""Each plain reference against the port at a tiny configuration on the
CPU, fp32 on both sides: the same weights (by name, from one seed) give the
same outputs."""

import json

import numpy as np
import pytest
import torch

from benchmark import generator, harness, weights
from benchmark.reference import dsp, hubert, rmvpe, roformer, vits

REF = harness.load_module(harness.ROOT / "reference" / "chain-bsroformer2-rvc48k" / "reference.py",
                          "chain_reference_for_tests")


@pytest.fixture(scope="module")
def cfg(tree):
    return json.loads((tree / "benchmark" / "configs" / "tiny-chain.json").read_text())


def same_keys(a, b):
    assert set(a.state_dict()) == set(b.state_dict())


def test_roformer(cfg):
    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig

    sep = cfg["separator"]
    rc = REF.roformer_config(sep)
    port = BSRoformer(RoformerConfig(**{**rc.__dict__, "dtype": "float32"}))
    ref = roformer.BSRoformer(rc)
    same_keys(port, ref)
    weights.fill(port, 3), weights.fill(ref, 3)
    x = 0.1 * torch.randn(2, 2, int(sep["chunk_s"] * sep["sr"]), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = port(x), ref(x)
    for k in ("vocals", "other"):
        assert float((a[k] - b[k]).abs().max()) <= 1e-5 * float(b[k].abs().max())


def test_hubert_rmvpe_synthesizer_and_convert(cfg):
    from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor
    from audiolab_tpu_torch.models.rmvpe import RMVPE
    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig, SynthesizerTrn
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter

    conv = cfg["converter"]
    init = cfg["init"]
    ph = weights.fill(HubertFeatureExtractor("v2", HubertConfig(**conv["hubert"])), 4)
    rh = weights.fill(hubert.Hubert(**conv["hubert"]), 4)
    pr = weights.fill(RMVPE(dtype=None), 5, init["rmvpe"])
    rr = weights.fill(rmvpe.RMVPE(), 5, init["rmvpe"])
    sc = REF.synth_config(conv)
    ps = weights.fill(SynthesizerTrn(SynthesizerConfig(**sc.__dict__)), 6)
    rs = weights.fill(vits.Synthesizer(sc), 6)
    for a, b in ((ph, rh), (pr, rr), (ps, rs)):
        same_keys(a, b)
    x16 = dsp.resample(generator.song(44100 * 3, 44100, json.loads(
        (generator.ROOT / "traffic" / "song.json").read_text())["content"], 11, "cpu").mean(0),
        44100, 16000)
    with torch.no_grad():
        a, b = ph(x16[None]), rh(x16[None])
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        a, b = pr.infer(x16[None]), rr.f0(x16[None])
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    index = np.random.default_rng(0).standard_normal((600, conv["hubert"]["dim"])).astype(np.float32)
    vc = VoiceConverter(ps, ph, pr, index_features=index, device="cpu", cfg=RVCPipelineConfig(
        version="v2", sr=sc.sr, chunk_seconds=conv["chunk_s"], overlap_seconds=conv["overlap_s"],
        device_batch=conv["device_batch"], matmul_precision="highest"))
    chain = REF.Chain.__new__(REF.Chain)
    chain.cfg, chain.dev, chain.lower = cfg, torch.device("cpu"), None
    chain.hubert, chain.rmvpe, chain.synth, chain.index = rh, rr, rs, torch.from_numpy(index)
    with torch.no_grad():
        a, (b, own) = vc.convert(x16, seed=5, as_numpy=False), chain.convert(x16, 5)
        given, _ = chain.convert(x16, 5, salience=own)      # the stage-by-stage path
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert torch.equal(given, b)


def test_resample_and_stitch_match_the_port():
    from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
    from audiolab_tpu_torch.kernels.resample import resample

    x = torch.randn(2, 44100 * 2 + 17, generator=torch.Generator().manual_seed(1))
    assert torch.equal(resample(x, 44100, 16000), dsp.resample(x, 44100, 16000))
    p, q = plan_chunks(x.shape[-1], 20000, 1500), dsp.plan(x.shape[-1], 20000, 1500)
    assert torch.equal(extract_chunks(x, p), dsp.chunks(x, q))
    parts = torch.randn(p.count, 2, 20000)
    assert torch.allclose(stitch_chunks(parts, p), dsp.stitch(parts, q), atol=1e-6)


def test_separator_blend_and_debleed_match_the_port():
    from audiolab_tpu_torch.pipelines.separate import blend_tracks, debleed

    g = torch.Generator().manual_seed(2)
    a, b = torch.randn(2, 1000, generator=g), torch.randn(2, 1000, generator=g)
    v = REF.blend([a, b], [8.6, 8.4])
    assert torch.allclose(blend_tracks([a, b], [8.6, 8.4]), v, atol=1e-6)
    assert torch.allclose(debleed(v, b), REF.debleed(v, b), atol=1e-5)


def test_train_step_against_the_reference(tree):
    """The tiny training cell on the CPU: the port's first steps against the
    reference's, by the cell's own numbers."""
    import tiny

    out = tiny.result(tiny.run_cpu(tree, "tiny.train"))
    assert out["correct"] is True
    for name, c in out["checks"].items():
        assert c["value"] < 1e-3, name
