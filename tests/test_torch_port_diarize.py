"""The port's neural diarizer (models/diarize.py) against the JAX
package's, on the CPU, at a narrow width (hidden 16, embeddings 12, 32 mel
bands; the pipeline's chunking and thresholds as configured): the nets'
weights come from ``diarize_from_jax`` on a seeded flax tree.

Tolerances: activities within 1e-5 (fp32 convolutions and LSTM steps
summed in another order), embeddings within 1e-5, the PIT loss within 1e-6
relative; the turns of ``NeuralDiarizer.diarize`` identical (the regions'
edges come from activities held to 1e-5 against a threshold of 0.5, and
the agglomeration is the same host code)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import diarize as JD
from audiolab_tpu.pipelines import cloning as JCl
from audiolab_tpu_torch.models import diarize as TD
from audiolab_tpu_torch.pipelines import cloning as TCl
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(n_mels=32, hidden=16, emb_dim=12, chunk_s=2.0, chunk_hop_s=1.0, min_turn_s=0.1,
           cluster_threshold=0.03)
# the segmentation net's kernels are the filler's times 1.5: its activities
# then cross 0.5 with the input's bursts (the least |a - 0.5| on the test
# track's chunks is 3.8e-4, far above the 1e-5 the two packages differ by),
# and the track splits into three turns of two speakers
SEG_KERNEL_SCALE = 1.5


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX NeuralDiarizer, port NeuralDiarizer) on the same weights."""
    jc, tc = JD.DiarizeConfig(**CFG), TD.DiarizeConfig(**CFG)
    mel = jnp.zeros((1, 32, CFG["n_mels"]))
    seg_tpl = jax.eval_shape(lambda: JD.SegmentationNet(jc).init(jax.random.PRNGKey(0), mel))
    emb_tpl = jax.eval_shape(lambda: JD.SpeakerEmbedder(jc).init(jax.random.PRNGKey(0), mel))
    seg_p = jax.tree_util.tree_map_with_path(
        lambda path, a: a * SEG_KERNEL_SCALE if str(getattr(path[-1], "key", "")) == "kernel"
        else a, tiny.filled(seg_tpl["params"], 21))
    emb_p = tiny.filled(emb_tpl["params"], 22)
    seg_sd, emb_sd = W.diarize_from_jax(seg_p, emb_p)
    seg, emb = TD.SegmentationNet(tc), TD.SpeakerEmbedder(tc)
    seg.load_state_dict(seg_sd, strict=True)
    emb.load_state_dict(emb_sd, strict=True)
    return (JD.NeuralDiarizer(jc, seg_p, emb_p),
            TD.NeuralDiarizer(tc, seg, emb, device="cpu"))


def _speech(seconds, seed):
    """Alternating tone and noise bursts at 16 kHz, with silences."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    gate = (np.sin(2 * np.pi * 0.7 * t) > -0.3).astype(np.float64)
    voice = np.where(np.sin(2 * np.pi * 0.35 * t) > 0, 0.3 * np.sin(2 * np.pi * 180 * t),
                     0.15 * rng.standard_normal(n))
    return (gate * voice + 0.005 * rng.standard_normal(n)).astype(np.float32)


def test_nets_match_jax():
    jd, td = _pair()
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 50, CFG["n_mels"])).astype(np.float32)
    mask = (rng.random((2, 50)) > 0.4).astype(np.float32)
    ref_act = np.asarray(jd._activities(jd.seg_params, jnp.asarray(mel)))
    ref_emb = np.asarray(jd._embed(jd.emb_params, jnp.asarray(mel), jnp.asarray(mask)))
    with torch.no_grad():
        act = td.seg(torch.from_numpy(mel)).numpy()
        emb = td.emb(torch.from_numpy(mel), torch.from_numpy(mask)).numpy()
    assert act.shape == ref_act.shape == (2, 50, 3) and emb.shape == ref_emb.shape == (2, 12)
    np.testing.assert_allclose(act, ref_act, atol=1e-5, rtol=0)
    np.testing.assert_allclose(emb, ref_emb, atol=1e-5, rtol=0)


def test_pit_bce_loss_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.random((2, 30, 3)).astype(np.float32)
    target = (rng.random((2, 30, 3)) > 0.5).astype(np.float32)
    ref = float(JD.pit_bce_loss(jnp.asarray(pred), jnp.asarray(target)))
    out = float(TD.pit_bce_loss(torch.from_numpy(pred), torch.from_numpy(target)))
    assert out == pytest.approx(ref, rel=1e-6)


def test_diarize_matches_jax():
    """5.5 s at 16 kHz (5 chunks of 2 s, the last padded) and the same at
    8 kHz (host resample): the chunks' activities within 1e-5 and identical
    turns, through NeuralDiarizer.diarize and cloning.neural_diarize."""
    jd, td = _pair()
    x = _speech(5.5, 2)
    ref = jd.diarize(x, 16000)
    out = td.diarize(x, 16000)
    assert out == ref and len(ref) == 3 and len({s for *_, s in ref}) == 2
    assert TCl.neural_diarize(x, 16000, td) == JCl.neural_diarize(x, 16000, jd) == ref
    x8 = x[::2].copy()
    assert td.diarize(x8, 8000) == jd.diarize(x8, 8000)
    batch = np.stack([x[:32000], x[16000:48000]])
    act, _mel = td.activities(batch)
    ref_act = np.asarray(jd._activities(jd.seg_params, jd._mel(jnp.asarray(batch))))
    np.testing.assert_allclose(act, ref_act, atol=1e-5, rtol=0)


def test_checkpoint_back_ends_name_their_items():
    """Both checkpoint back ends are taken and held on the diarizer's device:
    PyanNet (its state_dict loaded strictly into a PyanNet of the given
    configuration; tests/test_torch_port_transcribe.py holds it against the
    JAX back end) and the wespeaker ResNet."""
    from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
    from audiolab_tpu_torch.models.wespeaker import WeSpeakerConfig, WeSpeakerResNet

    pcfg = PyanNetConfig(lstm_hidden=8, lstm_layers=1, linear_dim=8)
    sd = PyanNet(pcfg).state_dict()
    d = TD.NeuralDiarizer(pyannet_params=sd, pyannet_cfg=pcfg, device="cpu")
    assert isinstance(d.pyannet, PyanNet) and d.pyannet.classifier.weight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="size mismatch"):
        TD.NeuralDiarizer(pyannet_params=sd, device="cpu")
    ws = WeSpeakerResNet(WeSpeakerConfig(feat_dim=16, embed_dim=8, m_channels=4,
                                         num_blocks=(1, 1, 1, 1)))
    assert TD.NeuralDiarizer(wespeaker=ws, device="cpu").wespeaker is ws
    d = TD.NeuralDiarizer(TD.DiarizeConfig(**CFG), device="cpu")
    assert d.seg.conv1.weight.std() > 0 and d.emb.proj.bias.abs().max() == 0
    assert all(t1 > t0 for t0, t1, _ in d.diarize(np.zeros(4000, np.float32), 16000))
