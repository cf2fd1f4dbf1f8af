"""The port's YuE (audiolab_tpu_torch/models/yue.py) against the JAX
package's on the CPU: the vocabulary's layout, stage 1's codes under the
JAX keys' draws (left pads live, both unconditional modes), stage 2's
codes, ``generate_music`` on each decode path (xcodec, Vocos, SEANet) and
the serve protocol.

Weights: the JAX demo pipelines of ``random_yue`` (flax inits), carried
into the port by ``utils/weights.py::yue_from_jax``; the xcodec decoder's
tree is filled with seeded numbers.  Draws: segment i's stage-1 draws are
the Gumbel draws the JAX scan takes from ``PRNGKey(seed + i)`` (one split a
step, ``categorical`` on a 1-D row), made by
``tests/torch_port_tiny.py::jax_draws`` and handed to the port.

Tolerances: codes identical; fp32 audio to 1e-5 of its max|y| (the
decoders' sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import codecs as JC
from audiolab_tpu.models import yue as JY
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.models import lm as TL
from audiolab_tpu_torch.models import yue as TY
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
XC = dict(n_q=4, codebook_size=32, dim=12, acoustic_dim=4, decoder_dim=16, rates=(2, 5))


def jax_yue_draws(seed: int, shape: tuple) -> np.ndarray:
    """Stage 1's draws for one segment, (2 * frames, 1, vocab)."""
    return tiny.jax_draws(seed, shape[0], 1, shape[2])


def port_config(cfg: JY.YuEConfig) -> TY.YuEConfig:
    return TY.YuEConfig(vocab=TY.YuEVocab(**vars(cfg.vocab)),
                        stage1=TL.LMConfig(**vars(cfg.stage1)),
                        stage2=TL.LMConfig(**vars(cfg.stage2)),
                        stage2_block=cfg.stage2_block, n_q=cfg.n_q)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


@functools.lru_cache(maxsize=None)
def xcodec_tree(seed: int = 72):
    cfg = JC.XCodecConfig(**XC)
    tpl = jax.eval_shape(lambda: JC.XCodecDecoder(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.n_q, 4), jnp.int32)))["params"]
    return cfg, tiny.filled(tpl, seed)


def pipelines(path: str):
    """(JAX pipeline, port pipeline on the CPU) on the same weights for the
    decode path "seanet", "vocos" or "xcodec"."""
    jp = JY.random_yue(with_vocos=path == "vocos")
    xcodec = None
    if path == "xcodec":
        xcfg, xp = xcodec_tree()
        jp.xcodec, jp.xcodec_params = JC.XCodecDecoder(xcfg), xp
        xcodec = _load(TC.XCodecDecoder(TC.XCodecConfig(**XC)), W.xcodec_from_jax(xp))
    cfg = port_config(jp.cfg)
    sds = W.yue_from_jax(jp.s1_params, jp.s2_params, jp.codec_params, jp.vocos_params)
    c = jp.codec.cfg
    codec = _load(TC.SoundStreamCodec(TC.CodecConfig(
        sr=c.sr, seanet=TC.SEANetConfig(**vars(c.seanet)), n_q=c.n_q,
        codebook_size=c.codebook_size)), sds["codec"])
    vocos = None
    if jp.vocos is not None:
        vocos = _load(TC.Vocos(TC.VocosConfig(**vars(jp.vocos.cfg)), in_dim=c.seanet.dim),
                      sds["vocos"])
    tp = TY.YuEPipeline(cfg, _load(TL.TransformerLM(cfg.stage1), sds["s1"]),
                        _load(TL.TransformerLM(cfg.stage2), sds["s2"]), codec, vocos=vocos,
                        pcfg=TY.YuEPipelineConfig(**vars(jp.pcfg)), xcodec=xcodec,
                        device="cpu", draws=jax_yue_draws)
    return jp, tp


@pytest.fixture(scope="module")
def seanet_pair():
    return pipelines("seanet")


def test_vocab_layout_matches_jax():
    """The published mm-v0.2 layout and the demo's shrunken one."""
    for kw in ({}, dict(codebook_size=32, text_size=64, pre_xcodec_codebooks=2, n_q_total=8,
                        post_xcodec_ids=16)):
        j, t = JY.YuEVocab(**kw), TY.YuEVocab(**kw)
        for name in JY._SPECIAL_ORDER:
            assert t.special(name) == j.special(name), name
        assert (t.special_base, t.xcodec_base, t.vocal_base, t.inst_base, t.size) == (
            j.special_base, j.xcodec_base, j.vocal_base, j.inst_base, j.size)
        assert [t.codebook_base(k) for k in range(t.n_q_total)] == [
            j.codebook_base(k) for k in range(j.n_q_total)]
    v = TY.YuEVocab()
    assert (v.special("soa"), v.special("eoa"), v.special("xcodec"), v.special("stage2")) == (
        32001, 32002, 32016, 32017)
    assert (v.xcodec_base, v.codebook_base(1), v.codebook_base(8), v.size) == (
        45334, 46358, 53526, 83734)
    cfg, jcfg = TY.YuEConfig(), JY.YuEConfig()
    assert vars(cfg.stage1) == vars(jcfg.stage1) and vars(cfg.stage2) == vars(jcfg.stage2)
    np.testing.assert_array_equal(TY.encode_text("héllo", text_size=64),
                                  JY.encode_text("héllo", text_size=64))


def test_block_token_range_processor_matches_jax():
    logits = np.random.default_rng(9).standard_normal((2, 40)).astype(np.float32)
    want = np.asarray(JY.block_token_range_processor(7, 19)(jnp.asarray(logits), 0))
    got = TY.block_token_range_processor(7, 19)(torch.from_numpy(logits), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want[:, :7]).all() and np.isfinite(want[:, 7:19]).all()


STAGE1 = {
    "tail": dict(mode="tail", kw=dict(cfg_scale=1.5, top_p=0.93, repetition_penalty=1.2)),
    "lyrics_stripped_top_k": dict(mode="lyrics_stripped", kw=dict(
        cfg_scale=1.2, top_k=5, top_p=0.8, temperature=0.7, repetition_penalty=1.3)),
}


@pytest.mark.parametrize("case", sorted(STAGE1))
def test_stage1_codes_match_jax(seanet_pair, case):
    """Identical codes under the JAX keys' draws: the prompt left-padded to
    128 with <EOA>, the pads masked (valid_from), the tail-mode
    unconditional row one token long; and without the key mask the codes
    change in both packages."""
    jp, tp = seanet_pair
    spec = STAGE1[case]
    jp.pcfg.uncond_mode = tp.pcfg.uncond_mode = spec["mode"]
    try:
        prompt, vf = jp._prompt("jazz", "la la la")
        t_prompt, t_vf = tp._prompt("jazz", "la la la")
    finally:
        jp.pcfg.uncond_mode = tp.pcfg.uncond_mode = "tail"
    np.testing.assert_array_equal(t_prompt, np.asarray(prompt))
    np.testing.assert_array_equal(t_vf, vf)
    if spec["mode"] == "tail":
        assert vf[1] == prompt.shape[1] - 1 and prompt[1, -1] == prompt[0, -1]
    frames, seed = 10, 3
    kw = spec["kw"]
    codes = {}
    for label, valid in (("masked", vf), ("unmasked", None)):
        want = np.asarray(JY.stage1_generate(jp.s1, jp.s1_params, prompt, frames, jp.cfg.vocab,
                                             valid_from=valid, rng=jax.random.PRNGKey(seed),
                                             **kw))
        got = TY.stage1_generate(tp.s1, t_prompt, frames, tp.cfg.vocab, valid_from=valid,
                                 draws=jax_yue_draws(seed, (2 * frames, 1, tp.cfg.vocab.size)),
                                 device="cpu", **kw)
        assert got.shape == (2, frames)
        np.testing.assert_array_equal(got.numpy(), want)
        codes[label] = want
    assert codes["masked"].min() >= 0 and codes["masked"].max() < tp.cfg.vocab.codebook_size
    assert not np.array_equal(codes["masked"], codes["unmasked"])


def test_prompt_with_an_audio_reference_matches_jax(seanet_pair):
    """The reference codes' rows ([start_of_reference] <SOA> <xcodec> cb0
    <EOA> [end_of_reference]) in both unconditional modes, from numpy or a
    tensor."""
    jp, tp = seanet_pair
    ref = np.random.default_rng(8).integers(0, 32, (2, 7))
    for mode in ("tail", "lyrics_stripped"):
        jp.pcfg.uncond_mode = tp.pcfg.uncond_mode = mode
        try:
            want, want_vf = jp._prompt("rock", "oh", audio_codes=ref, full_lyrics="oh\nah")
            for codes in (ref, torch.from_numpy(ref)):
                got, vf = tp._prompt("rock", "oh", audio_codes=codes, full_lyrics="oh\nah")
                np.testing.assert_array_equal(got, np.asarray(want))
                np.testing.assert_array_equal(vf, want_vf)
        finally:
            jp.pcfg.uncond_mode = tp.pcfg.uncond_mode = "tail"


def test_stage1_seeded_draws_repeat(seanet_pair):
    """Without draws, the port's own Gumbel draws from ``seed``: the same
    seed gives the same codes, in the codebook range."""
    _, tp = seanet_pair
    prompt, vf = tp._prompt("rock", "oh oh")
    a, b = (TY.stage1_generate(tp.s1, prompt, 6, tp.cfg.vocab, valid_from=vf, seed=5,
                               device="cpu") for _ in range(2))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 32


def test_stage2_codes_match_jax(seanet_pair):
    """20 frames of two tracks in blocks of 8 (6 blocks, bucketed to 8):
    codebook 0 passed through, codebooks 1..3 greedy, identical."""
    jp, tp = seanet_pair
    codes0 = np.random.default_rng(0).integers(0, 32, (2, 20)).astype(np.int32)
    want = np.asarray(JY.stage2_generate(jp.s2, jp.s2_params, jnp.asarray(codes0), jp.cfg.vocab,
                                         n_q=jp.cfg.n_q, block=jp.cfg.stage2_block))
    stats: dict = {}
    got = TY.stage2_generate(tp.s2, codes0, tp.cfg.vocab, n_q=tp.cfg.n_q,
                             block=tp.cfg.stage2_block, stats=stats, device="cpu")
    assert got.shape == (2, 4, 20) and stats["blocks"] == 6 and stats["blocks_bucket"] == 8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 0].numpy(), codes0)


@pytest.mark.parametrize("path", ["seanet", "vocos", "xcodec"])
def test_generate_music_matches_jax(path):
    """Two lyric segments through both stages and the decode path: the
    vocals, accompaniment and mix within 1e-5 of their max|y|, the rate
    the path's, the mix at most 0.99."""
    jp, tp = pipelines(path)
    lyrics = "la la la\n\nsecond verse"
    want = jp.generate_music("pop upbeat", lyrics, n_segments=2, seed=1)
    stats: dict = {}
    got = tp.generate_music("pop upbeat", lyrics, n_segments=2, seed=1, stats=stats)
    assert got["sr"] == want["sr"] == {"seanet": 16000, "vocos": 32000, "xcodec": 20000}[path]
    assert len(stats["stage1"]) == 2 and stats["codes"].shape == (2, 4, 32)
    for k in ("vocal", "inst", "mix"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        scale = float(np.abs(want[k]).max())
        assert scale > 0 and np.abs(got[k] - want[k]).max() <= TOL * scale, k
    assert np.abs(got["mix"]).max() <= 0.99 + 1e-6


def test_serve_protocol_matches_jax(seanet_pair):
    jp, tp = seanet_pair
    want, sr_j = jp.generate("rock", lyrics="test", n_segments=1, seed=2)
    got, sr = tp.generate("rock", lyrics="test", n_segments=1, seed=2)
    assert sr == sr_j == 16000 and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("with_vocos", [False, True])
def test_random_yue_on_the_cpu(with_vocos):
    """The port's demo pipeline (fast_init weights) end to end."""
    pipe = TY.random_yue(with_vocos=with_vocos, device="cpu")
    out = pipe.generate_music("pop", "la la\n\nna na", n_segments=2, seconds_per_segment=0.2)
    # 20 frames: the SEANet decoder's 8 samples each; Vocos' centred iSTFT
    # (hop 16) gives 19 hops
    assert out["sr"] == (32000 if with_vocos else 16000)
    assert out["mix"].shape == ((19 * 16,) if with_vocos else (20 * 8,))
    assert np.isfinite(out["mix"]).all()
    assert np.abs(out["mix"]).max() <= 0.99 + 1e-6
