"""The port's ACE-Step base model against the JAX package on the CPU: APG
guidance (with and without per-channel reduction), the flow-matching solve
for each scheduler with repaint, ``z_init``/``t_start`` and the checkpoint
sampler's knobs (shifted sigmas, omega, the guidance interval and its
decay), Vocos, and ``ACEStepPipeline``'s five tasks end to end, at the JAX
package's demo widths (``random_acestep``) on the same filled weights.

Draws: :class:`JaxDraws` gives the port the normals the JAX keys give
(``jax.random.normal(PRNGKey(seed))`` for a start, one ``split`` a draw for
the per-step noise).  Tolerances: 1e-5 of max|y| for single calls (fp32
sums in another order), 1e-4 of max|y| for a solve and for audio (steps and
the decoders compound fp32 differences).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import acestep as JA
from audiolab_tpu.models import codecs as JC
from audiolab_tpu.pipelines import acestep as JP
from audiolab_tpu.utils.convert import convert_vocos
from audiolab_tpu_torch.models import acestep as TA
from audiolab_tpu_torch.kernels import stft as TS
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.pipelines import acestep as TP
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.test_torch_port_music import close
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(18)


class JaxDraws:
    """``models/acestep.py::Draws`` with the JAX pipeline's keys."""

    def normal(self, seed, shape):
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)))

    def steps(self, seed, steps, per_step, shape):
        rng, out = jax.random.PRNGKey(seed), []
        for _ in range(steps * per_step):
            rng, k = jax.random.split(rng)
            out.append(np.asarray(jax.random.normal(k, shape)))
        return torch.from_numpy(np.stack(out).reshape(steps, per_step, *shape))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX ACEStepPipeline with jitted modules, port pipeline on the CPU)
    at random_acestep's widths on the same filled weights."""
    jref = JP.random_acestep()          # for its configurations only
    cfg, vcfg = jref.cfg, jref.vocos.cfg
    model = JA.ACEStepModel(cfg)
    tpl = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.dcae.hop * 4, cfg.dcae.n_mels)),
        jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)),
        method=JA.ACEStepModel.full_init))["params"]
    p = tiny.filled(tpl, 20)
    voc = JC.Vocos(vcfg)
    vtpl = jax.eval_shape(lambda: voc.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 8, cfg.dcae.n_mels))))["params"]
    vp = tiny.filled(vtpl, 21)
    jp = JP.ACEStepPipeline(cfg, p, vcfg, vp, pcfg=JP.ACEStepPipelineConfig(steps=4))
    jp.model, jp.vocos = tiny.Jitted(jp.model), tiny.Jitted(jp.vocos)

    tcfg = TA.ACEStepConfig(
        sr=cfg.sr, mel_hop=cfg.mel_hop, dcae=TA.DCAEConfig(**vars(cfg.dcae)),
        dit=TP.DiTConfig(**vars(cfg.dit)), text_dim=cfg.text_dim,
        text_layers=cfg.text_layers, lyric_vocab=cfg.lyric_vocab)
    tm = tiny._load(TA.ACEStepModel(tcfg), W.acestep_from_jax(p))
    tv = tiny._load(TC.Vocos(TC.VocosConfig(**vars(vcfg)), in_dim=cfg.dcae.n_mels),
                    W.vocos_from_jax(vp))
    tp = TP.ACEStepPipeline(tm, tv, pcfg=TP.ACEStepPipelineConfig(steps=4), device="cpu",
                            draws=JaxDraws())
    return jp, tp, vtpl, vp


# ------------------------------------------------------------------ APG


@pytest.mark.parametrize("channels", [None, 4])
def test_apg_matches_jax(channels):
    """Two chained calls (the momentum carried), with and without the
    per-channel reduction; one call's delta clipped at the norm threshold."""
    cond, uncond = (RNG.standard_normal((2, 6, 8)).astype(np.float32) for _ in range(2))
    mj, mt = jnp.zeros((2, 6, 8)), torch.zeros(2, 6, 8)
    for scale in (7.5, 3.0):
        gj, mj = JA.apg(jnp.asarray(cond), jnp.asarray(uncond), scale, mj, channels=channels)
        gt, mt = TA.apg(_t(cond), _t(uncond), scale, mt, channels=channels)
        close(gt, gj, 1e-5, "guided")
        close(mt, mj, 1e-5, "momentum")
        cond = cond * 0.5


def test_acestep_sigmas_match_jax():
    np.testing.assert_allclose(TA.acestep_sigmas(60, 3.0), np.asarray(JA.acestep_sigmas(60, 3.0)),
                               rtol=1e-6, atol=0)


# ------------------------------------------------------------------ the solve


SOLVES = {
    "euler": dict(scheduler="euler"),
    "heun": dict(scheduler="heun", use_apg=False),
    "pingpong": dict(scheduler="pingpong"),
    "euler_repaint": dict(scheduler="euler", repaint=True),
    "pingpong_repaint": dict(scheduler="pingpong", repaint=True),
    "heun_z_init": dict(scheduler="heun", z_init=True, t_start=0.6),
    "checkpoint_knobs": dict(scheduler="euler", sigmas=True, timestep_scale=0.5,
                             omega_scale=10.0, guidance_interval=0.5,
                             guidance_interval_decay=1.0, apg_channels=2),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_fm_sample_matches_jax(case):
    """Four steps (six with the checkpoint knobs) of the doubled-batch solve
    on the pipeline's model under JAX's draws, 1e-4 of max|z|.  The knobs'
    timestep scale is 0.5, not the checkpoint DiT's 1000: this DiT embeds
    t * 1000 itself, and at t up to 1000 its sinusoids' arguments reach 1e6,
    where an fp32 ulp of a frequency moves a phase by 0.06."""
    jp, tp, _, _ = pair()
    kw = dict(SOLVES[case])
    repaint = kw.pop("repaint", False)
    steps = 6 if kw.pop("sigmas", False) else 4
    if steps == 6:
        kw["sigmas"] = JA.acestep_sigmas(steps, 3.0)
    ctx2 = RNG.standard_normal((2, 7, 32)).astype(np.float32)
    t_lat, shape = 12, (1, 12, 4)
    if kw.pop("z_init", False):
        kw["z_init"] = RNG.standard_normal(shape).astype(np.float32)
    if repaint:
        mask = np.zeros((1, t_lat, 1), np.float32)
        mask[:, 3:8] = 1.0
        kw.update(repaint_mask=mask, z_ref=RNG.standard_normal(shape).astype(np.float32))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = JA.fm_sample(jp.model, jp.params, jnp.asarray(ctx2), t_lat, steps=steps,
                        guidance_scale=5.0, rng=jax.random.PRNGKey(7), **jkw)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) and k != "sigmas" else v)
           for k, v in kw.items()}
    got = TA.fm_sample(tp.model, _t(ctx2), t_lat, steps=steps, guidance_scale=5.0, seed=7,
                       draws=JaxDraws(), **tkw)
    close(got, want, 1e-4)


def test_velocity_hidden_matches_jax():
    jp, tp, _, _ = pair()
    z = RNG.standard_normal((2, 9, 4)).astype(np.float32)
    ctx = RNG.standard_normal((2, 5, 32)).astype(np.float32)
    t = np.array([0.1, 0.8], np.float32)
    vj, hj = jp.model.apply({"params": jp.params}, *map(jnp.asarray, (z, t, ctx)), depth=0,
                            method=JA.ACEStepModel.velocity_hidden)
    with torch.no_grad():
        vt, ht = tp.model.velocity_hidden(_t(z), _t(t), _t(ctx), 0)
    close(vt, vj, 1e-5, "velocity")
    close(ht, hj, 1e-5, "hidden")


# ------------------------------------------------------------------ Vocos


def test_vocos_matches_jax():
    """The ConvNeXt trunk, the clipped magnitude and the iDFT-matmul iSTFT
    with its n_fft // 2 crop, 1e-5 of max|y|; ``convert_vocos`` maps the
    port's state_dict back."""
    jp, tp, vtpl, vp = pair()
    mel = RNG.standard_normal((1, 10, 32)).astype(np.float32)
    want = jp.vocos.apply({"params": vp}, jnp.asarray(mel))
    with torch.no_grad():
        got = tp.vocos(_t(mel))
    assert got.shape == (1, 9 * 256)       # (t - 1) hop after the n_fft // 2 crops
    close(got, want, 1e-5)
    sd = {k: v.numpy() for k, v in tp.vocos.state_dict().items()}
    tiny.assert_tree_equal(jax.tree_util.tree_map(np.asarray, convert_vocos(sd, vtpl)),
                           jax.tree_util.tree_map(np.asarray, vp))


def test_istft_matches_jax():
    re, im = (RNG.standard_normal((2, 7, 33)).astype(np.float32) for _ in range(2))
    """Vocos's iSTFT (the port's kernels/stft.py::istft, center-cropped)
    against the JAX package's iDFT matmul, nonzero DC and Nyquist imaginary
    parts included."""
    close(TS.istft(_t(re), _t(im), 64, 16, center=True),
          JC.istft(jnp.asarray(re), jnp.asarray(im), 64, 16), 1e-5)


# ------------------------------------------------------------------ the pipeline


# a tone over seeded noise: every mel band well above fp32 rounding (a bare
# tone leaves bands near the log's 1e-5 floor, where either package's fp32
# DFT moves the log mel by 2e-3)
CLIP = (0.3 * np.sin(2 * np.pi * 220 * np.arange(16000) / 8000)
        + 0.05 * np.random.default_rng(1).standard_normal(16000)).astype(np.float32)
TASKS = {
    "generate": ("generate", ("lofi beat",), dict(lyrics="[verse] la la", duration=2.0,
                                                  seed=3)),
    "generate_overrides": ("generate", ("lofi beat",), dict(duration=1.5, seed=4, infer_step=3,
                                                            guidance_scale=4.0,
                                                            scheduler_type="pingpong")),
    "retake": ("retake", (CLIP, "jazz"), dict(lyrics="[chorus] oh", variance=0.4, seed=5)),
    "repaint": ("repaint", (CLIP, "jazz", 0.5, 1.5), dict(seed=6)),
    "edit": ("edit", (CLIP, "rock"), dict(strength=0.7, seed=7)),
    "extend": ("extend", (CLIP, "rock"), dict(left_s=0.5, right_s=1.0, seed=8)),
}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_pipeline_task_matches_jax(task):
    """Each task end to end through the DCAE, the solve, the DCAE decoder and
    Vocos, under JAX's draws, 1e-4 of max|y|."""
    jp, tp, _, _ = pair()
    method, args, kw = TASKS[task]
    want, sr = getattr(jp, method)(*args, **kw)
    got, sr2 = getattr(tp, method)(*args, **kw)
    assert sr == sr2 == 8000
    close(got, np.asarray(want), 1e-4)


def test_random_acestep_serves_every_task():
    """The demo backend (fast_init weights) answers each task with finite
    audio of the expected length."""
    pipe = TP.random_acestep(device="cpu")
    pipe.pcfg.steps = 2
    y, sr = pipe.generate("x", duration=1.0)
    assert sr == 8000 and np.isfinite(y).all()
    assert len(y) == (pipe._frames(1.0) * pipe.cfg.dcae.hop - 1) * pipe.cfg.mel_hop
    for method, args, kw in (("retake", (CLIP, "x"), {}), ("repaint", (CLIP, "x", 0.2, 0.8), {}),
                             ("edit", (CLIP, "x"), {}), ("extend", (CLIP, "x"), {"right_s": 0.5})):
        out, _ = getattr(pipe, method)(*args, **kw)
        assert np.isfinite(out).all() and out.ndim == 1, method


@pytest.mark.parametrize("text", ["[verse] hello world\n[chorus] la la", "[EN] 你好 こんにちは 안녕 ok",
                                  "no tags at all", "[bridge][inst]", ""])
def test_lyric_tokenizer_and_language_segments_match_jax(text):
    np.testing.assert_array_equal(TA.tokenize_lyrics(text, 64), JA.tokenize_lyrics(text, 64))
    assert TA.segment_languages(text) == JA.segment_languages(text)
