"""Parity of the port's Dia (audiolab_tpu_torch/models/dia.py) and its TTS
engine with the JAX package's on the CPU, in fp32, at a test width
(tests/torch_port_tiny.py ``DIA``: decoder GQA of 4 query heads over 2 with
head dim 12, cross-attention head dim 10, 3 codebooks of 20), with seeded
weights carried by ``dia_from_jax`` and mapped back by ``convert_dia``;
``tests/torch_ref_models.py::DiaTorch`` (nari-labs names) is a second
witness.

Tolerances: logits and hidden states within 1e-5 of their max (K2's plain
version normalises after the product where the JAX reference normalises
before it); waveforms within 1e-4 of the peak; codes identical under the
Gumbel draws that the JAX keys give."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import codecs as JC
from audiolab_tpu.models import dia as JD
from audiolab_tpu.pipelines.tts import DiaTTSEngine as JDiaTTSEngine
from audiolab_tpu.utils.convert import convert_dia
from audiolab_tpu_torch.models import dia as TD
from audiolab_tpu_torch.pipelines.tts import DiaTTSEngine
from tests import torch_port_tiny as tiny

TEXT = "[S1] hi there [S2] yo"
FPW = 2                                   # frames a word: 5 words -> 10 frames
FRAMES = 10


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


def _text(b=2):
    ids = np.zeros((b, 9), np.int32)
    ids[0] = JD.tokenize_dialogue("[S1] hey!")
    ids[1, :6] = JD.tokenize_dialogue("[S2] a")
    return ids


def test_encoder_matches_jax():
    _cfg, jm, p, tm = tiny.dia()
    ids = _text()
    ref = jax.jit(lambda p, ids, m: jm.apply({"params": p}, ids, m,
                                             method=JD.DiaModel.encode_text))(
        p, jnp.asarray(ids), jnp.asarray(ids != 0))
    with torch.no_grad():
        out = tm.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(ids != 0))
    _close(out, ref)


def test_prefill_and_steps_match_jax():
    """The prefill over a 5-frame prompt (K2's plain version, scale 1.0) and
    three steps through the static caches, logits against JAX's same calls."""
    cfg, jm, p, tm = tiny.dia()
    rng = np.random.default_rng(0)
    ids = _text()
    mask = ids != 0
    codes = rng.integers(0, cfg.codebook_size, (2, cfg.n_codebooks, 5))
    steps = rng.integers(0, cfg.codebook_size, (3, 2, cfg.n_codebooks))

    @jax.jit
    def jprefill(p, ids, mask, codes):
        enc = jm.apply({"params": p}, ids, mask, method=JD.DiaModel.encode_text)
        return jm.apply({"params": p}, codes, enc, mask, method=JD.DiaModel.prefill)

    jstep = jax.jit(lambda p, c, pos, caches, cross, mask: jm.apply(
        {"params": p}, c, pos, caches, cross, mask, method=JD.DiaModel.step))
    ref, caches, cross = jprefill(p, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(codes))
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        enc = tm.encode_text(torch.from_numpy(ids).long(), tmask)
        out, tcaches, tcross = tm.prefill(torch.from_numpy(codes), enc, tmask)
        _close(out, ref)
        for i, ct in enumerate(steps):
            ref, caches = jstep(p, jnp.asarray(ct), jnp.asarray([5 + i]), caches, cross,
                                jnp.asarray(mask))
            out = tm.step(torch.from_numpy(ct), torch.tensor([5 + i]), tcaches, tcross, tmask)
            _close(out, ref)


def test_teacher_forced_forward_matches_jax_and_the_torch_replica():
    """DiaModel's forward against JAX's; and the nari-labs replica's weights
    loaded by name into the port give the replica's logits."""
    from tests.torch_ref_models import DiaTorch

    cfg, jm, p, tm = tiny.dia()
    ids = _text()
    codes = np.random.default_rng(1).integers(0, cfg.codebook_size, (2, cfg.n_codebooks, 7))
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        p, jnp.asarray(ids), jnp.asarray(codes), jnp.asarray(ids != 0))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long(), torch.from_numpy(codes),
                 torch.from_numpy(ids != 0))
    _close(out, ref)

    torch.manual_seed(3)
    rep = DiaTorch(dim_enc=16, dim_dec=32, n_enc=1, n_dec=2, heads=4, kv_heads=2, hd_dec=12,
                   xhd=10, enc_heads=2, channels=3, vocab=20).eval()
    port = TD.DiaModel(TD.DiaConfig(**tiny.DIA))
    port.load_state_dict(rep.state_dict(), strict=True)
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(ids).long(), torch.from_numpy(codes)),
               rep(torch.from_numpy(ids).long(), torch.from_numpy(codes)))


def test_state_dict_maps_back_through_convert_dia():
    cfg, _jm, p, tm = tiny.dia()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_dia(sd, p, cfg, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("prompt", [False, True])
def test_generate_codes_match_jax(prompt):
    """``generate`` (CFG double batch, delay pattern, top-k 64 at temperature
    1.2) with and without a 4-frame audio prompt: the port's codes equal the
    JAX scan's under the JAX keys' draws."""
    cfg, jm, p, tm = tiny.dia()
    ids = JD.tokenize_dialogue(TEXT)[None]
    ap = (np.random.default_rng(2).integers(0, 17, (1, cfg.n_codebooks, 4))
          if prompt else None)
    ref = JD.generate(jm, p, jnp.asarray(ids), max_frames=FRAMES,
                      audio_prompt=None if ap is None else jnp.asarray(ap),
                      rng=jax.random.PRNGKey(5))
    draws = tiny.jax_dia_draws(5, FRAMES + cfg.n_codebooks, 1, cfg.n_codebooks,
                               cfg.codebook_size)
    out = TD.generate(tm, ids, max_frames=FRAMES, audio_prompt=ap,
                      draws=torch.from_numpy(draws), device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _engines(dia_kw: dict, dac_kw: dict, seed: int = 9):
    """(config, JAX engine, port engine) on copies of the cached models."""
    cfg, jm, p, tm = tiny.dia(seed=seed, **dia_kw)
    p, tm = jax.tree_util.tree_map(np.array, p), copy.deepcopy(tm)
    dcfg, dp, tdac = tiny.dac(**dac_kw)
    jeng = JDiaTTSEngine(jm, p, JC.DACDecoder(dcfg), dp, sr=44100, frames_per_word=FPW)
    teng = DiaTTSEngine(tm, tdac, sr=44100, frames_per_word=FPW, device="cpu")
    return cfg, jeng, teng


def test_engine_audio_matches_jax_where_its_clip_is_in_range():
    """Dia codebooks of 20, a DAC of 17 rows: JAX's clip to 16 stays in the
    table.  The port's engine is the JAX DAC on the generated codes with the
    upstream map (ids past the table -> 0), and on codes inside JAX's clip
    range its audio is the JAX engine's."""
    cfg, jeng, teng = _engines({}, dict(codebook_size=17))
    draws = tiny.jax_dia_draws(1, FRAMES + cfg.n_codebooks, 1, cfg.n_codebooks,
                               cfg.codebook_size)
    codes = np.asarray(JD.generate(jeng.model, jeng.params,
                                   jnp.asarray(JD.tokenize_dialogue(TEXT))[None],
                                   max_frames=FRAMES, rng=jax.random.PRNGKey(1)))
    audio, sr = teng.generate(TEXT, seed=1, draws=torch.from_numpy(draws))
    mapped = np.where(codes < 17, codes, 0)
    dac = jax.jit(lambda p, c: jeng.dac.apply({"params": p}, c))
    ref = np.asarray(dac(jeng.dac_params, jnp.asarray(mapped)))[0]
    assert sr == 44100
    _close(audio, ref, 1e-4)

    inside = np.random.default_rng(4).integers(0, cfg.codebook_size - 3, (1, 3, FRAMES))
    ref = dac(jeng.dac_params, jnp.clip(jnp.asarray(inside), 0, cfg.codebook_size - 4))
    _close(teng.codes_to_audio(torch.from_numpy(inside)), ref, 1e-4)


def test_code_range_fault_nan_in_jax_finite_in_the_port():
    """Dia's 1028-way codebooks over a 1024-row DAC, with head weights that
    make the four ids past the DAC (EOS, BOS, MASK and 1024) likely, as a
    trained model's EOS is: JAX's clip to 1024 reads past the table and its
    audio has NaNs; the port maps those ids to 0 and its audio is finite."""
    cfg, jeng, teng = _engines(dict(codebook_size=1028), dict(codebook_size=1024), seed=10)
    for q in range(cfg.n_codebooks):
        k = np.array(jeng.params["decoder"][f"head_{q}"]["kernel"])
        k[:, 1024:] *= 8.0
        jeng.params["decoder"][f"head_{q}"]["kernel"] = k
    with torch.no_grad():
        teng.model.decoder.logits_dense.weight[:, :, 1024:] *= 8.0
    y_jax, _ = jeng.generate(TEXT, seed=0)
    draws = tiny.jax_dia_draws(0, FRAMES + cfg.n_codebooks, 1, cfg.n_codebooks,
                               cfg.codebook_size)
    codes = TD.generate(teng.model, JD.tokenize_dialogue(TEXT)[None], max_frames=FRAMES,
                        draws=torch.from_numpy(draws), device="cpu")
    y, _ = teng.generate(TEXT, seed=0, draws=torch.from_numpy(draws))
    assert int((codes >= 1024).sum()) > 0
    assert int(np.isnan(y_jax).sum()) > 0
    assert y.shape == y_jax.shape and np.isfinite(y).all()
