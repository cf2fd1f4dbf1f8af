"""Parity of the port's remaining separation entry points with the JAX
package's, on the CPU, fp32: the multistem split (stems sum to the input),
the DSP transforms of the per-stem chain and their policy tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu_torch.pipelines import separate as TSep

SR = 44100


def _audio(n=SR // 2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 2 * t))
    x = x + 0.3 * (rng.uniform(size=n) < 0.002) * rng.standard_normal(n)   # clicks
    x = x + 0.02 * rng.standard_normal(n)
    return np.stack([x, 0.7 * x + 0.01 * rng.standard_normal(n)]).astype(np.float32)


def _six_stems(xp, tanh, batch):
    """A fixed N-stem "model" that does not sum to its input."""
    stems = {s: g * tanh(k * batch) for s, g, k in zip(
        TSep.MULTISTEM_6[:-1], (0.3, 0.2, 0.15, 0.1, 0.1), (1.0, 2.0, 0.5, 3.0, 1.5))}
    stems["instrumental"] = batch - stems["vocals"]
    return stems


def test_separate_multistem_matches_jax():
    """Six stems over four chunks in two groups of two: each stem to 1e-6,
    "instrumental" dropped, and the stems summing to the input."""
    x = _audio()
    kw = dict(sr=SR, chunk_seconds=0.15, overlap_seconds=0.03, device_batch=2)
    jm = JSep.EnsembleMember("six", lambda b: _six_stems(jnp, jnp.tanh, b))
    tm = TSep.EnsembleMember("six", lambda b: _six_stems(torch, torch.tanh, b))
    ref = JSep.StemSeparator([jm], **kw).separate_multistem(x, jm)
    out = TSep.StemSeparator([tm], device="cpu", **kw).separate_multistem(x, tm)
    assert TSep.MULTISTEM_6 == JSep.MULTISTEM_6 and set(out) == set(ref) == set(TSep.MULTISTEM_6)
    for stem in ref:
        np.testing.assert_allclose(out[stem], ref[stem], atol=1e-6, rtol=0)
    np.testing.assert_allclose(sum(out.values()), x, atol=1e-6)
    assert (TSep.DRUM_KIT, TSep.KARAOKE, TSep.WOODWINDS) == (
        JSep.DRUM_KIT, JSep.KARAOKE, JSep.WOODWINDS)


@pytest.mark.parametrize("name,kw", [
    ("spectral_gate_denoise", {}),
    ("spectral_gate_denoise", {"reduction_db": 8.0, "n_fft": 1024}),
    ("dereverb", {}),
    ("dereverb", {"strength": 0.3})])
def test_transform_matches_jax(name, kw):
    """To 1e-5 of the input's peak (fp32 STFT, gains, iSTFT)."""
    x = _audio(seed=1)
    ref = getattr(JSep, name)(x, SR, **kw)
    out = getattr(TSep, name)(x, SR, device="cpu", **kw)
    assert out.shape == ref.shape == x.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(x).max(), rtol=0)


def test_hpss_split_matches_jax():
    x = _audio(n=SR // 4, seed=2)
    ref = JSep.hpss_split(x, SR)
    out = TSep.hpss_split(x, SR, device="cpu")
    for stem in ("drums", "other"):
        np.testing.assert_allclose(out[stem], ref[stem], atol=1e-5 * np.abs(x).max(), rtol=0)


@pytest.mark.parametrize("setting", ["Nothing", "Main Vocals", "All Vocals", "All", "other"])
def test_should_apply_transform_matches_jax(setting):
    for stem in ("vocals", "bg_vocals", "BG_Vocals_2", "drums", "lead_vocals"):
        assert TSep.should_apply_transform(stem, setting) == JSep.should_apply_transform(
            stem, setting)


def test_policy_and_chain_transforms_match_jax():
    """apply_policy_transforms with the DSP defaults and one injected
    transform, and apply_transform_chain, each stem to 1e-5."""
    stems = {"vocals": _audio(n=SR // 4, seed=3), "bg_vocals": _audio(n=SR // 4, seed=4),
             "drums": _audio(n=SR // 4, seed=5)}
    policies = {"reverb": "Main Vocals", "echo": "All Vocals", "noise": "All"}
    inject = {"echo": lambda x, s: 0.5 * np.asarray(x)}
    ref = JSep.apply_policy_transforms(stems, SR, policies, inject)
    out = TSep.apply_policy_transforms(stems, SR, policies, inject, device="cpu")
    for stem in stems:
        np.testing.assert_allclose(out[stem], ref[stem], atol=1e-5, rtol=0)
    assert TSep.STEM_TRANSFORM_POLICY == JSep.STEM_TRANSFORM_POLICY
    ref = JSep.apply_transform_chain(stems, SR, enabled=["denoise"])
    out = TSep.apply_transform_chain(stems, SR, enabled=["denoise"], device="cpu")
    for stem in stems:
        np.testing.assert_allclose(np.asarray(out[stem]), np.asarray(ref[stem]), atol=1e-5)
