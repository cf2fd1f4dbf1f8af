"""Parity of the port's BS-RoFormer and ensemble separator with the JAX
package's, on the CPU, in fp32 at a tiny configuration (dim 32, depth 2,
n_fft 256, 4 bands).  Weights come from a flax init (perturbed so no
parameter sits at its initial constant) and reach the port through
utils/weights.py; the JAX converter must map the port's state_dict back to
the same tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models.separation import roformer as JRo
from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu.utils.convert import convert_roformer
from audiolab_tpu_torch.models.separation import roformer as TRo
from audiolab_tpu_torch.pipelines import separate as TSep
from audiolab_tpu_torch.utils.weights import roformer_from_jax

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, freqs_per_bands=(16, 16, 32, 65),
            n_fft=256, hop=64, dtype="float32")
VARIANTS = {
    "bs_two_stems": dict(stems=("vocals", "other")),
    "bs_residual": dict(stems=("vocals",), residual_stem="other"),
    "mel_bands": dict(stems=("vocals", "other"), band_bins=JRo.mel_band_bins(8, 256, 44100)),
}


def _configs(variant):
    kw = dict(TINY, **VARIANTS[variant])
    return JRo.RoformerConfig(**kw), TRo.RoformerConfig(**kw)


def _params(cfg, seed, n=2560):
    model = JRo.BSRoformer(cfg)
    p = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, n)))["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), p)


def _port(tcfg, params):
    m = TRo.BSRoformer(tcfg)
    m.load_state_dict(roformer_from_jax(params, tcfg.stems), strict=True)
    return m.eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_roformer_stems_match_jax(variant):
    """Stems to 1e-5 (fp32 end to end through STFT, 2 axial pairs, iSTFT)."""
    jcfg, tcfg = _configs(variant)
    params = _params(jcfg, 0)
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 2, 2560))).astype(np.float32)
    ref = JRo.BSRoformer(jcfg).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = _port(tcfg, params)(torch.from_numpy(x))
    assert set(out) == set(ref)
    for stem in ref:
        np.testing.assert_allclose(out[stem].numpy(), np.asarray(ref[stem]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_roformer_weights_invert_converter(variant):
    """utils/weights.py inverts utils/convert.py exactly."""
    jcfg, tcfg = _configs(variant)
    params = _params(jcfg, 1)
    sd = {k: v.numpy() for k, v in roformer_from_jax(params, tcfg.stems).items()}
    back = convert_roformer(sd, params, stems=jcfg.stems)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_blend_and_debleed_match_jax():
    rng = np.random.default_rng(3)
    tracks = [rng.standard_normal((2, 500)).astype(np.float32) for _ in range(4)]
    w = [8.6, 8.4, 8.5, 7.2]
    for m in (2, 3, 4):   # even counts take the mean of the middle pair
        ref = np.asarray(JSep.blend_tracks([jnp.asarray(t) for t in tracks[:m]], w[:m]))
        out = TSep.blend_tracks([torch.from_numpy(t) for t in tracks[:m]], w[:m]).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
    a, b = tracks[0], 0.2 * tracks[0] + tracks[1]   # |cos| < 0.5: the guard lets it through
    for t, o in ((a, b), (b, a), (a, a)):
        ref = np.asarray(JSep.debleed(jnp.asarray(t), jnp.asarray(o)))
        out = TSep.debleed(torch.from_numpy(t), torch.from_numpy(o)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_stem_separator_two_distinct_members_matches_jax():
    """Two members with different weights (shared weights would make the
    blend degenerate), 3 chunks in balanced batches of 2 with a padded row;
    tolerance 1e-5."""
    jcfg, tcfg = _configs("bs_residual")
    sr, n = 8000, 10400
    x = (0.3 * np.random.default_rng(4).standard_normal((2, n))).astype(np.float32)
    weights = [(8.6, 16.0), (8.4, 16.0)]
    model = JRo.BSRoformer(jcfg)
    j_members, t_members = [], []
    for i, (wv, wi) in enumerate(weights):
        p = _params(jcfg, 10 + i, n=4000)
        j_members.append(JSep.EnsembleMember(
            f"m{i}", lambda pp, b: model.apply({"params": pp}, b), wv, wi,
            params=jax.tree_util.tree_map(jnp.asarray, p)))
        t_members.append(TSep.EnsembleMember(f"m{i}", _port(tcfg, p), wv, wi))
    kw = dict(sr=sr, chunk_seconds=0.5, overlap_seconds=0.1, device_batch=2,
              matmul_precision="highest")
    ref = JSep.StemSeparator(j_members, **kw).separate(x)
    out = TSep.StemSeparator(t_members, device="cpu", **kw).separate(x)
    for stem in ("vocals", "instrumental"):
        assert out[stem].shape == (2, n)
        np.testing.assert_allclose(out[stem], ref[stem], atol=1e-5, rtol=0)
