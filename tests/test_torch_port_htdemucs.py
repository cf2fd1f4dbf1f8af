"""Parity of the port's HTDemucs (models/separation/htdemucs.py) with the JAX
package's, on the CPU, in fp32, at tests/test_htdemucs_parity.py's tiny
configuration: the forward with and without the encoders' GroupNorms, an
input shorter than the training segment, and the weight round trip through
the JAX converter (``htdemucs_member`` is held against JAX in
tests/test_torch_port_ensemble.py).  Models come from
tests/torch_port_tiny.py (no flax init)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models.separation import htdemucs as JHt
from audiolab_tpu.utils.convert import convert_htdemucs
from audiolab_tpu_torch.utils.weights import htdemucs_from_jax
from tests import torch_port_tiny as tiny


def _jax_forward(params, x, **kw):
    model = JHt.HTDemucs(JHt.HTDemucsConfig(**dict(tiny.HTD, **kw)))
    return np.asarray(jax.jit(lambda p, a: model.apply({"params": p}, a))(params, jnp.asarray(x)))


@pytest.mark.parametrize("norm_starts,n", [(4, 1000), (0, 500)],
                         ids=["published_norms", "group_norms_shorter_than_segment"])
def test_htdemucs_matches_jax(norm_starts, n):
    """Every source to 1e-5 of max|y|.  norm_starts 4 is the published
    regime (no GroupNorm in the coders), 0 takes the GroupNorm branches;
    1000 samples run as they are, 500 (< the 800-sample segment) are padded
    to the segment and trimmed back."""
    params, model = tiny.htdemucs(norm_starts=norm_starts)
    x = (0.3 * np.random.default_rng(n).standard_normal((2, 2, n))).astype(np.float32)
    ref = _jax_forward(params, x, norm_starts=norm_starts)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 2, 2, n)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_htdemucs_weights_invert_converter():
    """htdemucs_from_jax inverts convert_htdemucs exactly (strict)."""
    params, model = tiny.htdemucs(norm_starts=0)
    sd = {k: v.numpy() for k, v in htdemucs_from_jax(params).items()}
    assert set(sd) == set(model.state_dict())
    back = convert_htdemucs(sd, params, strict=True)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
