"""Parity of the port's MDX23C (models/separation/mdx23c.py) with the JAX
package's, on the CPU, in fp32, at tests/test_mdx23c_parity.py's tiny
configurations: two instruments, and one target instrument with two blocks
per scale and four subbands; the weight round trip through the JAX
converter (``mdx23c_member`` on chunks that need padding is held against
JAX in tests/test_torch_port_ensemble.py).  Models come from
tests/torch_port_tiny.py (no flax init)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models.separation import mdx23c as JMc
from audiolab_tpu.utils.convert import convert_mdx23c
from audiolab_tpu_torch.utils.weights import mdx23c_from_jax
from tests import torch_port_tiny as tiny

CASES = {
    "two_instruments": {},
    "target_instrument": dict(num_blocks_per_scale=2, target_instrument="Vocals",
                              num_subbands=4, dim_f=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mdx23c_matches_jax(case):
    """Every target to 1e-5 of max|y| (fp32 through STFT, the U-Net, iSTFT)."""
    params, model = tiny.mdx23c(**CASES[case])
    jm = JMc.TFCTDFNetV3(JMc.MDX23CConfig(**dict(tiny.MDXC, **CASES[case])))
    n = jm.good_length(0.25)
    x = (0.3 * np.random.default_rng(11).standard_normal((2, 2, n))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x)))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, model.cfg.num_targets, 2, n)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_mdx23c_weights_invert_converter():
    """mdx23c_from_jax inverts convert_mdx23c exactly (strict)."""
    params, model = tiny.mdx23c(**CASES["target_instrument"])
    sd = {k: v.numpy() for k, v in mdx23c_from_jax(params).items()}
    assert set(sd) == set(model.state_dict())
    back = convert_mdx23c(sd, params, strict=True)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
