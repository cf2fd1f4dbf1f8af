"""CLAP's two branches in the port against the JAX package on the CPU: the
RoBERTa text branch (padding, RoBERTa's positions, the pooler and the
projection) and the HTSAT audio branch (shifted windows with their masks,
the window clamped where a stage's grid is not larger than it, patch
merging, the projection), and the mel image front end.  Tiny widths,
weights filled on ``jax.eval_shape`` templates; both ``*_from_jax``
round-trip through the JAX converters.  Tolerance: 1e-5 of max|y| (fp32
sums in another order); the mel image 1e-5 of its range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolab_tpu.models import clap as JC
from audiolab_tpu.utils.convert import convert_clap_audio, convert_clap_text
from audiolab_tpu_torch.models import clap as TC
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny
from tests.test_torch_port_music import close, tree_equal
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(19)
TEXT = dict(vocab_size=60, dim=16, layers=2, heads=2, ffn_dim=32, max_positions=24,
            joint_dim=8)
AUDIO = dict(spec_size=64, patch_size=4, patch_stride=4, embed_dim=8, depths=(2, 2, 2),
             heads=(2, 2, 4), window=4, joint_dim=8)


def _tpl(model, *args):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))["params"]


def test_clap_text_branch_matches_jax():
    jm = JC.ClapTextBranch(JC.ClapTextConfig(**TEXT))
    tpl = _tpl(jm, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))
    p = tiny.filled(tpl, 40)
    tm = tiny._load(TC.ClapTextBranch(TC.ClapTextConfig(**TEXT)), W.clap_text_from_jax(p))
    ids = RNG.integers(3, 60, (3, 7)).astype(np.int32)
    ids[:, 0] = 0
    ids[1, 5:] = 1                                   # RoBERTa's pad id
    mask = (ids != 1).astype(np.int32)
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == (3, 8)
    close(got.numpy(), want, 1e-5, "text")
    tree_equal(convert_clap_text(tiny.numpy_state(tm), tpl), p)


def test_clap_audio_branch_matches_jax():
    """A 64 x 64 image: grids 16, 8 and 4 with a window of 4, so the last
    stage's window is clamped to the grid and its shift dropped."""
    jm = JC.ClapAudioBranch(JC.ClapAudioConfig(**AUDIO))
    tpl = _tpl(jm, jnp.zeros((1, 64, 64, 1)))
    p = tiny.filled(tpl, 41)
    tm = tiny._load(TC.ClapAudioBranch(TC.ClapAudioConfig(**AUDIO)), W.clap_audio_from_jax(p))
    img = RNG.standard_normal((2, 64, 64, 1)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(img))
    with torch.no_grad():
        got = tm(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got.shape == (2, 8)
    close(got.numpy(), want, 1e-5, "audio")
    tree_equal(convert_clap_audio(tiny.numpy_state(tm), tpl), p)


def test_clap_mel_image_matches_jax():
    wav = (0.2 * RNG.standard_normal((2, 20000))).astype(np.float32)
    for spec, n_mels in ((64, 32), (32, 16)):
        want = JC.clap_mel_image(jnp.asarray(wav), spec_size=spec, n_mels=n_mels)
        got = TC.clap_mel_image(torch.from_numpy(wav), spec_size=spec, n_mels=n_mels)
        assert got.shape == (2, 1, spec, spec)
        close(got[:, 0].numpy() - np.asarray(want)[..., 0].min(),
              np.asarray(want)[..., 0] - np.asarray(want)[..., 0].min(), 1e-5, "mel image")
