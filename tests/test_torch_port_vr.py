"""Parity of the port's VR nets, multiband front end and VR separator with
the JAX package's, on the CPU, fp32, tiny widths.  The weights are seeded
in a port module under checkpoint names and reach the flax tree through the
JAX package's ``convert_vr``; ``vr_from_jax`` must carry that tree back into
the port and ``convert_vr`` map the result to the same tree again."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models.separation import vr as JV
from audiolab_tpu.models.separation import vr_bands as JB
from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu.utils.convert import convert_vr
from audiolab_tpu_torch.models.separation import vr as TV
from audiolab_tpu_torch.models.separation import vr_bands as TB
from audiolab_tpu_torch.pipelines import separate as TSep
from audiolab_tpu_torch.utils.weights import vr_from_jax
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

TINY = {
    "cascaded_asppnet": dict(arch="cascaded_asppnet", ch=4, dilations=(1, 2, 3)),
    "cascaded_net": dict(arch="cascaded_net", nout=8, nout_lstm=8,
                         dilations_new=((1, 1), (2, 1), (3, 2))),
}


@functools.lru_cache(maxsize=None)
def _nets(arch: str, n_fft: int, seed: int = 0):
    """(flax net, its params, the port net with those weights, the port net
    they came from).  The weights start in a port module under checkpoint
    names, with random batch-norm statistics, and reach the flax tree
    through the JAX package's ``convert_vr`` (its template by
    ``jax.eval_shape``, so no flax init runs); ``vr_from_jax`` carries them
    back into a second port module, whose norms are folded."""
    jcfg = JV.VRConfig(n_fft=n_fft, **TINY[arch])
    jm = JV.make_vr_net(jcfg)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, jcfg.max_bin, 32, 2))))["params"]
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        src = TV.make_vr_net(TV.VRConfig(n_fft=n_fft, **TINY[arch])).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in src.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                c = mod.num_features
                mod.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
    p = convert_vr({k: v.numpy() for k, v in src.state_dict().items()}, tpl, strict=True)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    tm = TV.make_vr_net(TV.VRConfig(n_fft=n_fft, **TINY[arch]))
    tm.load_state_dict(vr_from_jax(p), strict=True)
    return jm, p, tm.eval(), src


@pytest.mark.parametrize("arch", sorted(TINY))
def test_vr_net_matches_jax_and_round_trips(arch):
    """The mask to 1e-5 (fp32) from the port net with folded norms and from
    the one with the checkpoint's running statistics, and ``convert_vr`` of
    ``vr_from_jax``'s state_dict gives the flax tree back (to 1e-6: the
    folded norm's variance is 1 - eps in fp32)."""
    jm, p, tm, src = _nets(arch, 128)
    mag = np.abs(np.random.default_rng(1).standard_normal((2, 2, 64, 32))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        p, jnp.asarray(mag.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        out = tm(torch.from_numpy(mag)).numpy()
        out_src = src(torch.from_numpy(mag)).numpy()
    assert out.shape == (2, 2, 65, 32)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_src, ref, atol=1e-5, rtol=0)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    cfg = TV.infer_vr_config(sd, n_fft=128)
    assert cfg == TV.VRConfig(n_fft=128, **{**TINY[arch], "dilations": cfg.dilations,
                                            "dilations_new": cfg.dilations_new})
    back = convert_vr(sd, p, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def _mix(seconds=0.5, seed=0):
    sr = 44100
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 300 * t) + 0.2 * np.sin(2 * np.pi * 3100 * t)
    x = x + 0.05 * np.random.default_rng(seed).standard_normal(t.shape)
    return np.stack([x, 0.8 * x]).astype(np.float32)


@pytest.mark.parametrize("band", ["1band_sr44100_hl512", "4band_v3"])
def test_band_round_trip_matches_jax(band):
    """The combined spectrogram to 1e-4 of its peak and its resynthesis to
    1e-4 (fp32 STFTs and polyphase resampling in both)."""
    mp = JB.BAND_PARAMS[band]
    assert TB.BAND_PARAMS[band] == mp
    x = _mix()
    ref = JB.wave_to_combined_spec(x, mp)
    spec = TB.wave_to_combined_spec(torch.from_numpy(x), mp)
    assert spec.shape == ref.shape == (2, mp["bins"] + 1, ref.shape[2])
    np.testing.assert_allclose(spec.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    wave_ref = np.asarray(JB.combined_spec_to_wave(ref, mp))
    wave = TB.combined_spec_to_wave(torch.from_numpy(ref), mp).numpy()
    assert wave.shape == wave_ref.shape
    np.testing.assert_allclose(wave, wave_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("band,arch,agg,window", [
    ("1band_sr44100_hl512", "cascaded_net", 0.0, 160),   # two windows of 32 kept frames
    ("4band_v3", "cascaded_asppnet", 0.3, 384)])         # one window of 128
def test_vr_split_matches_jax(band, arch, agg, window):
    """``vr_split(KARAOKE)`` on both packages (the VR separator: combined
    spectrogram, windows batched through the net, masks, resynthesis):
    both stems to 1e-4, and primary + complement equal the band round trip
    of the input."""
    mp = TB.BAND_PARAMS[band]
    jm, p, tm, _ = _nets(arch, 2 * mp["bins"])
    x = _mix(seed=2)
    kw = dict(window_size=window, aggressiveness=agg)
    ref = JSep.vr_split(p, jm, band, JSep.KARAOKE, **kw)(x)
    out = TSep.vr_split(tm, band, TSep.KARAOKE, device="cpu", **kw)(x)
    assert TSep.KARAOKE == JSep.KARAOKE and set(out) == set(ref) == set(TSep.KARAOKE)
    for stem in TSep.KARAOKE:
        assert out[stem].shape == x.shape
        np.testing.assert_allclose(out[stem], ref[stem], atol=1e-4, rtol=0)
    if not agg:
        whole = TB.combined_spec_to_wave(TB.wave_to_combined_spec(torch.from_numpy(x), mp), mp)
        n = min(whole.shape[-1], x.shape[-1])
        total = out["lead_vocals"] + out["back_vocals"]
        np.testing.assert_allclose(total[:, :n], whole[:, :n].numpy(), atol=1e-4)


def test_vr_transform_matches_jax():
    """``vr_transform`` on a mono stem, keeping the complement: to 1e-4."""
    jm, p, tm, _ = _nets("cascaded_net", 2048)
    x = _mix(seed=3)[0]
    ref = JSep.vr_transform(p, jm, "1band_sr44100_hl512", keep="complement",
                            window_size=160)(x)
    out = TSep.vr_transform(tm, "1band_sr44100_hl512", keep="complement", window_size=160,
                            device="cpu")(x)
    assert out.shape == ref.shape == x.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
