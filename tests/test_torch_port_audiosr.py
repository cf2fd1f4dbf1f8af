"""The port's AudioSR stack (models/audiosr_{vae,unet,vocoder}.py, the
checkpoint pipeline of pipelines/super_res.py) and both learned enhancers of
Super Resolution against the JAX package's, on the CPU, at the narrow widths
of ``tests/torch_port_tiny.py`` (``AUDIOSR_*``, ``WAVEGRAD``) with seeded
flax weights carried over by the port's ``*_from_jax``; the JAX converters
map the port's state_dicts back onto the flax trees.

Tolerances, each stated in its test: the VAE, the UNet and the vocoder
within 1e-5 of max|out|; ``audiosr_fbank`` within 1e-5 of max|log-mel|; the
DDIM pipeline without classifier-free guidance (3 steps, the JAX keys'
starting latent) within 1e-4 of max|out|; the Super Resolution chain with
either enhancer (the checkpoint pipeline's guided DDIM at 10 steps, the
schema's least) within 1e-4 of the JAX run's peak plus the WAV's PCM-16
step.  Each JAX pipeline call compiles its whole DDIM loop anew, so the
guided pipeline is compared once, through the chain."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core.audio_io import read_audio as j_read_audio
from audiolab_tpu.models import audiosr_unet as JU
from audiolab_tpu.models import audiosr_vae as JV
from audiolab_tpu.models import wavegrad as JWG
from audiolab_tpu.pipelines import chain as JC
from audiolab_tpu.pipelines import super_res as JS
from audiolab_tpu.pipelines.processors import super_res as JSP
from audiolab_tpu.train import super_res as JTS
from audiolab_tpu.train import wavetransfer as JWT
from audiolab_tpu.utils.convert import (
    convert_audiosr_unet,
    convert_audiosr_vae,
    convert_audiosr_vocoder,
)
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.models import audiosr_unet as TU
from audiolab_tpu_torch.models import wavegrad as TWG
from audiolab_tpu_torch.pipelines import super_res as TS
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.pipelines.processors import super_res as TSP
from audiolab_tpu_torch.train import super_res as TTS
from audiolab_tpu_torch.train import wavetransfer as TWT
from tests import torch_port_tiny as tiny
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

SR = 44100
PCM16 = 1.0 / 32767.0 + 1e-6


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(autouse=True)
def slots():
    saved = [(c, c.enhancer_fn, c.ckpt_pipeline) for c in (JSP.SuperResolution,
                                                           TSP.SuperResolution)]
    yield
    for c, fn, pipe in saved:
        c.enhancer_fn, c.ckpt_pipeline = fn, pipe


@pytest.mark.parametrize("name,convert", [
    ("unet", lambda sd, tpl: convert_audiosr_unet(sd, tpl,
                                                  JU.AudioSRUNetConfig(**tiny.AUDIOSR_UNET))),
    ("vae", convert_audiosr_vae),
    ("vocoder", convert_audiosr_vocoder)])
def test_jax_converters_map_the_port_state_dicts_back(name, convert):
    _jm, tpl, p, tm = tiny.audiosr()[name]
    tiny.assert_tree_equal(convert(tiny.numpy_state(tm), tpl), p)


def test_unet_matches_jax():
    """Two levels, attention at rate 2; timesteps 10 and 900: within 1e-5
    of max|v|."""
    jm, _tpl, p, tm = tiny.audiosr()["unet"]
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 8)).astype(np.float32)
    ts = np.asarray([10.0, 900.0], np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, x, ts))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), torch.from_numpy(ts)))
    assert got.shape == want.shape == (2, 8, 6, 4)
    _close(got, want, 1e-5)
    assert TU.unet_layer_schedule(TU.AudioSRUNetConfig()) == JU.unet_layer_schedule(
        JU.AudioSRUNetConfig())


def test_vae_encode_and_decode_match_jax():
    """encode's mean and logvar and decode of the mean, each within 1e-5 of
    its max|.|."""
    jm, _tpl, p, tm = tiny.audiosr()["vae"]
    f = np.random.default_rng(1).standard_normal((2, 16, 16, 1)).astype(np.float32)
    jmean, jlogvar = jax.jit(lambda p, f: jm.apply({"params": p}, f,
                                                   method=JV.AudioSRVAE.encode))(p, f)
    jdec = jax.jit(lambda p, z: jm.apply({"params": p}, z, method=JV.AudioSRVAE.decode))(
        p, jmean)
    with torch.no_grad():
        mean, logvar = tm.encode(_nchw(f))
        dec = tm.decode(mean)
    assert _nhwc(mean).shape == np.asarray(jmean).shape == (2, 8, 8, 4)
    _close(_nhwc(mean), jmean, 1e-5)
    _close(_nhwc(logvar), jlogvar, 1e-5)
    assert _nhwc(dec).shape == np.asarray(jdec).shape == f.shape
    _close(_nhwc(dec), jdec, 1e-5)


def test_vocoder_matches_jax():
    """The stride-5 stage's ConvTranspose1d(k 10, padding 3, output_padding
    1) among them: within 1e-5 of max|wav|."""
    jm, _tpl, p, tm = tiny.audiosr()["vocoder"]
    mel = np.random.default_rng(2).standard_normal((2, 5, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, mel))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel).transpose(1, 2)).numpy()
    assert got.shape == want.shape == (2, 5 * 480)
    _close(got, want, 1e-5)


def test_audiosr_fbank_matches_jax():
    x = 0.3 * np.random.default_rng(3).standard_normal((2, 9600)).astype(np.float32)
    want = np.asarray(JS.audiosr_fbank(jnp.asarray(x), n_mels=64))
    got = TS.audiosr_fbank(torch.from_numpy(x), n_mels=64).numpy()
    assert got.shape == want.shape == (2, 20, 64)
    _close(got, want, 1e-5)


@functools.lru_cache(maxsize=None)
def _pipes(guidance: float = 3.5):
    """(JAX AudioSRCheckpointPipeline, port pipeline) on the same weights,
    scale_factor 0.7, n_mels 16."""
    m = tiny.audiosr()
    kw = dict(scale_factor=0.7, guidance_scale=guidance, n_mels=16)
    j = JS.AudioSRCheckpointPipeline(m["vae"][0], m["vae"][2], m["unet"][0], m["unet"][2],
                                     m["vocoder"][0], m["vocoder"][2], **kw)
    t = TS.AudioSRCheckpointPipeline(m["vae"][3], m["unet"][3], m["vocoder"][3], **kw)
    return j, t


def _jax_z(seed, b, frames, n_mels=16):
    """The JAX pipeline's starting latent for ``seed`` (NHWC draws, the tiny
    VAE's 2x down on both axes) in the port's NCHW layout."""
    z = jax.random.normal(jax.random.PRNGKey(seed), (b, frames // 2, n_mels // 2, 4))
    return _nchw(np.asarray(z))


def test_ddim_without_guidance_matches_jax():
    """super_resolve at guidance 1 (no CFG branch), 3 steps: within 1e-4 of
    max|wav|."""
    j, t = _pipes(1.0)
    f = np.random.default_rng(4).standard_normal((1, 8, 16, 1)).astype(np.float32) - 4.0
    want = np.asarray(j.super_resolve(jnp.asarray(f), steps=3, seed=5))
    got = t.super_resolve(_nchw(f), steps=3, z=_jax_z(5, 1, 8)).numpy()
    assert got.shape == want.shape == (1, 8 * 480)
    _close(got, want, 1e-4)


def test_enhance_chunks_keeps_the_contract():
    """enhance_chunks on (2, 2, n) chunks, n not a multiple of the hop (the
    guided DDIM itself is held against JAX through the chain below): the
    shape is kept, and a gain on the input comes out as the same gain within
    1e-5 of max|out| (the input is normalised to peak 0.5, the output scaled
    back)."""
    _j, t = _pipes(3.5)
    x = (0.2 * np.random.default_rng(6).standard_normal((2, 2, 9000))).astype(np.float32)
    z = _jax_z(7, 4, 64)                              # 19 fbank frames padded to 64
    got = t.enhance_chunks(torch.from_numpy(x), steps=3, z=z).numpy()
    loud = t.enhance_chunks(torch.from_numpy(3.0 * x), steps=3, z=z).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    _close(loud, 3.0 * got, 1e-5)


def _tones(n, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 3100 * t),
                  0.25 * np.sin(2 * np.pi * 660 * t) + 0.1 * np.sin(2 * np.pi * 5200 * t)])
    return (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)


def _chains(tmp_path, settings):
    song = tmp_path / "song.wav"
    write_wav(song, _tones(SR, seed=3), SR)
    j = JC.run_chain(["Super Resolution"], [str(song)], json.loads(json.dumps(settings)),
                     output_root=str(tmp_path / "jax"))[0].last_outputs
    t = run_chain(["Super Resolution"], [str(song)], json.loads(json.dumps(settings)),
                  output_root=str(tmp_path / "port"), device="cpu")[0].last_outputs
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == [
        "song_48k.wav"]
    a, b = read_audio(t[0]), j_read_audio(j[0])
    assert a.sample_rate == b.sample_rate == 48000 and a.samples.shape == b.samples.shape
    return a.samples, b.samples


WT_TINY = dict(sr=48000, n_mels=16, seg_frames=12, batch_size=2, lr=1e-3)


def test_chain_with_the_wavegrad_enhancer_matches_jax(tmp_path):
    """Super Resolution through both packages' run_chain (one 5 s chunk)
    with make_wavegrad_enhancer on the same WaveGrad, FAST_6 and the JAX
    keys' draws: within 1e-4 of the JAX output's peak plus a PCM-16 step.
    The port's slot takes the plain function; the JAX slot does not."""
    jm, _tpl, p, tm = tiny.wavegrad()
    jcfg = JWT.WTConfig(model=JWG.WaveGradConfig(**tiny.WAVEGRAD), **WT_TINY)
    tcfg = TWT.WTConfig(model=TWG.WaveGradConfig(**tiny.WAVEGRAD), **WT_TINY)
    enhance = JS.make_wavegrad_enhancer(jm, p, jcfg, seed=2)
    # the JAX processor binds a plain function in its slot as a method, so
    # its own enhancer fails there and the chain returns its input (ROADMAP
    # queue 3); a partial does not bind
    song = tmp_path / "song.wav"
    write_wav(song, _tones(SR, seed=3), SR)
    JSP.SuperResolution.configure(enhancer_fn=enhance)
    outs = JC.run_chain(["Super Resolution"], [str(song)], {"Super Resolution": {
        "chunk_size": 5.0}}, output_root=str(tmp_path / "bound"))[0].last_outputs
    assert "song_48k.wav" not in [os.path.basename(f) for f in outs]
    JSP.SuperResolution.configure(enhancer_fn=functools.partial(enhance))
    rows, n = 2, 240000 // 60 * 60
    draws = torch.from_numpy(tiny.jax_sample_draws(jax.random.PRNGKey(2), 6, rows, n))
    TSP.SuperResolution.configure(enhancer_fn=TS.make_wavegrad_enhancer(tm, tcfg, draws=draws))
    got, want = _chains(tmp_path, {"Super Resolution": {"chunk_size": 5.0}})
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + PCM16


class _JaxZ:
    """The port pipeline behind the processor with the JAX keys' starting
    latent for the processor's seed (the slot's contract: guidance_scale
    and enhance_chunks(chunks, steps=, seed=))."""

    def __init__(self, pipe):
        self.pipe = pipe

    @property
    def guidance_scale(self):
        return self.pipe.guidance_scale

    @guidance_scale.setter
    def guidance_scale(self, v):
        self.pipe.guidance_scale = v

    def enhance_chunks(self, chunks, steps, seed):
        count, ch, n = chunks.shape
        frames = (n + 2 * 784 - 2048) // 480 + 1
        frames += (-frames) % 64
        return self.pipe.enhance_chunks(chunks, steps=steps, z=_jax_z(seed, count * ch, frames))


def test_chain_with_the_checkpoint_pipeline_matches_jax(tmp_path):
    """Super Resolution through both packages' run_chain with
    ``ckpt_pipeline`` set: enhance_chunks with 10 guided DDIM steps (the
    schema's least) at guidance 2.5, seed 9, one 5 s chunk: within 1e-4 of
    the JAX output's peak plus a PCM-16 step."""
    j, t = _pipes(3.5)
    JSP.SuperResolution.configure(ckpt_pipeline=j)
    TSP.SuperResolution.configure(ckpt_pipeline=_JaxZ(t))
    got, want = _chains(tmp_path, {"Super Resolution": {
        "chunk_size": 5.0, "ddim_steps": 10, "guidance_scale": 2.5, "seed": 9}})
    assert t.guidance_scale == j.guidance_scale == 2.5
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + PCM16


def test_pair_batches_are_the_jax_ones(tmp_path):
    """The super-resolution trainer's (fullband, band-limited mel) batches
    for the same numpy generator: audio equal, mel within 1e-5."""
    for i, f0 in enumerate((300.0, 520.0)):
        write_wav(tmp_path / f"{i}.wav", _tones(int(0.4 * SR), seed=i)[0] * (f0 / 500.0), SR)
    files = sorted(str(p) for p in tmp_path.glob("*.wav"))
    jcfg = JTS.SRTrainConfig(wt=JWT.WTConfig(model=JWG.WaveGradConfig(**tiny.WAVEGRAD),
                                             **WT_TINY))
    tcfg = TTS.SRTrainConfig(wt=TWT.WTConfig(model=TWG.WaveGradConfig(**tiny.WAVEGRAD),
                                             **WT_TINY))
    jg = JTS._pair_batches(files, jcfg, np.random.default_rng(0))
    tg = TTS._pair_batches(files, tcfg, np.random.default_rng(0), torch.device("cpu"))
    for _ in range(2):
        (ja, jm), (ta, tm) = next(jg), next(tg)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert tm.shape == jm.shape == (2, 12, 16)
        _close(tm.numpy(), jm, 1e-5)


def test_train_superres_then_load_enhancer_serves_the_processor(tmp_path):
    """The port's super-resolution trainer for two steps, then
    load_enhancer into the processor: the chain gives one 48 kHz WAV of the
    input's length, finite and not silent."""
    data = tmp_path / "data"
    data.mkdir()
    write_wav(data / "a.wav", _tones(int(0.5 * SR), seed=4), SR)
    cfg = TTS.SRTrainConfig(wt=TWT.WTConfig(model=TWG.WaveGradConfig(**tiny.WAVEGRAD),
                                            steps=2, ckpt_every=2, **WT_TINY))
    res = TTS.train_superres(str(data), cfg, device="cpu")
    assert res["steps"] == 2 and np.isfinite(res["loss"])
    TSP.SuperResolution.configure(enhancer_fn=TTS.load_enhancer(str(data), cfg, device="cpu"))
    song = tmp_path / "song.wav"
    write_wav(song, _tones(SR // 2, seed=5), SR)
    out = run_chain(["Super Resolution"], [str(song)], {"Super Resolution": {"chunk_size": 5.0}},
                    output_root=str(tmp_path / "port"), device="cpu")[0].last_outputs
    a = read_audio(out[0])
    assert a.sample_rate == 48000 and a.samples.shape == (2, 24000)
    assert np.isfinite(a.samples).all() and np.abs(a.samples).max() > 0.01
