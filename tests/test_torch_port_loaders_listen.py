"""The port's checkpoint loaders of Super Resolution, transcription,
diarization and alignment (audiolab_tpu_torch/utils/convert.py) against the
JAX package's (audiolab_tpu/utils/convert.py), on the CPU, on files the
tests write in the upstream containers and names from seeded port modules at
small widths.

Each case reads one file with both packages: the JAX loader's tree reaches
the port through ``utils/weights.py``'s ``*_from_jax``, and its state_dict
must equal, bit for bit, the one the port's loader gives; both packages then
run the loaded models on one seeded input at the tolerance of the module's
parity test (AudioSR's UNet, VAE and vocoder 1e-5 of max|y|; Whisper's
logits, the aligner's and PyanNet's log-probs, the WeSpeaker embedding 1e-5;
RTLA's log-probs 1e-5 of max|y|).

The files hold what the JAX converter must fold (weight-norm pairs with a
gain off the weight's norm, over dim 0 for the vocoder and over dim 2 for
wav2vec2's positional convolution in both of torch's forms; LSTM hidden
biases; batch-norm statistics, WeSpeaker's affine-free ``seg_bn_1``
included), tensors it ignores (the other parts of a whole AudioSR
checkpoint, Whisper's sinusoids, HF's ``masked_spec_embed``, the sinc
filterbank's buffers, WeSpeaker's margin head) and the prefixes it strips.
Every JAX loader here builds its template by ``jax.eval_shape``, so no flax
``init`` runs.
"""

import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import audiosr_unet as JU
from audiolab_tpu.models import audiosr_vae as JVae
from audiolab_tpu.models import audiosr_vocoder as JVo
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models import pyannet as JP
from audiolab_tpu.models import wav2vec2 as JW2
from audiolab_tpu.models import whisper as JW
from audiolab_tpu.utils import convert as JV
from audiolab_tpu_torch.models import audiosr_unet as TU
from audiolab_tpu_torch.models import audiosr_vae as TVae
from audiolab_tpu_torch.models import audiosr_vocoder as TVo
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import pyannet as TP
from audiolab_tpu_torch.models import rtla as TR
from audiolab_tpu_torch.models import wav2vec2 as TW2
from audiolab_tpu_torch.models import wespeaker as TWs
from audiolab_tpu_torch.models import whisper as TW
from audiolab_tpu_torch.models.diarize import DiarizeConfig, NeuralDiarizer
from audiolab_tpu_torch.utils import convert as TV
from audiolab_tpu_torch.utils import weights as W
from chip_smoke import cpu_state, weight_norm_pairs, write_safetensors
from tests import torch_port_tiny as tiny
from tests.test_torch_port_loaders import _states_equal
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

WHISPER = dict(n_mels=16, n_audio_ctx=50, dim=32, n_heads=4, n_audio_layers=2, n_text_layers=2,
               vocab_size=64, n_text_ctx=16, sot=60, eot=59, no_timestamps=61,
               timestamp_base=62)
W2V_ENC = dict(dim=64, ffn_dim=128, heads=4, layers=2)
PYAN = dict(lstm_hidden=8, lstm_layers=2, linear_dim=8)
RTLA = dict(n_mels=66, num_lbl=12, model_complexity=1)
VOCODER_WN = re.compile(r"^(conv_pre|conv_post|ups\.\d+|resblocks\.\d+\.convs[12]\.\d+)"
                        r"\.weight$")
W2V_WN = re.compile(r"^wav2vec2\.encoder\.pos_conv_embed\.conv\.weight$")
SCALE_FACTOR = 0.7341


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _gains_off(sd: dict, seed: int) -> dict:
    """``sd`` with every weight-norm gain moved off its weight's norm, so
    that the fold changes the weight."""
    g = torch.Generator().manual_seed(seed)
    return {k: v * (1.0 + 0.2 * torch.rand(v.shape, generator=g)) if k.endswith("weight_g")
            else v for k, v in sd.items()}


def _parametrized(sd: dict) -> dict:
    """torch 2's weight-norm names for each pair."""
    return {re.sub(r"\.weight_([gv])$", lambda m: ".parametrizations.weight.original"
                   + ("0" if m.group(1) == "g" else "1"), k): v for k, v in sd.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- AudioSR

@functools.lru_cache(maxsize=None)
def _audiosr_parts() -> dict:
    """Seeded port modules at the tiny AudioSR widths, state_dicts on the host."""
    return {"unet": cpu_state(tiny.seeded(lambda: TU.AudioSRUNet(
                TU.AudioSRUNetConfig(**tiny.AUDIOSR_UNET)), 80)),
            "vae": cpu_state(tiny.seeded(lambda: TVae.AudioSRVAE(**tiny.AUDIOSR_VAE), 81)),
            "vocoder": cpu_state(tiny.seeded(lambda: TVo.AudioSRVocoder(
                **tiny.AUDIOSR_VOCODER), 82))}


def _vocoder_upstream(form: str = "pair") -> dict:
    """The vocoder's convolutions as weight-norm pairs (gains off), in the
    old names or torch 2's, or as plain weights."""
    sd = _audiosr_parts()["vocoder"]
    if form == "plain":
        return dict(sd)
    sd = _gains_off(weight_norm_pairs(sd, VOCODER_WN, dim=0), 83)
    return _parametrized(sd) if form == "parametrizations" else sd


def _audiosr_ckpt() -> dict:
    """A whole AudioSR checkpoint: the VAE under ``first_stage_model.``, its
    vocoder under ``first_stage_model.vocoder.``, the UNet under
    ``model.diffusion_model.``, the latent ``scale_factor`` and an EMA
    decay nobody reads."""
    parts = _audiosr_parts()
    ckpt = {f"first_stage_model.{k}": v for k, v in parts["vae"].items()}
    ckpt.update({f"first_stage_model.vocoder.{k}": v for k, v in _vocoder_upstream().items()})
    ckpt.update({f"model.diffusion_model.{k}": v for k, v in parts["unet"].items()})
    ckpt["scale_factor"] = torch.tensor(SCALE_FACTOR)
    ckpt["model_ema.decay"] = torch.tensor(0.999)
    return ckpt


def _audiosr_loaders(part: str):
    """(JAX loader, port loader, port module from the JAX tree) of one part."""
    if part == "unet":
        jcfg = JU.AudioSRUNetConfig(**tiny.AUDIOSR_UNET)
        tcfg = TU.AudioSRUNetConfig(**tiny.AUDIOSR_UNET)
        return (lambda p: JV.load_audiosr_unet_checkpoint(p, jcfg),
                lambda p: TV.load_audiosr_unet_checkpoint(p, tcfg, device="cpu"),
                lambda t: tiny._load(TU.AudioSRUNet(tcfg), W.audiosr_unet_from_jax(t, tcfg)))
    if part == "vae":
        return (lambda p: JV.load_audiosr_vae_checkpoint(p, **tiny.AUDIOSR_VAE),
                lambda p: TV.load_audiosr_vae_checkpoint(p, device="cpu", **tiny.AUDIOSR_VAE),
                lambda t: tiny._load(TVae.AudioSRVAE(**tiny.AUDIOSR_VAE),
                                         W.audiosr_vae_from_jax(t)))
    return (lambda p: JV.load_audiosr_vocoder_checkpoint(p, **tiny.AUDIOSR_VOCODER),
            lambda p: TV.load_audiosr_vocoder_checkpoint(p, device="cpu",
                                                         **tiny.AUDIOSR_VOCODER),
            lambda t: tiny._load(TVo.AudioSRVocoder(**tiny.AUDIOSR_VOCODER),
                                     W.audiosr_vocoder_from_jax(t)))


def _audiosr_outputs_match(part: str, params, got) -> None:
    """The JAX module on ``params`` against the port's loaded module."""
    rng = np.random.default_rng(7)
    if part == "unet":
        jm = JU.AudioSRUNet(JU.AudioSRUNetConfig(**tiny.AUDIOSR_UNET))
        x = rng.standard_normal((2, 8, 6, 8)).astype(np.float32)
        ts = np.asarray([10.0, 900.0], np.float32)
        want = jax.jit(jm.apply)({"params": params}, x, ts)
        with torch.no_grad():
            _close(_nhwc(got(_nchw(x), torch.from_numpy(ts))), want, 1e-5)
    elif part == "vae":
        jm = JVae.AudioSRVAE(**tiny.AUDIOSR_VAE)
        f = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
        jmean, _ = jax.jit(lambda p, f: jm.apply({"params": p}, f, method=JVae.AudioSRVAE.encode))(
            params, f)
        jdec = jax.jit(lambda p, z: jm.apply({"params": p}, z, method=JVae.AudioSRVAE.decode))(
            params, jmean)
        with torch.no_grad():
            mean, _ = got.encode(_nchw(f))
            _close(_nhwc(mean), jmean, 1e-5)
            _close(_nhwc(got.decode(mean)), jdec, 1e-5)
    else:
        jm = JVo.AudioSRVocoder(**tiny.AUDIOSR_VOCODER)
        mel = rng.standard_normal((2, 5, 16)).astype(np.float32)
        want = jax.jit(jm.apply)({"params": params}, mel)
        with torch.no_grad():
            _close(got(torch.from_numpy(mel).transpose(1, 2)).numpy(), want, 1e-5)


@pytest.mark.parametrize("part", ["unet", "vae", "vocoder"])
def test_audiosr_whole_checkpoint_matches_jax(tmp_path, part):
    """Each part of one whole checkpoint: the other parts' tensors dropped
    by both loaders, not refused."""
    path = str(tmp_path / "audiosr.ckpt")
    torch.save(_audiosr_ckpt(), path)
    jax_load, port_load, via_jax = _audiosr_loaders(part)
    params = jax_load(path)
    got = port_load(path)
    _states_equal(got, via_jax(params))
    _audiosr_outputs_match(part, params, got)


@pytest.mark.parametrize("prefix,form", [("vocoder.", "pair"), ("generator.", "parametrizations"),
                                         ("", "plain")])
def test_audiosr_vocoder_prefixes_and_weight_norm_forms(tmp_path, prefix, form):
    path = str(tmp_path / "vocoder.pt")
    torch.save({f"{prefix}{k}": v for k, v in _vocoder_upstream(form).items()}, path)
    jax_load, port_load, via_jax = _audiosr_loaders("vocoder")
    got = port_load(path)
    _states_equal(got, via_jax(jax_load(path)))
    if form == "plain":
        _states_equal(got, tiny._load(TVo.AudioSRVocoder(**tiny.AUDIOSR_VOCODER),
                                          _audiosr_parts()["vocoder"]))


@pytest.mark.parametrize("key", ["scale_factor", "model.scale_factor",
                                 "state_dict.scale_factor", None])
def test_audiosr_scale_factor_matches_jax(tmp_path, key):
    """The three names both loaders look under, in fp64 (read through fp32
    by both), and a file without one (the default)."""
    path = str(tmp_path / "audiosr.ckpt")
    sd = {"first_stage_model.quant_conv.bias": torch.zeros(4)}
    if key is not None:
        sd[key] = torch.tensor(SCALE_FACTOR, dtype=torch.float64)
    torch.save(sd, path)
    want = JV.load_audiosr_scale_factor(path, default=0.5)
    got = TV.load_audiosr_scale_factor(path, default=0.5)
    assert got == want == (float(np.float32(SCALE_FACTOR)) if key else 0.5)


# ---------------------------------------------------------------- Whisper

@functools.lru_cache(maxsize=None)
def _whisper_state() -> dict:
    """openai-whisper's ``model_state_dict``: fp16 tensors, with the
    encoder's sinusoids, which neither package reads."""
    sd = {k: v.half() for k, v in cpu_state(tiny.seeded(
        lambda: TW.WhisperModel(TW.WhisperConfig(**WHISPER)), 84, 0.05)).items()}
    sd["encoder.positional_embedding"] = torch.from_numpy(
        TW.sinusoids(WHISPER["n_audio_ctx"], WHISPER["dim"])).half()
    return sd


def _whisper_template():
    cfg = JW.WhisperConfig(**WHISPER)
    return cfg, jax.eval_shape(lambda: JW.WhisperModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 100, cfg.n_mels)),
        jnp.zeros((1, 4), jnp.int32)))["params"]


def _whisper_sd(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"]


def test_whisper_state_matches_jax(tmp_path):
    """openai-whisper's ``.pt`` (``dims`` and an fp16 ``model_state_dict``),
    its state_dict given to both packages (neither has a Whisper file
    reader): the port's model equal to the JAX tree's, the uncached logits
    within 1e-5 of max|logit|."""
    path = str(tmp_path / "tiny.pt")
    torch.save({"dims": dict(WHISPER), "model_state_dict": _whisper_state()}, path)
    cfg, tpl = _whisper_template()
    params = JV.convert_whisper(_whisper_sd(path), tpl)
    tcfg = TW.WhisperConfig(**WHISPER)
    got = TV.load_whisper_state(TW.WhisperModel(tcfg), _whisper_sd(path))
    _states_equal(got, tiny._load(TW.WhisperModel(tcfg), W.whisper_from_jax(params)))
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((1, 100, cfg.n_mels)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    want = jax.jit(JW.WhisperModel(cfg).apply)({"params": params}, mel, tokens)
    with torch.no_grad():
        out = got.eval()(torch.from_numpy(mel), torch.from_numpy(tokens).long())
    _close(out.numpy(), want, 1e-5)


# --------------------------------------------------------------- wav2vec2

@functools.lru_cache(maxsize=None)
def _w2v_port_state() -> dict:
    return cpu_state(tiny.seeded(lambda: TW2.Wav2Vec2CTC(TW2.Wav2Vec2Config(
        encoder=TH.HubertConfig(**W2V_ENC))), 85))


def _w2v_hf(form: str) -> dict:
    """HF Wav2Vec2ForCTC's names, the positional convolution's weight norm
    over dim 2 in ``form``, and HF's ``masked_spec_embed``."""
    sd = _gains_off(weight_norm_pairs(W.wav2vec2_to_hf(_w2v_port_state()), W2V_WN, dim=2), 86)
    sd["wav2vec2.masked_spec_embed"] = torch.rand(W2V_ENC["dim"])
    return _parametrized(sd) if form == "parametrizations" else sd


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
def test_wav2vec2_loader_matches_jax(tmp_path, form):
    """Both packages' aligners from one ``pytorch_model.bin``: the port's
    model equal to the JAX tree's, log-probs within 1e-5, the aligned words
    identical."""
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(_w2v_hf(form), path)
    jcfg = JW2.Wav2Vec2Config(encoder=JH.HubertConfig(**W2V_ENC))
    tcfg = TW2.Wav2Vec2Config(encoder=TH.HubertConfig(**W2V_ENC))
    ja = JV.load_wav2vec2_checkpoint(path, jcfg)
    ta = TV.load_wav2vec2_checkpoint(path, tcfg, device="cpu")
    assert isinstance(ta, TW2.CTCWordAligner) and ta.vocab == ja.vocab
    _states_equal(ta.model, tiny._load(TW2.Wav2Vec2CTC(tcfg),
                                           W.wav2vec2_from_jax(ja.params)))
    x = (0.2 * np.random.default_rng(9).standard_normal(24000)).astype(np.float32)
    _close(ta.log_probs(x[:16000]), ja._logits(jnp.asarray(x[:16000])[None])[0], 1e-5)
    words = ["hello", "there", "friend"]
    assert ta.align_words(x, 16000, 0.2, 1.4, words) == ja.align_words(x, 16000, 0.2, 1.4,
                                                                       words)


# ---------------------------------------------------------------- PyanNet

@functools.lru_cache(maxsize=None)
def _pyannet_state() -> dict:
    """segmentation-3.0's names, the LSTM biases on both sides, the sinc
    filterbank's window and sample-index buffers beside its learned edges."""
    sd = cpu_state(tiny.seeded(lambda: TP.PyanNet(TP.PyanNetConfig(**PYAN)), 87, 0.05))
    assert float(sd["lstm.bias_hh_l1_reverse"].abs().min()) > 0
    sd["sincnet.conv1d.0.filterbank.window_"] = torch.hann_window(125)
    sd["sincnet.conv1d.0.filterbank.n_"] = torch.arange(125.0)
    return sd


@pytest.mark.parametrize("prefix", ["", "model."])
def test_pyannet_loader_matches_jax(tmp_path, prefix):
    """A plain state_dict and Lightning's ``model.``: the state_dict the
    port's loader returns (what ``NeuralDiarizer(pyannet_params=)`` takes)
    equal to the JAX tree's, the log-probs within 1e-5."""
    path = str(tmp_path / "pytorch_model.bin")
    torch.save({f"{prefix}{k}": v for k, v in _pyannet_state().items()}, path)
    params = JV.load_pyannet_checkpoint(path, JP.PyanNetConfig(**PYAN))
    tcfg = TP.PyanNetConfig(**PYAN)
    got = TV.load_pyannet_checkpoint(path, tcfg, device="cpu")
    model = tiny._load(TP.PyanNet(tcfg), got)
    _states_equal(model, tiny._load(TP.PyanNet(tcfg), W.pyannet_from_jax(params)))
    wav = (0.2 * np.random.default_rng(10).standard_normal((1, 16000))).astype(np.float32)
    want = jax.jit(JP.PyanNet(JP.PyanNetConfig(**PYAN)).apply)({"params": params}, wav)
    with torch.no_grad():
        _close(model(torch.from_numpy(wav)).numpy(), want, 1e-5)


# -------------------------------------------------------------- WeSpeaker

@functools.lru_cache(maxsize=None)
def _wespeaker_state(two_emb_layer: bool) -> dict:
    """wespeaker's names, every batch norm's statistics off their initial
    values (``seg_bn_1``, with no affine, among them), and the margin
    head's ``projection.weight``."""
    cfg = TWs.WeSpeakerConfig(**tiny.WESPEAKER_TINY, two_emb_layer=two_emb_layer)
    sd = cpu_state(tiny.seeded(lambda: TWs.WeSpeakerResNet(cfg), 88))
    assert ("seg_bn_1.weight" in sd) is False and ("seg_bn_1.running_var" in sd) == two_emb_layer
    sd["projection.weight"] = torch.rand(5, cfg.embed_dim)
    return sd


@pytest.fixture
def tiny_wespeaker_default(monkeypatch):
    """Both packages' ``WeSpeakerConfig()`` at WESPEAKER_TINY's widths, so
    that the loaders' own default (only ``two_emb_layer`` sniffed) runs on
    a small file."""
    from audiolab_tpu.models import wespeaker as JWs

    for mod in (JWs, TWs):
        monkeypatch.setattr(mod, "WeSpeakerConfig",
                            functools.partial(mod.WeSpeakerConfig, **tiny.WESPEAKER_TINY))


@pytest.mark.parametrize("two_emb_layer,prefix", [(False, ""), (True, "resnet."),
                                                  (True, "speaker_encoder."), (False, "model.")])
def test_wespeaker_loader_matches_jax(tmp_path, tiny_wespeaker_default, two_emb_layer, prefix):
    """``two_emb_layer`` sniffed by both loaders from ``seg_2.weight``; the
    affine-free ``seg_bn_1`` folded by the JAX expression and stored as
    ``wespeaker_from_jax`` stores it; the embedding within 1e-5."""
    path = str(tmp_path / "pytorch_model.bin")
    torch.save({f"{prefix}{k}": v for k, v in _wespeaker_state(two_emb_layer).items()}, path)
    jm, params = JV.load_wespeaker_checkpoint(path)
    got = TV.load_wespeaker_checkpoint(path, device="cpu")
    assert jm.cfg.two_emb_layer is got.cfg.two_emb_layer is two_emb_layer
    assert ("seg_2" in params) is two_emb_layer
    _states_equal(got, tiny._load(TWs.WeSpeakerResNet(got.cfg), W.wespeaker_from_jax(params)))
    fb = np.random.default_rng(11).standard_normal((2, 41, got.cfg.feat_dim)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, fb)
    with torch.no_grad():
        _close(got(torch.from_numpy(fb)).numpy(), want, 1e-5)


def test_affine_free_norm_folds_to_its_statistics():
    """``seg_bn_1`` from the file: its folded statistics normalise as the
    file's do (to fp32 rounding), and the affine norms of the same file
    fold as before."""
    sd = {k: v.clone() for k, v in _wespeaker_state(True).items()}
    TV._fold_batch_norms(sd)
    src = _wespeaker_state(True)
    x = torch.randn(3, tiny.WESPEAKER_TINY["embed_dim"], dtype=torch.float64)
    want = (x - src["seg_bn_1.running_mean"].double()) / torch.sqrt(
        src["seg_bn_1.running_var"].double() + 1e-5)
    got = (x - sd["seg_bn_1.running_mean"].double()) / torch.sqrt(
        sd["seg_bn_1.running_var"].double() + 1e-5)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert "seg_bn_1.weight" not in sd and torch.equal(sd["bn1.running_mean"], torch.zeros(8))


def test_loaded_stages_build_the_diarizer(tmp_path):
    """NeuralDiarizer takes both loaded stages: the PyanNet state_dict as
    ``pyannet_params`` and the WeSpeaker ResNet as ``wespeaker``."""
    torch.save(_pyannet_state(), tmp_path / "seg.bin")
    torch.save(_wespeaker_state(True), tmp_path / "emb.bin")
    pcfg = TP.PyanNetConfig(**PYAN)
    seg = TV.load_pyannet_checkpoint(str(tmp_path / "seg.bin"), pcfg, device="cpu")
    emb = TV.load_wespeaker_checkpoint(str(tmp_path / "emb.bin"), _tiny_wespeaker("port"),
                                       device="cpu")
    diar = NeuralDiarizer(DiarizeConfig(n_mels=16, hidden=8, emb_dim=4), pyannet_params=seg,
                          pyannet_cfg=pcfg, wespeaker=emb, device="cpu")
    assert diar.wespeaker is emb
    for k, v in diar.pyannet.state_dict().items():
        assert torch.equal(v, seg[k]), k


# ------------------------------------------------------------------- RTLA

@functools.lru_cache(maxsize=None)
def _rtla_state() -> dict:
    sd = cpu_state(tiny.seeded(lambda: TR.RtlaCRNN(TR.RtlaCRNNConfig(**RTLA)), 89))
    assert float(sd["model.1.rnn.bias_hh_l0"].abs().min()) > 0
    return sd


def _write_rtla(tmp_path, fmt: str) -> tuple[str, str | None]:
    """RTLA's release: a ``.pt`` dict of ``model_state_dict`` and ``config``
    (or without the config), or ``pretrained-model.safetensors`` with its
    sibling JSON (or alone)."""
    config = {"config": {"n_mels": RTLA["n_mels"], "num_lbl": RTLA["num_lbl"],
                         "model_complexity": RTLA["model_complexity"], "lr": 1e-3}}
    if fmt.startswith("pt"):
        path = str(tmp_path / "model.pt")
        blob = {"model_state_dict": _rtla_state()}
        if fmt == "pt":
            blob["config"] = config["config"]
        torch.save(blob, path)
        return path, None
    path = str(tmp_path / "pretrained-model.safetensors")
    write_safetensors(path, _rtla_state())
    if fmt == "safetensors":
        with open(tmp_path / "pretrained-model.json", "w") as f:
            json.dump(config, f)
        return path, str(tmp_path / "pretrained-model.json")
    return path, None


@pytest.mark.parametrize("fmt", ["pt", "pt_without_config", "safetensors",
                                 "safetensors_without_json"])
def test_rtla_loader_matches_jax(tmp_path, fmt):
    """The config from the file's ``config`` or JSON, else sniffed from
    ``model.2``'s shapes by both; the three batch norms and the LSTM's
    hidden bias folded; log-probs within 1e-5 of max|y|."""
    path, config_json = _write_rtla(tmp_path, fmt)
    jm, params = JV.load_rtla_crnn_checkpoint(path, config_json)
    got = TV.load_rtla_crnn_checkpoint(path, config_json, device="cpu")
    assert got.cfg == TR.RtlaCRNNConfig(**RTLA)
    assert (jm.cfg.n_mels, jm.cfg.num_lbl, jm.cfg.model_complexity) == tuple(RTLA.values())
    _states_equal(got, tiny._load(TR.RtlaCRNN(got.cfg), W.rtla_crnn_from_jax(params)))
    feat = np.random.default_rng(12).standard_normal((1, 20, RTLA["n_mels"])).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, feat)
    with torch.no_grad():
        _close(got(torch.from_numpy(feat)).numpy(), want, 1e-5)


# --------------------------------------------- a missing key, a wrong shape

def _save(obj):
    def write(path, sd):
        torch.save(obj(sd), path)
    return write


def _tiny_wespeaker(pkg):
    from audiolab_tpu.models import wespeaker as JWs

    mod = JWs if pkg == "jax" else TWs
    return mod.WeSpeakerConfig(**tiny.WESPEAKER_TINY, two_emb_layer=True)


# format: (the upstream state_dict, how it is written, a key no fold reads
#          (the file's name, the port module's), the JAX loader, the port
#          loader); each loader takes the file's path
FORMATS = {
    "audiosr_unet": (_audiosr_ckpt, _save(dict), ("model.diffusion_model.out.2.bias",
                                                  "out.2.bias"), *_audiosr_loaders("unet")[:2]),
    "audiosr_vae": (_audiosr_ckpt, _save(dict), ("first_stage_model.decoder.conv_in.bias",
                                                 "decoder.conv_in.bias"),
                    *_audiosr_loaders("vae")[:2]),
    "audiosr_vocoder": (_audiosr_ckpt, _save(dict), ("first_stage_model.vocoder.conv_post.bias",
                                                     "conv_post.bias"),
                        *_audiosr_loaders("vocoder")[:2]),
    "whisper": (_whisper_state, _save(lambda sd: {"model_state_dict": sd}),
                ("decoder.blocks.1.mlp.2.bias",) * 2,
                lambda p: JV.convert_whisper(_whisper_sd(p), _whisper_template()[1]),
                lambda p: TV.load_whisper_state(
                    TW.WhisperModel(TW.WhisperConfig(**WHISPER)), _whisper_sd(p))),
    "wav2vec2": (lambda: _w2v_hf("weight_g"), _save(dict),
                 ("wav2vec2.encoder.layers.1.feed_forward.output_dense.bias",
                  "encoder.encoder.layers.1.fc2.bias"),
                 lambda p: JV.load_wav2vec2_checkpoint(p, JW2.Wav2Vec2Config(
                     encoder=JH.HubertConfig(**W2V_ENC))),
                 lambda p: TV.load_wav2vec2_checkpoint(p, TW2.Wav2Vec2Config(
                     encoder=TH.HubertConfig(**W2V_ENC)), device="cpu")),
    "pyannet": (_pyannet_state, _save(dict), ("linear.1.bias",) * 2,
                lambda p: JV.load_pyannet_checkpoint(p, JP.PyanNetConfig(**PYAN)),
                lambda p: TV.load_pyannet_checkpoint(p, TP.PyanNetConfig(**PYAN), device="cpu")),
    "wespeaker": (lambda: _wespeaker_state(True), _save(dict), ("seg_2.bias",) * 2,
                  lambda p: JV.load_wespeaker_checkpoint(p, _tiny_wespeaker("jax")),
                  lambda p: TV.load_wespeaker_checkpoint(p, _tiny_wespeaker("port"),
                                                         device="cpu")),
    "rtla": (_rtla_state, _save(lambda sd: {"model_state_dict": sd}),
             ("model.0.fc.0.bias",) * 2,
             lambda p: JV.load_rtla_crnn_checkpoint(p),
             lambda p: TV.load_rtla_crnn_checkpoint(p, device="cpu")),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_missing_key_raises_in_both(tmp_path, fmt):
    source, write, (key, port_key), jax_load, port_load = FORMATS[fmt]
    sd = dict(source())
    del sd[key]
    path = str(tmp_path / "missing.pt")
    write(path, sd)
    with pytest.raises(ValueError, match="missing torch key"):
        jax_load(path)
    with pytest.raises(KeyError, match=re.escape(repr(port_key))):
        port_load(path)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_a_wrong_shape_raises_in_both(tmp_path, fmt):
    source, write, (key, _), jax_load, port_load = FORMATS[fmt]
    sd = dict(source())
    sd[key] = torch.zeros(sd[key].shape[0] + 1)
    path = str(tmp_path / "wrong.pt")
    write(path, sd)
    with pytest.raises(ValueError, match="shape"):
        jax_load(path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_load(path)
