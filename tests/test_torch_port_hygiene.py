"""Rules the PyTorch/CUDA port keeps, checked on the CPU.

- No module of ``audiolab_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax``, ``flax``, ``optax``, ``orbax`` or the JAX package
  (``audiolab_tpu``).
- The entry points default to the card and raise when there is none.
- The kernel wrappers take their plain versions for CPU tensors and leave
  their launch counters untouched.
- The CUDA sources exist, are built for sm_90a and export every entry.
- ``chip_smoke.py`` exits non-zero and prints no result without a card, in
  the repository and alone in a directory.
"""

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiolab_tpu_torch.kernels import _build
from audiolab_tpu_torch.kernels import attention as TA
from audiolab_tpu_torch.kernels import norms as TN
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import rmvpe as TRm
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.pipelines import rvc as TP
from audiolab_tpu_torch.pipelines import separate as TSep
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "audiolab_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _port_sources() -> list[Path]:
    return sorted((ROOT / "audiolab_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_stem_separator_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSep.StemSeparator([])
    assert TSep.StemSeparator([], device="cpu").device.type == "cpu"


def test_voice_converter_defaults_to_the_card(no_cuda):
    synth = TSy.SynthesizerTrn(TSy.SynthesizerConfig(
        spec_channels=129, inter_channels=8, hidden_channels=8, filter_channels=16,
        n_layers=1, upsample_initial_channel=16, spk_embed_dim=2, gin_channels=8,
        feat_channels=16))
    hub = TH.HubertFeatureExtractor("v2", TH.HubertConfig(dim=16, ffn_dim=32, heads=2,
                                                         layers=1, final_dim=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.VoiceConverter(synth, hub)
    assert TP.VoiceConverter(synth, hub, TRm.RMVPE(dtype=None, en_de_layers=1, inter_layers=1,
                                                   n_blocks=1, en_out_channels=2,
                                                   gru_hidden=4),
                             device="cpu").device.type == "cpu"


def test_kernel_wrappers_on_cpu_take_the_plain_path():
    """CPU tensors never reach the CUDA libraries (there are none here) and
    leave every launch counter at 0; the results are the plain versions'."""
    TA.reset_launch_counts()
    TN.reset_launch_counts()
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    bf = torch.bfloat16
    q, k, v = t(1, 2, 62, 64, dtype=bf), t(1, 2, 62, 64, dtype=bf), t(1, 2, 62, 64, dtype=bf)
    assert torch.equal(TA.attention_nk1(q, k, v), TA.attention_nk1_reference(q, k, v, 0.125))
    assert torch.equal(TA.attention_nk1_core(q, k, v),
                       TA.attention_nk1_reference(q, k, v, 0.125))
    assert torch.equal(TA.flash_attention(q, k, v, block_k=62),
                       TA.attention_nk1_reference(q, k, v, 0.125))
    q, k, v = t(1, 2, 30, 64), t(1, 2, 70, 64), t(1, 2, 70, 64)
    assert torch.equal(TA.flash_attention_fwd(q, k, v, causal=True),
                       TA.flash_attention_reference(q, k, v, True, 0.125))
    assert torch.equal(TA.flash_attention(q, k, v, causal=True),
                       TA.flash_attention_reference(q, k, v, True, 0.125))
    q, k, v = t(1, 2, 62, 64, dtype=bf), t(1, 2, 62, 64, dtype=bf), t(1, 2, 62, 64, dtype=bf)
    cos, sin = TA.rope_tables(80, 64)
    assert torch.equal(TA.attention_nk1_rope(q, k, v, cos, sin),
                       TA.attention_nk1_rope_reference(q, k, v, cos, sin, 0.125))
    assert torch.equal(TA.flash_attention(q, k, v, rope_cos=cos, rope_sin=sin),
                       TA.attention_nk1_rope_reference(q, k, v, cos, sin, 0.125))
    for slim in (TA.slim_attention, TA.slim_attention_core):
        assert torch.equal(slim(q, k, v), TA.attention_nk1_reference(q, k, v, 0.125))
    qp, kp, vp = (x.transpose(1, 2).reshape(1, 62, 128) for x in (q, k, v))
    for packed in (TA.packed_attention, TA.packed_attention_core):
        assert torch.equal(packed(qp, kp, vp, 2, 64),
                           TA.packed_attention_reference(qp, kp, vp, 2, 64, 0.125))
    x, w, b = t(3, 96), t(96), t(96)
    assert torch.equal(TN.rms_norm(x, w), TN.rms_norm_reference(x, w))
    assert torch.equal(TN.layer_norm(x, w, b), TN.layer_norm_reference(x, w, b))
    assert all(f.launches == 0 for f in (
        TA.attention_nk1, TA.flash_attention_fwd, TA.attention_nk1_rope, TA.slim_attention,
        TA.packed_attention, TA.attention_nk1_core, TA.slim_attention_core,
        TA.packed_attention_core, TN.rms_norm, TN.layer_norm))
    assert all(f.sm90_launches == 0 for f in (
        TA.attention_nk1, TA.slim_attention, TA.packed_attention))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    f32 = torch.zeros(1, 1, 8, 64)
    with pytest.raises(TypeError):
        TA.attention_nk1(f32, f32, f32)             # K1 takes 16-bit inputs only
    with pytest.raises(ValueError):
        TA.flash_attention_fwd(f32, torch.zeros(1, 1, 8, 32), torch.zeros(1, 1, 8, 32))
    with pytest.raises(TypeError):
        TA.flash_attention_fwd(f32, f32, f32.double())


CUDA_ENTRIES = {
    "attention": ("k1_attention_nk1", "k1_attention_nk1_sm90", "k2_flash_attention",
                  "k2_flash_attention_sm90", "k3_attention_nk1_rope",
                  "k3_attention_nk1_rope_sm90", "k6_attention_slim", "k6_attention_slim_sm90",
                  "k7_attention_packed", "k7_attention_packed_sm90"),
    "norms": ("k4_rms_norm", "k5_layer_norm"),
}


def test_cuda_source_builds_for_sm90a():
    for name, entries in CUDA_ENTRIES.items():
        src = _build.CSRC / f"{name}.cu"
        assert src.is_file()
        cmd = _build.nvcc_command(src, Path(f"build/lib{name}.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-shared" in cmd and str(src) in cmd
        text = src.read_text()
        for entry in entries:
            assert f'extern "C" int {entry}(' in text, f"{name}.cu lacks {entry}"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_new_entry_points_default_to_the_card(no_cuda, tmp_path):
    from audiolab_tpu_torch import main as port_main
    from audiolab_tpu_torch.dsp.autotune import auto_tune_track, detect_key
    from audiolab_tpu_torch.dsp.reverb import apply_reverb, extract_reverb_params
    from audiolab_tpu_torch.dsp.silence import restore_silence
    from audiolab_tpu_torch.models.separation.vr import VRConfig, make_vr_net
    from audiolab_tpu_torch.models.separation.vr_bands import VRSeparator
    from audiolab_tpu_torch.pipelines.chain import run_chain
    from audiolab_tpu_torch.pipelines.processors.separate import dsp_vocal_split
    from audiolab_tpu_torch.retrieval.index import FeatureIndex
    from audiolab_tpu_torch.serve.api import create_app

    net = make_vr_net(VRConfig(n_fft=128, nout=8, nout_lstm=8))
    quiet = np.zeros((2, 4096), np.float32)
    params = {"sample_rate": 44100, "pre_delay": 0.0, "impulse_response": [1.0]}
    root = str(tmp_path / "process")
    for call in (lambda: FeatureIndex(np.zeros((4, 8), np.float32)),
                 lambda: VRSeparator(net),
                 lambda: TSep.vr_split(net, "1band_sr44100_hl512", TSep.KARAOKE),
                 lambda: TSep.dereverb(quiet, 44100),
                 lambda: TSep.spectral_gate_denoise(quiet, 44100),
                 lambda: TSep.hpss_split(quiet, 44100),
                 lambda: dsp_vocal_split(quiet, 44100),
                 lambda: restore_silence(quiet[0], quiet[0], 44100, 48000),
                 lambda: extract_reverb_params(quiet[0], quiet[0], 44100),
                 lambda: apply_reverb(quiet, params),
                 lambda: auto_tune_track(quiet[0], 44100),
                 lambda: detect_key(quiet[0], 44100),
                 lambda: run_chain(["Separate"], [], output_root=root),
                 lambda: create_app(root),
                 lambda: port_main.main(["--port", "0", "--output-root", root])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert create_app(root, device="cpu").routes
    assert FeatureIndex(np.zeros((4, 8), np.float32), device="cpu").device.type == "cpu"
    assert VRSeparator(net, device="cpu").device.type == "cpu"


LOADERS = ("load_roformer_checkpoint", "load_rvc_checkpoint", "load_rmvpe_checkpoint",
           "load_crepe_checkpoint", "load_htdemucs_checkpoint", "load_mdx23c_checkpoint",
           "load_vr_checkpoint", "load_audiosr_vocoder_checkpoint", "load_audiosr_vae_checkpoint",
           "load_audiosr_unet_checkpoint", "load_wav2vec2_checkpoint", "load_pyannet_checkpoint",
           "load_wespeaker_checkpoint", "load_rtla_crnn_checkpoint", "load_dac_checkpoint",
           "load_dia_checkpoint", "load_xtts_gpt_checkpoint", "load_xtts_conditioner_checkpoint",
           "load_xtts_perceiver_checkpoint", "load_xtts_hifigan_checkpoint",
           "load_xtts_speaker_checkpoint", "load_xtts_dvae_checkpoint",
           "load_openvoice_checkpoint", "load_chatterbox_pipeline", "load_t5_encoder",
           "load_sao_dit_checkpoint", "load_acestep_dit_checkpoint",
           "load_acestep_lyric_checkpoint", "load_dcae_checkpoint", "load_acestep_pipeline",
           "load_clap_text_checkpoint", "load_clap_audio_checkpoint", "load_vocos_checkpoint")


@pytest.mark.parametrize("name", LOADERS)
def test_checkpoint_loaders_default_to_the_card(no_cuda, tmp_path, name):
    """Each loader of a checkpoint file or directory (the chain's formats,
    those of Super Resolution, transcription, diarization and alignment, the
    speech and cloning engines' and the music models') builds on
    the card unless told otherwise: without one it raises before it reads
    the file (there is none here), and falls back neither to the CPU nor to
    random weights."""
    from audiolab_tpu_torch.models.dia import DiaConfig
    from audiolab_tpu_torch.models.separation.roformer import RoformerConfig
    from audiolab_tpu_torch.utils import convert

    args = {"load_roformer_checkpoint": (RoformerConfig(),),
            "load_dia_checkpoint": (DiaConfig(),)}.get(name, ())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(convert, name)(str(tmp_path / "absent.pth"), *args)
    with pytest.raises(FileNotFoundError):
        getattr(convert, name)(str(tmp_path / "absent.pth"), *args, device="cpu")


def test_training_entry_points_default_to_the_card(no_cuda, tmp_path):
    from audiolab_tpu_torch.train.data import RVCDataLoader, extract_features
    from audiolab_tpu_torch.train.rvc import create_train_state
    from audiolab_tpu_torch.train.rvc_train import train_from_request
    from audiolab_tpu_torch.train.trainer import build_index, train_rvc

    cfg = TSy.SynthesizerConfig(
        spec_channels=129, segment_size=960, inter_channels=8, hidden_channels=8,
        filter_channels=16, n_layers=1, upsample_initial_channel=16, spk_embed_dim=2,
        gin_channels=8, feat_channels=16)
    filelist = tmp_path / "filelist.json"
    filelist.write_text('[{"gt": "a.wav", "feat": "a.npy", "f0": "b.npy", "f0c": "c.npy"}]')
    (tmp_path / "feats").mkdir()
    np.save(tmp_path / "feats" / "a.npy", np.zeros((4, 8), np.float32))
    for call in (lambda: create_train_state(cfg, periods=(2,)),
                 lambda: train_rvc(str(tmp_path)),
                 lambda: train_from_request([str(tmp_path / "a.wav")], "v",
                                            str(tmp_path / "models"), {}),
                 lambda: RVCDataLoader(str(filelist)),
                 lambda: extract_features(str(tmp_path), None),
                 lambda: build_index(str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    state, _, _ = create_train_state(cfg, periods=(2,), device="cpu")
    assert next(state.gen.parameters()).device.type == "cpu"
    assert RVCDataLoader(str(filelist), device="cpu").device.type == "cpu"


def test_tts_entry_points_default_to_the_card(no_cuda):
    from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder
    from audiolab_tpu_torch.models.zonos import ZonosConfig, ZonosModel, generate
    from audiolab_tpu_torch.pipelines.tts import ZonosTTS, random_zonos

    cfg = ZonosConfig(dim=16, n_layers=2, attn_every=2, n_heads=2, d_state=2, n_codebooks=2,
                      codebook_size=10, spk_dim=4)
    model = ZonosModel(cfg)
    dac = DACDecoder(DACConfig(dim=8, rates=(2, 2), n_q=2, codebook_size=10))
    for call in (lambda: ZonosTTS(model, dac), lambda: random_zonos(),
                 lambda: generate(model, np.ones((1, 3), np.int32), np.zeros((1, 4)),
                                  max_frames=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ZonosTTS(model, dac, device="cpu").device.type == "cpu"
    assert random_zonos(cfg, device="cpu").device.type == "cpu"
    codes = generate(model, np.ones((1, 3), np.int32), np.zeros((1, 4)), max_frames=2,
                     device="cpu")
    assert codes.shape == (1, 2, 2) and codes.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA graph"):
        generate(model, np.ones((1, 3), np.int32), np.zeros((1, 4)), max_frames=2,
                 device="cpu", graph=True)


def test_processor_registry_entry_points_default_to_the_card(no_cuda, tmp_path):
    """This slice's entry points: the OpenVoice cloner, the CREPE predictor,
    the neural diarizer, the streaming converter (through its
    VoiceConverter), the processors' functions and each new processor's
    run_chain raise without a card and run on the CPU when asked."""
    from audiolab_tpu_torch.dsp.harmony import recreate_harmonies
    from audiolab_tpu_torch.models.crepe import CrepePredictor
    from audiolab_tpu_torch.models.diarize import DiarizeConfig, NeuralDiarizer
    from audiolab_tpu_torch.models.openvoice import ToneColorConfig, ToneColorConverter
    from audiolab_tpu_torch.pipelines.chain import run_chain
    from audiolab_tpu_torch.pipelines.cloning import OpenVoiceCloner, neural_diarize
    from audiolab_tpu_torch.pipelines.processors.compare import compare_tracks
    from audiolab_tpu_torch.pipelines.processors.remaster import matchering_master
    from audiolab_tpu_torch.pipelines.rvc_stream import StreamingVC
    from audiolab_tpu_torch.pipelines.super_res import super_resolve

    ov = ToneColorConverter(ToneColorConfig(spec_channels=33, n_fft=64, hop=16,
                                            inter_channels=4, hidden_channels=4,
                                            gin_channels=8, upsample_rates=(4, 4),
                                            upsample_kernel_sizes=(8, 8),
                                            upsample_initial_channel=8))
    synth = TSy.SynthesizerTrn(TSy.SynthesizerConfig(
        spec_channels=129, inter_channels=8, hidden_channels=8, filter_channels=16,
        n_layers=1, upsample_initial_channel=16, spk_embed_dim=2, gin_channels=8,
        feat_channels=16))
    hub = TH.HubertFeatureExtractor("v2", TH.HubertConfig(dim=16, ffn_dim=32, heads=2,
                                                         layers=1, final_dim=8))
    x = np.zeros((2, 8000), np.float32)
    dcfg = DiarizeConfig(n_mels=16, hidden=8, emb_dim=4)
    root = str(tmp_path / "process")
    for call in (lambda: OpenVoiceCloner(ov),
                 lambda: CrepePredictor(model="tiny"),
                 lambda: NeuralDiarizer(dcfg),
                 lambda: neural_diarize(x[0], 16000),
                 lambda: StreamingVC(TP.VoiceConverter(synth, hub)),
                 lambda: compare_tracks(x, x, 16000, str(tmp_path / "c.png")),
                 lambda: matchering_master(x, x, 16000),
                 lambda: super_resolve(x, 16000),
                 lambda: recreate_harmonies(x, x, 16000),
                 *(lambda t=t: run_chain([t], [], output_root=root)
                   for t in ("Remaster", "Super Resolution", "Convert", "Compare"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert OpenVoiceCloner(ov, device="cpu").device.type == "cpu"
    assert CrepePredictor(model="tiny", device="cpu").device.type == "cpu"
    assert NeuralDiarizer(dcfg, device="cpu").device.type == "cpu"
    vc = TP.VoiceConverter(synth, hub, device="cpu")
    assert StreamingVC(vc).vc.device.type == "cpu"


def test_speech_engines_default_to_the_card(no_cuda):
    """Dia, the capability XTTS and the XTTS-v2 stack default to the card and
    raise without one; each builds on the CPU when asked."""
    from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder
    from audiolab_tpu_torch.models.dia import DiaConfig, DiaModel
    from audiolab_tpu_torch.models.dia import generate as dia_generate
    from audiolab_tpu_torch.models.xtts import XTTS, XTTSConfig, XttsGPT2, xtts_gpt2_generate
    from audiolab_tpu_torch.pipelines.tts import (
        DiaTTSEngine,
        XttsCheckpointEngine,
        random_xtts,
        random_xtts_checkpoint,
    )

    dia = DiaModel(DiaConfig(dim_enc=8, dim_dec=8, n_layers_enc=1, n_layers_dec=1, n_heads=2,
                             n_codebooks=2, codebook_size=8, max_audio_len=16))
    dac = DACDecoder(DACConfig(dim=8, rates=(2, 2), n_q=2, codebook_size=8))
    xcfg = XTTSConfig(dim=16, n_layers=1, n_heads=2, cond_latents=2, n_codes=8, max_seq_len=32)
    gpt = XttsGPT2(layers=1, dim=8, heads=2, n_text=10, n_audio=8, max_text=8, max_mel=8)
    for call in (lambda: DiaTTSEngine(dia, dac), lambda: random_xtts(),
                 lambda: random_xtts_checkpoint(), lambda: XTTS.random_init(xcfg),
                 lambda: dia_generate(dia, np.ones((1, 3), np.int32), max_frames=2),
                 lambda: xtts_gpt2_generate(gpt, np.ones((1, 2), np.int32),
                                            np.zeros((1, 1, 8), np.float32), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert DiaTTSEngine(dia, dac, device="cpu").device.type == "cpu"
    assert random_xtts(device="cpu").model.device.type == "cpu"
    eng = random_xtts_checkpoint(device="cpu")
    assert isinstance(eng, XttsCheckpointEngine) and eng.device.type == "cpu"
    assert XTTS.random_init(xcfg, device="cpu").device.type == "cpu"
    codes = dia_generate(dia, np.ones((1, 3), np.int32), max_frames=2, device="cpu")
    assert codes.shape == (1, 2, 2)
    with pytest.raises(ValueError, match="CUDA graph"):
        dia_generate(dia, np.ones((1, 3), np.int32), max_frames=2, device="cpu", graph=True)


def test_chatterbox_and_wespeaker_entry_points_default_to_the_card(no_cuda):
    """random_chatterbox, ChatterboxCheckpointEngine, t3_generate and
    NeuralDiarizer with the wespeaker back end default to the card and raise
    without one; each builds (and t3_generate decodes) on the CPU when
    asked."""
    from audiolab_tpu_torch.models.chatterbox_s3gen import FlowConfig, HiFTConfig, S3Token2Wav
    from audiolab_tpu_torch.models.chatterbox_t3 import T3, T3CkptConfig, t3_generate
    from audiolab_tpu_torch.models.diarize import DiarizeConfig, NeuralDiarizer
    from audiolab_tpu_torch.models.wespeaker import WeSpeakerConfig, WeSpeakerResNet
    from audiolab_tpu_torch.pipelines.tts import ChatterboxCheckpointEngine, random_chatterbox

    t3 = T3(T3CkptConfig(text_vocab=12, speech_vocab=10, dim=16, n_layers=1, n_heads=2,
                         ffn_dim=16, max_text_tokens=8, max_speech_tokens=8,
                         speaker_embed_size=4, perceiver_tokens=2, perceiver_heads=2,
                         start_text_token=10, start_speech_token=8, stop_speech_token=9))
    s3gen = S3Token2Wav(FlowConfig(token_vocab=8, dim=16, mel_dim=4, xvector_dim=4, heads=2,
                                   ffn_dim=16, n_layers=1, n_up_layers=1, est_channels=8,
                                   est_mid_blocks=1, est_n_blocks=1, est_heads=2,
                                   est_head_dim=4, n_timesteps=1),
                        HiFTConfig(in_channels=4, base_channels=8, f0_cond_channels=4))
    ws = WeSpeakerResNet(WeSpeakerConfig(feat_dim=16, embed_dim=4, m_channels=2,
                                         num_blocks=(1, 1, 1, 1)))
    dcfg = DiarizeConfig(n_mels=16, hidden=8, emb_dim=4)
    for call in (lambda: random_chatterbox(), lambda: ChatterboxCheckpointEngine(t3, s3gen),
                 lambda: t3_generate(t3, np.ones((1, 3), np.int64), np.zeros(4, np.float32),
                                     max_new_tokens=2),
                 lambda: NeuralDiarizer(dcfg, wespeaker=ws)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = random_chatterbox(device="cpu")
    assert isinstance(eng, ChatterboxCheckpointEngine) and eng.device.type == "cpu"
    assert ChatterboxCheckpointEngine(t3, s3gen, device="cpu").device.type == "cpu"
    assert NeuralDiarizer(dcfg, wespeaker=ws, device="cpu").wespeaker is ws
    codes = t3_generate(t3, np.ones((1, 3), np.int64), np.zeros(4, np.float32),
                        max_new_tokens=2, device="cpu")
    assert codes.dtype == np.int32 and codes.shape[1] <= 3


def test_listening_entry_points_default_to_the_card(no_cuda):
    """Transcriber, transcribe_window, random_transcriber, CTCWordAligner,
    random_ctc_aligner, pyannet_vad, NeuralDiarizer with the PyanNet back
    end, phoneme_features, chroma_features and align_take default to the
    card and raise without one; each runs on the CPU when asked."""
    from audiolab_tpu_torch.models.diarize import DiarizeConfig, NeuralDiarizer
    from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
    from audiolab_tpu_torch.models.rtla import (
        RtlaCRNN,
        RtlaCRNNConfig,
        chroma_features,
        phoneme_features,
    )
    from audiolab_tpu_torch.models.wav2vec2 import (
        CTCWordAligner,
        Wav2Vec2Config,
        Wav2Vec2CTC,
        random_ctc_aligner,
    )
    from audiolab_tpu_torch.models.whisper import WhisperConfig, WhisperModel, transcribe_window
    from audiolab_tpu_torch.pipelines.align import align_take
    from audiolab_tpu_torch.pipelines.transcribe import (
        Transcriber,
        pyannet_vad,
        random_transcriber,
    )

    whisper = WhisperModel(WhisperConfig(n_mels=8, dim=8, n_heads=2, n_audio_layers=1,
                                         n_text_layers=1, vocab_size=16, n_text_ctx=8, sot=10,
                                         eot=9, no_timestamps=11, timestamp_base=12))
    w2v = Wav2Vec2CTC(Wav2Vec2Config(encoder=TH.HubertConfig(dim=16, ffn_dim=32, heads=2,
                                                             layers=1)))
    pcfg = PyanNetConfig(lstm_hidden=4, lstm_layers=1, linear_dim=4)
    pyan = PyanNet(pcfg)
    rtla = RtlaCRNN(RtlaCRNNConfig(num_lbl=4, model_complexity=1))
    dcfg = DiarizeConfig(n_mels=16, hidden=8, emb_dim=4)
    x = np.zeros(16000, np.float32)
    words = [{"word": "a", "start": 0.1, "end": 0.5}]
    for call in (lambda: Transcriber(whisper), lambda: random_transcriber(),
                 lambda: transcribe_window(whisper, np.zeros((1, 3000, 8), np.float32), 2),
                 lambda: CTCWordAligner(w2v), lambda: random_ctc_aligner(),
                 lambda: pyannet_vad(pyan),
                 lambda: NeuralDiarizer(dcfg, pyannet_params=pyan.state_dict(),
                                        pyannet_cfg=pcfg),
                 lambda: phoneme_features(x, 16000, rtla), lambda: chroma_features(x, 16000),
                 lambda: align_take(x, x, 16000, words, words)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Transcriber(whisper, device="cpu").device.type == "cpu"
    assert random_transcriber(device="cpu").model.encoder.conv1.weight.std() > 0
    toks = transcribe_window(whisper, np.zeros((1, 3000, 8), np.float32), 2, device="cpu")
    assert toks.shape == (1, 2)
    with pytest.raises(ValueError, match="CUDA graph"):
        transcribe_window(whisper, np.zeros((1, 3000, 8), np.float32), 2, device="cpu",
                          graph=True)
    assert CTCWordAligner(w2v, device="cpu").device.type == "cpu"
    assert random_ctc_aligner(device="cpu").model.lm_head.weight.device.type == "cpu"
    assert isinstance(pyannet_vad(pyan, device="cpu")(x, 16000), list)
    d = NeuralDiarizer(dcfg, pyannet_params=pyan.state_dict(), pyannet_cfg=pcfg, device="cpu")
    assert d.pyannet is not None and d.device.type == "cpu"
    assert phoneme_features(x, 16000, rtla, device="cpu").shape[0] == 4
    assert chroma_features(x, 16000, device="cpu").shape[1] == 12
    assert align_take(x, x, 16000, words, words, device="cpu")[0].shape == x.shape


def test_diffusion_entry_points_default_to_the_card(no_cuda, tmp_path):
    """train_model, generate, load_ema, train_superres and load_enhancer
    default to the card and raise without one; each runs on the CPU when
    asked (a two-step training of a tiny WaveGrad, then the loaders)."""
    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.models.wavegrad import WaveGradConfig
    from audiolab_tpu_torch.train import super_res as SRT
    from audiolab_tpu_torch.train import wavetransfer as WT

    mc = WaveGradConfig(n_mels=8, hop=12, factors=(3, 2, 2), ublock_ch=(8, 8, 8),
                        dblock_ch=(4, 8), base_ch=4)
    wt = WT.WTConfig(sr=8000, n_mels=8, seg_frames=48, batch_size=2, steps=2, ckpt_every=2,
                     model=mc)
    cfg = SRT.SRTrainConfig(wt=wt, cutoff_lo_hz=800.0, cutoff_hi_hz=1500.0)
    write_wav(tmp_path / "a.wav", 0.1 * np.sin(np.arange(4000) * 0.3).astype(np.float32), 8000)
    ckpt = str(tmp_path / "ckpt")
    for call in (lambda: WT.train_model(str(tmp_path), wt), lambda: WT.load_ema(ckpt, mc),
                 lambda: WT.generate(str(tmp_path), np.zeros(800, np.float32), 8000, wt),
                 lambda: SRT.train_superres(str(tmp_path), cfg),
                 lambda: SRT.load_enhancer(str(tmp_path), cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert SRT.train_superres(str(tmp_path), cfg, device="cpu")["steps"] == 2
    assert next(WT.load_ema(ckpt, mc, device="cpu").parameters()).device.type == "cpu"
    y, sr = WT.generate(str(tmp_path), np.zeros(800, np.float32), 8000, wt, device="cpu")
    assert sr == 8000 and y.shape == (800,)
    out = SRT.load_enhancer(str(tmp_path), cfg, device="cpu")(torch.zeros(1, 2, 600))
    assert out.shape == (1, 2, 600)


def test_music_entry_points_default_to_the_card(no_cuda, tmp_path):
    """generate_audio, the Stable Audio pipelines, ACE-Step's pipeline and
    the random demo backends default to the card and raise without one;
    each runs on the CPU when asked."""
    from audiolab_tpu_torch.models.dit import DiTConfig
    from audiolab_tpu_torch.models.stable_audio import (
        OobleckConfig,
        StableAudioConfig,
        StableAudioModel,
        generate_audio,
    )
    from audiolab_tpu_torch.models.stable_audio_dit import OobleckConfig as CkptVAE
    from audiolab_tpu_torch.models.stable_audio_dit import SAODiTConfig
    from audiolab_tpu_torch.models.t5 import T5Config
    from audiolab_tpu_torch.pipelines.acestep import ACEStepPipeline, random_acestep
    from audiolab_tpu_torch.pipelines.music import (
        StableAudioPipeline,
        random_stable_audio,
        random_stable_audio_checkpoint,
    )
    from audiolab_tpu_torch.utils.spm import build_model_proto

    spm = tmp_path / "t5.model"
    spm.write_bytes(build_model_proto([("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
                                       ("▁a", -1.0, 1)], unk_id=2, bos_id=-1, eos_id=1,
                                      pad_id=0))
    cfg = StableAudioConfig(sr=4000, max_seconds=2.0,
                            vae=OobleckConfig(channels=1, latent_dim=4, base_ch=4, ratios=(2, 2)),
                            dit=DiTConfig(dim=16, n_layers=1, n_heads=2, cond_dim=16, in_dim=4,
                                          out_dim=4, dtype="float32"),
                            text_dim=16, text_layers=1)
    model = StableAudioModel(cfg)
    ckpt = dict(dit_cfg=SAODiTConfig(io_channels=4, embed_dim=64, depth=1, num_heads=4,
                                     cond_token_dim=16, global_cond_dim=32),
                vae_cfg=CkptVAE(out_channels=1, channels=2, latent_dim=4, c_mults=(1, 2),
                                strides=(16, 16)),
                t5_cfg=T5Config(vocab_size=8, dim=16, d_kv=8, heads=2, d_ff=16, layers=1))
    for call in (lambda: generate_audio(model, "a", steps=1), lambda: StableAudioPipeline(model),
                 random_stable_audio, random_acestep,
                 lambda: random_stable_audio_checkpoint(str(spm), **ckpt)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    y, sr = random_stable_audio(device="cpu").generate("a", seconds_total=1.0, steps=1)
    assert sr == 16000 and y.shape == (16000,) and np.isfinite(y).all()
    pipe = random_stable_audio_checkpoint(str(spm), device="cpu", **ckpt)
    y, sr = pipe.generate("a", seconds_total=1.0, steps=2)
    assert sr == 44100 and y.shape == (pipe.latent_frames(1.0) * 256,) and np.isfinite(y).all()
    ace = random_acestep(device="cpu")
    assert isinstance(ace, ACEStepPipeline) and ace.device.type == "cpu"
    assert np.isfinite(ace.generate("a", duration=1.0, infer_step=1)[0]).all()


def test_checkpoint_music_entry_points_default_to_the_card(no_cuda, tmp_path):
    """The checkpoint ACE-Step pipeline, its random factory and its text
    encoder default to the card and raise without one (``train_lora`` runs
    on its pipeline's device); each runs on the CPU when asked."""
    from audiolab_tpu_torch.models.acestep_dit import ACEStepDiT, ACEStepDiTConfig
    from audiolab_tpu_torch.models.t5 import T5Config, T5Encoder
    from audiolab_tpu_torch.pipelines.acestep import (
        ACEStepTextEncoder,
        CheckpointACEStep,
        random_checkpoint_acestep,
    )
    from audiolab_tpu_torch.utils.spm import build_model_proto

    spm = tmp_path / "umt5.model"
    spm.write_bytes(build_model_proto([("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
                                       ("▁a", -1.0, 1)], unk_id=2, bos_id=-1, eos_id=1,
                                      pad_id=0))
    t5 = T5Encoder(T5Config(vocab_size=8, dim=16, d_kv=8, heads=2, d_ff=16, layers=1))
    dit = ACEStepDiT(ACEStepDiTConfig(num_layers=1, num_attention_heads=2, attention_head_dim=8,
                                      in_channels=2, out_channels=2, patch_height=4,
                                      lyric_hidden_size=16, ssl_latent_dims=()))
    for call in (random_checkpoint_acestep, lambda: CheckpointACEStep(dit),
                 lambda: ACEStepTextEncoder(t5, str(spm))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    pipe = random_checkpoint_acestep(device="cpu")
    pipe.pcfg.steps = 2
    lat = pipe.generate(torch.zeros(1, 3, 8), torch.ones(1, 3, dtype=torch.long),
                        torch.zeros(1, 8), duration=2.0)
    assert pipe.device.type == "cpu" and lat.shape == (1, 2, 4, 4) and torch.isfinite(lat).all()
    hidden, mask = ACEStepTextEncoder(t5, str(spm), device="cpu")(["a a"])
    assert hidden.shape == (1, 3, 16) and mask.tolist() == [[1, 1, 1]]


def test_music_state_loaders_and_stable_audio_pipeline_default_to_the_card(no_cuda, tmp_path):
    """The music models' ``load_*_state`` functions load in place on the
    module's device (the CPU here, with no card) and move nothing, and
    ``load_stable_audio_pipeline`` raises without a card before it reads
    its files, and ``FileNotFoundError`` on the CPU for absent ones."""
    from audiolab_tpu_torch.models.acestep_dit import (
        ACEStepDiT,
        ACEStepDiTConfig,
        LyricConformerEncoder,
    )
    from audiolab_tpu_torch.models.adamos_vocoder import AdamosConfig, AdamosVocoder
    from audiolab_tpu_torch.models.stable_audio import NumberEmbedder
    from audiolab_tpu_torch.models.stable_audio_dit import (
        OobleckConfig,
        OobleckDecoder,
        SAODiTConfig,
        StableAudioDiT,
    )
    from audiolab_tpu_torch.utils import convert

    def make():
        return (NumberEmbedder(features=8),
                OobleckDecoder(OobleckConfig(out_channels=1, channels=2, latent_dim=4,
                                             c_mults=(1, 2), strides=(2, 2))),
                AdamosVocoder(AdamosConfig(input_channels=4, depths=(1,), dims=(4,),
                                           upsample_rates=(2,), upsample_kernel_sizes=(4,),
                                           resblock_kernel_sizes=(3,),
                                           resblock_dilation_sizes=((1,),), num_mels=4,
                                           upsample_initial_channel=4)),
                StableAudioDiT(SAODiTConfig(io_channels=4, embed_dim=64, depth=1, num_heads=4,
                                            cond_token_dim=16, global_cond_dim=32)),
                ACEStepDiT(ACEStepDiTConfig(num_layers=1, num_attention_heads=2,
                                            attention_head_dim=8, in_channels=2,
                                            out_channels=2, patch_height=4,
                                            lyric_hidden_size=16, ssl_latent_dims=())),
                LyricConformerEncoder(dim=8, heads=2, ffn_dim=8, num_blocks=1))

    src = make()
    prefixes = ("conditioner.conditioners.seconds_start.embedder.", "pretransform.model.decoder.",
                "vocoder.", "model.model.", "model.", "lyric_encoder.")
    loads = (lambda m, sd: convert.load_sao_number_state(m, sd, "seconds_start"),
             convert.load_oobleck_state, convert.load_adamos_state, convert.load_sao_dit_state,
             convert.load_acestep_dit_state, convert.load_acestep_lyric_state)
    for module, prefix, load, want in zip(make(), prefixes, loads, src):
        got = load(module, {f"{prefix}{k}": v for k, v in want.state_dict().items()})
        assert got is module
        for k, v in got.state_dict().items():
            assert v.device.type == "cpu" and torch.equal(v, want.state_dict()[k]), k
    paths = [str(tmp_path / n) for n in ("model.safetensors", "t5.safetensors", "spiece.model")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_stable_audio_pipeline(*paths)
    with pytest.raises(FileNotFoundError):
        convert.load_stable_audio_pipeline(*paths, device="cpu")


def test_yue_entry_points_default_to_the_card(no_cuda, tmp_path):
    """random_yue, YuEPipeline, both stages' generate functions and the
    checkpoint loaders (load_llama_checkpoint, load_xcodec_checkpoint,
    load_yue_pipeline) default to the card and raise without one; each runs
    on the CPU when asked."""
    from audiolab_tpu_torch.models.codecs import XCodecConfig, XCodecDecoder
    from audiolab_tpu_torch.models.lm import LMConfig
    from audiolab_tpu_torch.models.yue import (
        YuEPipeline,
        random_yue,
        stage1_generate,
        stage2_generate,
    )
    from audiolab_tpu_torch.utils.convert import (
        load_llama_checkpoint,
        load_xcodec_checkpoint,
        load_yue_pipeline,
    )

    pipe = random_yue(device="cpu")
    prompt, vf = pipe._prompt("pop", "la")
    v = pipe.cfg.vocab
    cfg = LMConfig(vocab_size=8, dim=8, n_layers=1, n_heads=2, ffn_dim=8)
    llama = tmp_path / "lm.pth"
    torch.save(pipe.s1.state_dict(), llama)
    xc = XCodecConfig(n_q=1, codebook_size=4, dim=4, acoustic_dim=2, decoder_dim=4, rates=(2,))
    xpath = tmp_path / "x.pth"
    torch.save({"state_dict": XCodecDecoder(xc).state_dict()}, xpath)
    for call in (random_yue, lambda: YuEPipeline(pipe.cfg, pipe.s1, pipe.s2, pipe.codec),
                 lambda: stage1_generate(pipe.s1, prompt, 2, v, valid_from=vf),
                 lambda: stage2_generate(pipe.s2, np.zeros((1, 3), np.int64), v, n_q=2, block=4),
                 lambda: load_llama_checkpoint(str(llama), cfg),
                 lambda: load_xcodec_checkpoint(str(xpath), xc),
                 lambda: load_yue_pipeline("s1", "s2", str(xpath))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="CUDA graph needs the card"):
        stage1_generate(pipe.s1, prompt, 2, v, valid_from=vf, device="cpu", graph=True)
    y, sr = pipe.generate("pop", lyrics="la", seconds_per_segment=0.1)
    assert sr == 16000 and y.shape == (5 * 8,) and np.isfinite(y).all()
    codes = stage1_generate(pipe.s1, prompt, 2, v, valid_from=vf, device="cpu")
    assert codes.shape == (2, 2) and codes.device.type == "cpu"
    assert stage2_generate(pipe.s2, codes, v, n_q=2, block=4, device="cpu").shape == (2, 2, 2)
    lm = load_llama_checkpoint(str(llama), pipe.cfg.stage1, device="cpu")
    assert next(lm.parameters()).device.type == "cpu"
    dec = load_xcodec_checkpoint(str(xpath), xc, device="cpu")
    assert dec(torch.zeros(1, 1, 3, dtype=torch.long)).shape == (1, 6)


def test_parallel_and_export_entry_points_default_to_the_card(no_cuda, monkeypatch, tmp_path):
    """``export_rvc_synthesizer``, the dry run's ``entry``, ``local_mesh``,
    ``get_mesh`` outside a process group and ``StemSeparator`` under such a
    mesh raise without a card, and run on the CPU when asked;
    ``dryrun_multichip`` under NCCL raises with fewer cards than ranks,
    before it starts any."""
    from audiolab_tpu_torch import dryrun
    from audiolab_tpu_torch.core import distributed as TDist
    from audiolab_tpu_torch.core.mesh import get_mesh, local_mesh
    from audiolab_tpu_torch.pipelines.separate import StemSeparator
    from audiolab_tpu_torch.utils.export import export_rvc_synthesizer

    cfg = TSy.SynthesizerConfig(
        spec_channels=129, inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
        n_layers=1, upsample_initial_channel=16, spk_embed_dim=2, gin_channels=8,
        feat_channels=16)
    synth = TSy.SynthesizerTrn(cfg)
    for call in (lambda: export_rvc_synthesizer(synth, cfg, str(tmp_path / "a.pt2")),
                 dryrun.entry, lambda: dryrun.dryrun_multichip(2), lambda: local_mesh(2),
                 get_mesh, lambda: StemSeparator([], mesh=local_mesh(2)),
                 lambda: StemSeparator([], mesh=get_mesh())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Path(export_rvc_synthesizer(synth.state_dict(), cfg, str(tmp_path / "b.pt2"),
                                       frames=4, device="cpu")).exists()
    cpu = StemSeparator([], mesh=local_mesh(1, device="cpu"))
    assert cpu.device.type == "cpu" and get_mesh(device="cpu").devices[0].type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(TDist, "run_ranks", lambda *a, **k: pytest.fail("ranks started"))
    with pytest.raises(RuntimeError, match="NCCL takes one rank per card"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="NCCL takes one rank per card"):
        TDist.init_distributed(num_processes=2, process_id=1, init_method="file:///dev/null",
                               device="cuda")


# a "file:line" the kernels line cites as the TPU kernel a port replaces
CITATION = re.compile(r"^audiolab_tpu/[\w/]+\.py:\d+$")


def _jax_package_paths(path: Path) -> list[str]:
    """The string constants of a module (docstrings aside) that name a path
    under ``audiolab_tpu/``, and the ``"audiolab_tpu"`` components it joins
    into a path (``/`` or a ``join`` call)."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))

    def component(n) -> bool:
        return isinstance(n, ast.Constant) and n.value in ("audiolab_tpu", "audiolab_tpu/")

    bad = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
           and isinstance(n.value, str) and id(n) not in docs and "audiolab_tpu/" in n.value
           and not CITATION.match(n.value)]
    for n in ast.walk(tree):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div) and (
                component(n.left) or component(n.right)):
            bad.append(ast.unparse(n))
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr in ("join", "joinpath") and any(map(component, n.args))):
            bad.append(ast.unparse(n))
    return bad


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_path_of_the_jax_package(path):
    """No code of the port (docstrings aside) names a path under
    ``audiolab_tpu/``: the port builds and reads its own files (the native
    library's sources among them)."""
    bad = _jax_package_paths(path)
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"
