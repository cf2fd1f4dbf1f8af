"""Rules the PyTorch/CUDA port keeps, checked on the CPU.

- No module of ``audiolab_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax``, ``flax`` or the JAX package (``audiolab_tpu``).
- The entry points default to the card and raise when there is none.
- The kernel wrappers take their plain versions for CPU tensors and leave
  their launch counters untouched.
- The CUDA sources exist, are built for sm_90a and export every entry.
- ``chip_smoke.py`` exits non-zero and prints no result without a card, in
  the repository and alone in a directory.
"""

import ast
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

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audiolab_tpu")


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


def test_new_entry_points_default_to_the_card(no_cuda):
    from audiolab_tpu_torch.models.separation.vr import VRConfig, make_vr_net
    from audiolab_tpu_torch.models.separation.vr_bands import VRSeparator
    from audiolab_tpu_torch.retrieval.index import FeatureIndex

    net = make_vr_net(VRConfig(n_fft=128, nout=8, nout_lstm=8))
    quiet = np.zeros((2, 4096), np.float32)
    for call in (lambda: FeatureIndex(np.zeros((4, 8), np.float32)),
                 lambda: VRSeparator(net),
                 lambda: TSep.vr_split(net, "1band_sr44100_hl512", TSep.KARAOKE),
                 lambda: TSep.dereverb(quiet, 44100),
                 lambda: TSep.spectral_gate_denoise(quiet, 44100),
                 lambda: TSep.hpss_split(quiet, 44100)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert FeatureIndex(np.zeros((4, 8), np.float32), device="cpu").device.type == "cpu"
    assert VRSeparator(net, device="cpu").device.type == "cpu"
