"""The port's host utilities on the CPU: ``utils/export.py`` (the exported
synthesizer against the eager ``infer`` bit for bit, and against the JAX
package's exported program at the synthesizer's parity tolerance, 1e-5),
``utils/profiling.py`` (after tests/test_profiling_ui.py, and a profiler
trace written to disk), ``utils/download.py`` (``file://`` URLs: both
packages give the same names and bytes) and ``native`` (the port's own
library, built here with g++, against the port's numpy paths: the WAV
decode bit for bit, the resampler against scipy as tests/test_native.py
holds it, levels, hash64, and the WORLD oracle against ``dsp/f0.py`` at
tests/test_f0_world.py's bounds; four processes building it at once).
Every native case needs the port's library, never the JAX package's."""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from audiolab_tpu.utils import download as JDl
from audiolab_tpu.utils import export as JEx
from audiolab_tpu_torch import native
from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
from audiolab_tpu_torch.dsp.f0 import f0_dio, f0_harvest, stonemask
from audiolab_tpu_torch.utils import download as TDl
from audiolab_tpu_torch.utils import export as TEx
from audiolab_tpu_torch.utils import profiling as TProf
from tests import torch_port_tiny as tiny
from tests.test_f0_world import HOP, SR, _speechlike
from tests.test_train import tiny_cfg
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 20


# ------------------------------------------------------------ export

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both packages' exported synthesizers (the same seeded weights,
    tests/torch_port_tiny.py ``train_pair``) on 1 x 20 frames, run on the
    same inputs, with the port's eager ``infer``."""
    work = tmp_path_factory.mktemp("export")
    gp, _dp, tg, _td = tiny.train_pair((2, 3))
    tg = tg.eval()
    # the JAX export compiles in a thread while the port's traces
    jax_export = threading.Thread(target=JEx.export_rvc_synthesizer, args=(
        gp, tiny_cfg(), str(work / "rvc.stablehlo")), kwargs={"frames": FRAMES})
    jax_export.start()
    TEx.export_rvc_synthesizer(tg, tg.cfg, str(work / "rvc.pt2"), frames=FRAMES, device="cpu")
    jax_export.join()
    rng = np.random.default_rng(7)
    phone = rng.standard_normal((1, FRAMES, 32)).astype(np.float32)
    f0 = np.where(rng.uniform(size=(1, FRAMES)) > 0.3, rng.uniform(100, 400, (1, FRAMES)),
                  0.0).astype(np.float32)
    pitch = rng.integers(1, 255, (1, FRAMES))
    lengths, sid = np.array([FRAMES]), np.array([0])
    args = [torch.from_numpy(phone), torch.from_numpy(lengths).long(),
            torch.from_numpy(pitch).long(), torch.from_numpy(f0), torch.from_numpy(sid).long()]
    with torch.no_grad():
        got = TEx.load_program(str(work / "rvc.pt2"))(*args)
        eager = tg.infer(*args, None)
    want = JEx.load_stablehlo(str(work / "rvc.stablehlo"))(
        gp, jnp.asarray(phone), jnp.asarray(lengths, jnp.int32), jnp.asarray(pitch, jnp.int32),
        jnp.asarray(f0), jnp.asarray(sid, jnp.int32))
    return got.numpy(), eager.numpy(), np.asarray(want)


def test_exported_synthesizer_equals_eager_infer(exported):
    got, eager, _ = exported
    assert got.shape == (1, FRAMES * 480)
    np.testing.assert_array_equal(got, eager)


def test_exported_synthesizer_matches_jax_export(exported):
    got, _, want = exported
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_export_program_of_a_function(tmp_path):
    """A plain function's tensors are captured as constants; the program
    takes the example's shapes."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32))
    path = TEx.export_program(lambda x: torch.tanh(x @ w), (torch.zeros(2, 4),),
                              str(tmp_path / "f.pt2"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(TEx.load_program(path)(x).numpy(),
                                      torch.tanh(x @ w).numpy())


# ------------------------------------------------------------ profiling

def test_stage_timer():
    t = TProf.StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("b", sync={"x": [torch.ones(4) * 2], "n": 3}):
        pass
    assert t.seconds["a"] >= 0.01
    assert t.counts["a"] == 1 and t.counts["b"] == 1
    assert "a:" in t.report() and t.report().startswith("total ")
    assert set(t.as_dict()) == {"a", "b"}


def test_epoch_recorder():
    r = TProf.EpochRecorder()
    msg = r.record()
    assert msg.startswith("elapsed ") and "| epoch time " in msg


def test_timed_decorator_and_global_report(monkeypatch):
    """The label's seconds go to the module's timer; a result without a
    CUDA tensor needs no sync (and none is attempted)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))

    @TProf.timed("port_unit_test_fn")
    def fn(x):
        return torch.as_tensor(x) + 1, "label"

    out, _ = fn(1)
    assert int(out) == 2
    assert TProf._GLOBAL.counts["port_unit_test_fn"] == 1
    assert "port_unit_test_fn:" in TProf.global_report()
    assert synced == []


def test_trace_writes_a_profiler_trace(tmp_path):
    x = torch.ones(64, 64)
    with TProf.trace(str(tmp_path / "trace")) as logdir:
        (x @ x).sum()
    files = list(Path(logdir).glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names


# ------------------------------------------------------------ download

def test_download_files_from_file_urls(tmp_path):
    """Both packages fetch the same ``file://`` URLs to the same names and
    bytes, and report each to the callback."""
    src = tmp_path / "src"
    src.mkdir()
    payloads = {"a.wav": b"RIFF0000WAVE", "b.bin": bytes(range(256))}
    for name, data in payloads.items():
        (src / name).write_bytes(data)
    urls = [(src / "a.wav").as_uri(), (src / "b.bin").as_uri()]
    seen = []
    got = TDl.download_files(urls, str(tmp_path / "port"), callback=lambda *a: seen.append(a))
    want = JDl.download_files(urls, str(tmp_path / "jax"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == ["a.wav", "b.bin"]
    for p, q in zip(got, want):
        assert Path(p).read_bytes() == Path(q).read_bytes() == payloads[Path(p).name]
    assert [a[0] for a in seen] == [0, 1] and all(a[2] == 2 for a in seen)


# ------------------------------------------------------------ native

@pytest.fixture(scope="module")
def lib():
    assert native.available(), native.unavailable_reason()
    assert native.library_path().parent == ROOT / "build" / "native"
    return native


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "pcm32", "float32"])
def test_wav_decode_equals_the_numpy_decoder(lib, kind, tmp_path, monkeypatch):
    """``read_wav`` takes the native decode; the numpy decoder (the library
    switched off) gives the same samples bit for bit."""
    rng = np.random.default_rng(3)
    x = np.clip(0.4 * rng.standard_normal((2, 3001)), -1, 1).astype(np.float32)
    p = tmp_path / f"{kind}.wav"
    if kind == "pcm32":
        pcm = np.round(x.T.astype(np.float64) * 2147483647).astype("<i4")
        _write_raw(p, pcm.tobytes(), 2, 22050, 32, 1)
    else:
        write_wav(p, x, 22050, subtype={"pcm16": "PCM_16", "pcm24": "PCM_24",
                                        "float32": "FLOAT"}[kind])
    nat, sr = lib.wav_decode(p.read_bytes())
    via_read = read_wav(p)
    monkeypatch.setattr(native, "wav_decode", lambda data: None)
    py = read_wav(p)
    assert sr == py.sample_rate == via_read.sample_rate == 22050
    assert nat.dtype == py.samples.dtype == np.float32 and nat.shape == py.samples.shape
    np.testing.assert_array_equal(nat, py.samples)
    np.testing.assert_array_equal(via_read.samples, py.samples)


def _write_raw(path, data: bytes, ch: int, sr: int, bits: int, fmt: int) -> None:
    import struct

    block = ch * bits // 8
    header = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
              + struct.pack("<IHHIIHH", 16, fmt, ch, sr, sr * block, block, bits)
              + b"data" + struct.pack("<I", len(data)))
    Path(path).write_bytes(header + data)


def test_wav_encode_roundtrip(lib):
    x = np.clip(np.random.default_rng(0).standard_normal((2, 5000)) * 0.3, -0.99, 0.99
                ).astype(np.float32)
    data = lib.wav_encode_pcm16(x, 22050)
    assert data[:4] == b"RIFF"
    decoded, sr = lib.wav_decode(data)
    assert sr == 22050 and decoded.shape == x.shape
    np.testing.assert_allclose(decoded, x, atol=1e-4)


def test_resample_matches_scipy(lib):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(3000).astype(np.float32)
    y = lib.resample(x, 3, 2)
    ref = sps.resample_poly(x, 3, 2).astype(np.float32)
    assert len(y) == len(ref)
    assert np.abs(y[50:-50] - ref[50:-50]).max() < 5e-2
    t = np.arange(8000) / 8000.0
    up = lib.resample(np.sin(2 * np.pi * 440 * t).astype(np.float32), 2, 1)
    spec = np.abs(np.fft.rfft(up * np.hanning(len(up))))
    assert abs(np.fft.rfftfreq(len(up), 1 / 16000.0)[spec.argmax()] - 440.0) < 2.0


def test_levels_and_hash64(lib):
    x = np.asarray([0.0, 0.5, -1.0, 0.0], np.float32)
    peak, rms = lib.levels(x)
    assert abs(peak - 1.0) < 1e-6 and abs(rms - np.sqrt(np.mean(x ** 2))) < 1e-6
    # FNV-1a's loop from the library's offset basis: a fixed function of
    # the bytes, the same in every run and process
    def fnv(data: bytes) -> int:
        h = 1469598103934665603
        for byte in data:
            h = ((h ^ byte) * 1099511628211) & (2 ** 64 - 1)
        return h

    for data in (b"", b"hello", bytes(range(256)) * 3):
        assert lib.hash64(data) == fnv(data)
    assert lib.hash64(b"hello") != lib.hash64(b"hellp")


@pytest.mark.parametrize("mode,fn", [("dio", f0_dio), ("harvest", f0_harvest)])
def test_world_f0_oracle_matches_dsp_f0(lib, mode, fn):
    """The port's numpy DIO / Harvest against the native oracle on the
    speech-like signal, at tests/test_f0_world.py's bounds."""
    x, _truth = _speechlike()
    est = fn(x, sr=SR, hop=HOP)
    orc = lib.world_f0(x, SR, HOP, mode=mode)
    n = min(len(est), len(orc))
    est, orc = est[:n], orc[:n]
    both, either = (est > 0) & (orc > 0), (est > 0) | (orc > 0)
    assert both.sum() / max(either.sum(), 1) > 0.75
    rel = np.abs(est[both] - orc[both]) / orc[both]
    assert np.median(rel) < 0.02 and np.percentile(rel, 90) < 0.08


def test_world_stonemask_matches_dsp_f0(lib):
    x, _truth = _speechlike(3)
    raw = f0_dio(x, sr=SR, hop=HOP, refine=False)
    py = stonemask(x, raw, sr=SR, hop=HOP)
    cc = lib.world_stonemask(x, raw, SR, HOP)
    v = raw > 0
    rel = np.abs(py[v] - cc[v]) / np.maximum(cc[v], 1e-6)
    assert np.median(rel) < 0.01


def test_four_processes_build_the_library_at_once(tmp_path):
    """Four processes build into one fresh directory at the same moment:
    each loads a whole library and hashes alike, one library is left and
    no temporary file."""
    code = ("import sys, pathlib; sys.path.insert(0, sys.argv[1]); "
            "from audiolab_tpu_torch import native as N; "
            "N.BUILD_DIR = pathlib.Path(sys.argv[2]); "
            "print(N.available(), N.hash64(b'audiolab'), N.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    lines = {o.strip() for o, _ in outs}
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len(lines) == 1
    ok, digest, path = lines.pop().split()
    assert ok == "True" and int(digest) == native.hash64(b"audiolab")
    assert [p.name for p in tmp_path.iterdir()] == [Path(path).name]
