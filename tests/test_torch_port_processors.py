"""The port's processor layer and chain executor against the JAX package's,
on the CPU: the counterparts of tests/test_chain.py for the processors
(all eight of the JAX registry), with each numeric output held against the
JAX run of the same chain on the same WAV, the processors' option schemas,
Convert and Compare through both packages, and one Separate -> Clone ->
Merge chain with configured tiny separators and converters through both
packages.  Remaster, Super Resolution and Clone's other methods have files
of their own (tests/test_torch_port_{remaster,super_res,cloning}.py)."""

import gzip
import json
import os
import zipfile
from xml.etree import ElementTree as ET

import numpy as np
import pytest

from audiolab_tpu.core.audio_io import read_audio as j_read_audio
from audiolab_tpu.core.project import ProjectFiles as JProjectFiles
from audiolab_tpu.pipelines import base as JB
from audiolab_tpu.pipelines import chain as JC
from audiolab_tpu.pipelines import separate as JSep
from audiolab_tpu.pipelines.processors import clone as JClone
from audiolab_tpu.pipelines.processors import separate as JSepProc
from audiolab_tpu.utils.daw import detect_bpm as j_detect_bpm
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.pipelines import base as TB
from audiolab_tpu_torch.pipelines import separate as TSep
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.pipelines.processors import clone as TClone
from audiolab_tpu_torch.pipelines.processors import separate as TSepProc
from audiolab_tpu_torch.utils.daw import detect_bpm
from tests import test_torch_port_chain as chain_parity
from tests.test_torch_port_rvc import _mel_l1, _Noise
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

PORTED = ("Separate", "Clone", "Export", "Merge", "Remaster", "Super Resolution", "Convert",
          "Compare")
# one PCM-16 step: both packages write their stems as 16-bit WAVs, and a
# sample within fp32 rounding of a step's midpoint may round either way
PCM16 = 1.0 / 32767.0 + 1e-6


@pytest.fixture
def song(tmp_path):
    """Synthetic 3 s 'song': 220 Hz vocal-ish center + wide noise bed
    (tests/test_chain.py's)."""
    sr = 22050
    t = np.arange(sr * 3) / sr
    vocal = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    rng = np.random.default_rng(0)
    bed_l = 0.1 * rng.standard_normal(len(t))
    bed_r = 0.1 * rng.standard_normal(len(t))
    left = (vocal + bed_l).astype(np.float32)
    right = (vocal + bed_r).astype(np.float32)
    p = tmp_path / "song.wav"
    write_wav(p, np.stack([left, right]) * 0.8, sr)
    return str(p)


@pytest.fixture(autouse=True)
def processor_state():
    """Both packages keep injected models on the processor classes; every
    test leaves them as it found them (other test files share the process)."""
    saved = [(cls, {k: getattr(cls, k) for k in keys}) for cls, keys in (
        (JSepProc.Separate, ("separator", "multistem", "drum_splitter", "woodwind_splitter",
                             "bg_splitter", "alt_bass", "transforms")),
        (JClone.Clone, ("converter", "facade")),
        (TSepProc.Separate, ("separator", "multistem", "drum_splitter", "woodwind_splitter",
                             "bg_splitter", "alt_bass", "transforms")),
        (TClone.Clone, ("converter", "facade")))]
    yield
    for cls, attrs in saved:
        for k, v in attrs.items():
            setattr(cls, k, v)


def _both(tmp_path, titles, files, settings=None):
    """The same chain through both packages, each under its own root."""
    j = JC.run_chain(list(titles), list(files), json.loads(json.dumps(settings or {})),
                     output_root=str(tmp_path / "jax"))
    t = run_chain(list(titles), list(files), json.loads(json.dumps(settings or {})),
                  output_root=str(tmp_path / "port"), device="cpu")
    return j, t


def _same_audio(j_paths, t_paths, tol=PCM16):
    """Same file names, rates and shapes, samples within ``tol``; returns
    the largest difference."""
    assert [os.path.basename(p) for p in t_paths] == [os.path.basename(p) for p in j_paths]
    worst = 0.0
    for jp, tp in zip(j_paths, t_paths):
        if not jp.endswith(".wav"):
            continue
        ja, ta = j_read_audio(jp), read_audio(tp)
        assert ta.sample_rate == ja.sample_rate and ta.samples.shape == ja.samples.shape
        worst = max(worst, float(np.abs(ta.samples - ja.samples).max()))
    assert worst <= tol, f"max|diff| {worst:.3e} > {tol:.3e}"
    return worst


def test_typed_input_validation():
    for mod in (TB, JB):
        ti = mod.TypedInput(default=5, type=int, ge=0, le=10)
        assert ti.validate("x", None) == 5
        assert ti.validate("x", 7) == 7
        with pytest.raises(ValueError):
            ti.validate("x", 11)
        tb = mod.TypedInput(default=False, type=bool)
        assert tb.validate("b", "true") is True
        with pytest.raises(ValueError):
            mod.TypedInput(default="a", choices=["a", "b"]).validate("c", "z")


def test_processor_registry_order():
    procs = TB.all_processors()
    assert [p.title for p in procs] == list(PORTED)
    assert [p.priority for p in procs] == [JB.get_processor(t).priority for t in PORTED]
    assert TB.get_processor("Clone") is procs[1]
    with pytest.raises(KeyError):
        TB.get_processor("Reverse")       # no such processor: the chain answers 400


@pytest.mark.parametrize("title", PORTED)
def test_json_schema_equals_jax(title):
    port, ref = TB.get_processor(title), JB.get_processor(title)
    assert port.json_schema() == ref.json_schema()
    assert (port.priority, port.default_enabled) == (ref.priority, ref.default_enabled)


def test_project_files(tmp_path, song):
    proj = ProjectFiles(song, output_root=str(tmp_path / "out"))
    ref = JProjectFiles(song, output_root=str(tmp_path / "jax"))
    assert os.path.basename(proj.project_dir) == os.path.basename(ref.project_dir)
    assert os.path.exists(proj.src_file)
    assert "source" in proj.src_file
    proj.add_output("stage1", [song])
    assert proj.last_outputs == [song]
    assert song in proj.all_outputs()
    # a reload walks the stage folders
    os.makedirs(os.path.join(proj.project_dir, "stems"))
    open(os.path.join(proj.project_dir, "stems", "a.wav"), "wb").close()
    again = ProjectFiles(song, output_root=str(tmp_path / "out"))
    assert list(again.file_dict) == ["stems"]


def test_separate_fallback_chain(tmp_path, song):
    """The DSP split (STFT mask on mid/side) on the processor's device: the
    stems equal the JAX package's to a PCM-16 step, and sum back to the mix."""
    j, t = _both(tmp_path, ["Separate"], [song], {"Separate": {"noise_removal": "Nothing"}})
    outs = t[0].last_outputs
    assert len(outs) == 2
    assert any("(Vocals)" in f for f in outs)
    assert any("(Instrumental)" in f for f in outs)
    _same_audio(j[0].last_outputs, outs)
    v = read_audio([f for f in outs if "(Vocals)" in f][0])
    i = read_audio([f for f in outs if "(Instrumental)" in f][0])
    src = read_audio(song)
    recon = v.samples + i.samples
    n = min(recon.shape[-1], src.samples.shape[-1])
    assert np.abs(recon[:, :n] - src.samples[:, :n]).mean() < 2e-3


def test_separate_cache_hit(tmp_path, song, monkeypatch):
    root = str(tmp_path / "out")
    first = run_chain(["Separate"], [song], output_root=root, device="cpu")

    def no_split(*_a, **_k):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(TSepProc, "dsp_vocal_split", no_split)
    proj2 = run_chain(["Separate"], [song], output_root=root, device="cpu")
    assert proj2[0].last_outputs == first[0].last_outputs  # served from cache
    meta = json.load(open(os.path.join(proj2[0].project_dir, "stems", "cache.json")))
    assert meta["files"] == first[0].last_outputs


def _als_tracks(bundle):
    with zipfile.ZipFile(bundle) as z:
        names = z.namelist()
        als = [n for n in names if n.endswith(".als")][0]
        root = ET.fromstring(gzip.decompress(z.read(als)))
    tracks = [e.get("Value") for e in root.iter("EffectiveName")]
    tempo = root.find("LiveSet/MasterTrack/DeviceChain/Tempo/Manual").get("Value")
    return sorted(names), tracks, tempo


def test_export_ableton(tmp_path, song):
    """The bundle holds the same files, tracks and tempo as the JAX one."""
    j, t = _both(tmp_path, ["Separate", "Export"], [song],
                 {"Export": {"project_format": "ableton"}})
    bundle = t[0].last_outputs[-1]
    assert bundle.endswith(".zip")
    names, tracks, tempo = _als_tracks(bundle)
    assert any(n.endswith(".als") for n in names) and tracks
    assert (names, tracks, tempo) == _als_tracks(j[0].last_outputs[-1])
    # Export appends the bundle after the passthrough stems
    assert [os.path.basename(p) for p in t[0].last_outputs] == [
        os.path.basename(p) for p in j[0].last_outputs]


def test_export_reaper(tmp_path, song):
    j, t = _both(tmp_path, ["Separate", "Export"], [song],
                 {"Export": {"project_format": "reaper"}})

    def rpp(bundle, root):
        with zipfile.ZipFile(bundle) as z:
            name = [n for n in z.namelist() if n.endswith(".rpp")][0]
            return z.read(name).decode().replace(os.path.abspath(root), "ROOT")

    text = rpp(t[0].last_outputs[-1], tmp_path / "port")
    assert "REAPER_PROJECT" in text and "<TRACK" in text
    assert text == rpp(j[0].last_outputs[-1], tmp_path / "jax")


@pytest.mark.parametrize("bpm", [90.0, 120.0])
def test_detect_bpm_click_track(bpm):
    sr = 22050
    n = sr * 8
    x = np.zeros(n, dtype=np.float32)
    period = int(sr * 60 / bpm)
    for i in range(0, n, period):
        x[i: i + 200] = np.hanning(200) * 0.9
    est = detect_bpm(x, sr)
    assert est == j_detect_bpm(x, sr)
    assert any(abs(est - bpm * m) < 6 for m in (0.5, 1.0, 2.0))


def test_chain_failure_partial(tmp_path, song):
    """Clone without a configured converter fails; the chain returns what
    Separate made, as the JAX chain does."""
    TClone.Clone.converter = None
    JClone.Clone.converter = None
    j, t = _both(tmp_path, ["Separate", "Clone", "Merge"], [song])
    assert len(t[0].last_outputs) == 2
    assert not os.path.isdir(os.path.join(t[0].project_dir, "merged"))
    _same_audio(j[0].last_outputs, t[0].last_outputs)


def test_skip_separate_heuristic(tmp_path):
    """A pre-separated input skips Separate: Merge gets the input itself."""
    p = str(tmp_path / "song_tts_(Vocals).wav")
    t = np.arange(8000) / 16000
    write_wav(p, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    j, tp = _both(tmp_path, ["Separate", "Merge"], [p])
    assert list(tp[0].file_dict) == ["merged"]
    assert list(j[0].file_dict) == ["merged"]
    _same_audio(j[0].last_outputs, tp[0].last_outputs)


def test_separate_full_option_set(tmp_path, song):
    """The reference wrapper's full field set (wrappers/separate.py:33-140):
    BG-vocal peel, drum split, reverb-IR capture, policy transforms, and
    extra stems kept when delete_extra_stems is off; every stem and the
    captured IR against the JAX run (stems to a PCM-16 step, the IR to 1e-5
    of its peak, its descriptors to 1e-3)."""
    settings = {"Separate": {
        "separate_bg_vocals": True,
        "bg_vocal_layers": 2,
        "separate_drums": True,
        "store_reverb_ir": True,
        "noise_removal": "Main Vocals",
        "reverb_removal": "All Vocals",
        "delete_extra_stems": False,
        "use_cache": False,
    }}
    j, t = _both(tmp_path, ["Separate"], [song], settings)
    outs = t[0].last_outputs
    names = [os.path.basename(f) for f in outs]
    assert any("(Vocals)" in n for n in names)
    assert any("(BG_Vocals)" in n for n in names)
    assert any("Bg_Vocals_2" in n for n in names)
    assert any("(Drums)" in n for n in names)
    _same_audio(j[0].last_outputs, outs)
    for f in outs:
        assert np.isfinite(read_audio(f).samples).all()
    params = [json.load(open(os.path.join(p[0].project_dir, "reverb_params.json")))
              for p in (t, j)]
    ir, ref_ir = (np.asarray(p.pop("impulse_response")) for p in params)
    assert np.abs(ir - ref_ir).max() <= 1e-5 * np.abs(ref_ir).max()
    # the descriptors are sums over the IR, whose quiet tail agrees only to
    # 1e-5 of the IR's peak: 1e-3 relative (measured 1.4e-4)
    assert params[0] == pytest.approx(params[1], rel=1e-3)


def test_chain_separate_clone_merge_matches_jax(tmp_path, monkeypatch):
    """Separate (a tiny BS-RoFormer member, the jitted one of
    test_torch_port_chain's pair) -> Clone (a tiny v2 converter, rmvpe+,
    retrieval) -> Merge through both packages' run_chain
    on the same WAV, with Clone's pitch shift carried into Merge (which then
    shifts the instrumental) and the reverb IR captured by Separate re-applied
    to the cloned vocals.  Gate: mel-L1 < 1e-2 of the merged WAVs
    (BASELINE.md's, measured as tests/test_fidelity.py does); the largest
    sample difference is printed and held to 1e-2 of the peak."""
    _Noise(zero=True).patch(monkeypatch)
    sr = chain_parity.SEP_SR
    t = np.arange(sr) / sr
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    rng = np.random.default_rng(0)
    x = (np.stack([tone, 0.8 * tone]) + 0.05 * rng.standard_normal((2, sr))).astype(np.float32)
    song = str(tmp_path / "song.wav")
    write_wav(song, x, sr)
    index = rng.standard_normal((200, 32)).astype(np.float32)
    j_members, t_members = chain_parity._members()
    skw = dict(sr=sr, chunk_seconds=0.3, overlap_seconds=0.05, device_batch=2,
               matmul_precision="highest")
    JSepProc.Separate.configure(JSep.StemSeparator(j_members[:1], **skw))
    TSepProc.Separate.configure(TSep.StemSeparator(t_members[:1], device="cpu", **skw))
    jvc, tvc = chain_parity._converters(index)
    JClone.Clone.configure(jvc)
    TClone.Clone.configure(tvc)

    settings = {"Separate": {"store_reverb_ir": True}, "Clone": {"pitch_shift": 2}}
    j, tp = _both(tmp_path, ["Separate", "Clone", "Merge"], [song], settings)
    assert tvc.cfg.f0_method == "rmvpe+" and tvc.synth.training is False
    for p in (j[0], tp[0]):
        assert sorted(p.file_dict) == ["cloned", "merged", "stems"]
        assert os.path.exists(os.path.join(p.project_dir, "reverb_params.json"))
    out, ref = tp[0].last_outputs, j[0].last_outputs
    assert [os.path.basename(p) for p in out] == [os.path.basename(p) for p in ref] == [
        "song_merged.wav"]
    a, b = read_audio(out[0]), j_read_audio(ref[0])
    assert a.sample_rate == b.sample_rate == sr and a.samples.shape == b.samples.shape == x.shape
    assert np.isfinite(a.samples).all() and np.abs(a.samples).max() > 1e-3
    err = float(np.abs(a.samples - b.samples).max())
    mel = max(_mel_l1(a.samples[c], b.samples[c], sr) for c in range(2))
    print(f"Separate -> Clone -> Merge: merged max|diff| {err:.3e} (peak "
          f"{np.abs(b.samples).max():.3e}), mel-L1 {mel:.3e}")
    assert mel < chain_parity.MEL_L1_GATE
    assert err <= 1e-2 * np.abs(b.samples).max()


def test_convert_wav_matches_jax(tmp_path, song, monkeypatch):
    """Convert to WAV through both packages: an input that is already WAV is
    copied (its own bytes); any other input is decoded and written by each
    package's WAV codec, the same bytes.  No ffmpeg here, so the other input
    is a .flac name over WAV bytes that each Convert module reads with its
    WAV reader."""
    from audiolab_tpu.core.audio_io import read_wav as j_read_wav
    from audiolab_tpu.pipelines.processors import convert as JConvert
    from audiolab_tpu_torch.core.audio_io import read_wav
    from audiolab_tpu_torch.pipelines.processors import convert as TConvert

    j, t = _both(tmp_path, ["Convert"], [song], {"Convert": {"format": "wav"}})
    assert [os.path.basename(p) for p in t[0].last_outputs] == ["song.wav"]
    for jp, tp in zip(j[0].last_outputs, t[0].last_outputs):
        assert open(tp, "rb").read() == open(jp, "rb").read() == open(song, "rb").read()
    monkeypatch.setattr(JConvert, "read_audio", j_read_wav)
    monkeypatch.setattr(TConvert, "read_audio", read_wav)
    flac = tmp_path / "take.flac"
    write_wav(flac, read_audio(song).samples, 22050, subtype="FLOAT")
    j, t = _both(tmp_path / "flac", ["Convert"], [str(flac)], {"Convert": {}})
    assert [os.path.basename(p) for p in t[0].last_outputs] == ["take.wav"]
    got, want = (open(p[0].last_outputs[0], "rb").read() for p in (t, j))
    assert got == want and len(got) == 44 + 2 * 2 * 3 * 22050


def test_convert_other_formats_fail_as_jax(tmp_path, song, monkeypatch):
    """Without ffmpeg, MP3 output raises in both packages: the chain keeps
    its input and no converted stage is recorded."""
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    j, t = _both(tmp_path, ["Convert"], [song], {"Convert": {"format": "mp3"}})
    assert list(t[0].file_dict) == list(j[0].file_dict) == []
    assert os.path.basename(t[0].last_outputs[0]) == os.path.basename(j[0].last_outputs[0])


def _metrics(proj):
    files = proj.last_outputs
    assert [os.path.basename(f) for f in files] == ["comparison.json", "comparison.png"]
    return json.load(open(files[0])), files[1]


def test_compare_matches_jax(tmp_path, song):
    """Separate -> Compare (the instrumental against the source): the JSON
    metrics within 1e-5 relative of the JAX run's and a PNG image from
    matplotlib."""
    j, t = _both(tmp_path, ["Separate", "Compare"], [song],
                 {"Separate": {"noise_removal": "Nothing"}})
    (got, png), (want, _) = _metrics(t[0]), _metrics(j[0])
    assert sorted(got) == sorted(want) == ["image", "rms_diff", "spec_l1", "spec_max"]
    for k in ("rms_diff", "spec_l1", "spec_max"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_compare_falls_back_to_the_stdlib_png(tmp_path, song, monkeypatch):
    """With matplotlib failing to import, both packages draw the waveform
    and the difference spectrogram with utils/viz.py: the same metrics and
    the same two PNGs, byte for byte."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("matplotlib disabled for this test")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    j, t = _both(tmp_path, ["Separate", "Compare"], [song],
                 {"Separate": {"noise_removal": "Nothing"}})
    (got, png), (want, jpng) = _metrics(t[0]), _metrics(j[0])
    assert sorted(got) == sorted(want) == ["image", "rms_diff", "spec_image", "spec_l1",
                                           "spec_max"]
    assert got["rms_diff"] == pytest.approx(want["rms_diff"], rel=1e-5)
    assert open(png, "rb").read() == open(jpng, "rb").read()
    spec = os.path.join(os.path.dirname(png), "comparison_spec.png")
    assert os.path.exists(spec) and open(spec, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_viz_copy_writes_the_jax_bytes(tmp_path):
    """utils/viz.py is a copy: PNG encoder, f0 curves, spectrogram and
    waveform renderers write the JAX module's bytes."""
    from audiolab_tpu.utils import viz as JV
    from audiolab_tpu_torch.utils import viz as TV

    rng = np.random.default_rng(0)
    f0 = np.abs(200 + 20 * rng.standard_normal(300))
    f0[::17] = 0.0
    mag = np.abs(rng.standard_normal((40, 65)))
    a, b = rng.standard_normal((2, 5000)).astype(np.float32)
    for mod, sub in ((JV, "jax"), (TV, "port")):
        d = tmp_path / sub
        d.mkdir()
        vis = mod.F0Visualizer(width=200, row_height=40)
        vis.add_curve("a", f0)
        vis.add_curve("b", f0 * 1.5)
        vis.render(str(d / "f0.png"))
        mod.spectrogram_png(str(d / "spec.png"), mag)
        mod.waveform_diff_png(str(d / "wave.png"), a, b, width=300, height=60)
    for name in ("f0.png", "spec.png", "wave.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
