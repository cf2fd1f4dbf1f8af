"""The port's REST server against the JAX package's, on the CPU: the
counterparts of tests/test_serve.py and tests/test_serve_extra.py for the
routes the port serves (a live ``serve_background`` server with
``device="cpu"``, answers held against the JAX router's on the same
requests), the route table as a subset of the JAX ``create_app``'s, and
``main``."""

import base64
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from audiolab_tpu.serve.api import create_app as j_create_app
from audiolab_tpu_torch import main as port_main
from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
from audiolab_tpu_torch.serve import rvc_api
from audiolab_tpu_torch.serve.api import create_app
from audiolab_tpu_torch.serve.http import serve_background
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
PCM16 = 1.0 / 32767.0 + 1e-6   # one 16-bit step: see test_torch_port_processors


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve")
    return {"port": str(base / "port" / "process"), "jax": str(base / "jax" / "process")}


@pytest.fixture(scope="module")
def server(roots):
    srv, port = serve_background(create_app(output_root=roots["port"], device="cpu"))
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_router(roots):
    return j_create_app(output_root=roots["jax"])


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64_wav(tmp_path, name="in.wav", seconds=1.0, sr=16000):
    t = np.arange(int(sr * seconds)) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                  0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 1000 * t)])
    p = tmp_path / name
    write_wav(p, x.astype(np.float32), sr)
    return {"filename": name, "content": base64.b64encode(p.read_bytes()).decode()}


def _same_files(body, ref, tmp_path):
    """Same file names; WAVs at the same rate and shape within a 16-bit step."""
    assert [f["filename"] for f in body["files"]] == [f["filename"] for f in ref["files"]]
    for got, want in zip(body["files"], ref["files"]):
        if not got["filename"].endswith(".wav"):
            continue
        paths = []
        for tag, f in (("got", got), ("want", want)):
            p = tmp_path / f"{tag}.wav"
            p.write_bytes(base64.b64decode(f["content"]))
            paths.append(read_wav(p))
        a, b = paths
        assert a.sample_rate == b.sample_rate and a.samples.shape == b.samples.shape
        assert np.abs(a.samples - b.samples).max() <= PCM16


def test_route_table_is_a_subset_of_jax(server, jax_router):
    port = {(r.method, r.pattern) for r in create_app("unused", device="cpu").routes}
    ref = {(r.method, r.pattern) for r in jax_router.routes}
    assert port <= ref, sorted(port - ref)
    for route in (("POST", "/api/v1/process/chain"), ("POST", "/api/v1/process/separate"),
                  ("POST", "/api/v1/process/merge"), ("GET", "/"), ("GET", "/openapi.json"),
                  ("POST", "/api/v1/rvc/analyze"), ("GET", "/api/v1/clone/methods"),
                  ("POST", "/api/v1/process/convert"), ("POST", "/api/v1/process/compare"),
                  ("POST", "/api/v1/process/remaster"),
                  ("POST", "/api/v1/process/super_resolution"),
                  ("POST", "/api/v1/audio/transcriptions"),
                  ("POST", "/api/v1/audio/translations"), ("POST", "/api/v1/align")):
        assert route in port


def test_processors_listing(server, jax_router):
    status, _h, raw = _get(f"{server}/api/v1/process/processors")
    body = json.loads(raw)
    assert status == 200
    assert [p["title"] for p in body["processors"]] == [
        "Separate", "Clone", "Export", "Merge", "Remaster", "Super Resolution", "Convert",
        "Compare"]
    _code, ref = jax_router.dispatch("GET", "/api/v1/process/processors", {})
    ref = {p["title"]: p for p in ref["processors"]}
    for p in body["processors"]:
        assert p == ref[p["title"]]


def test_openapi_document(server):
    status, _h, raw = _get(f"{server}/openapi.json")
    body = json.loads(raw)
    assert status == 200
    assert "/api/v1/process/chain" in body["paths"]
    assert "/api/v1/rvc/models" in body["paths"]
    # routes whose models the port lacks are not served; training, TTS,
    # transcription and alignment are
    assert "/api/v1/yue/generate" not in body["paths"]
    assert "/api/v1/rvc/train" in body["paths"]
    assert "/api/v1/audio/speech" in body["paths"]
    assert "/api/v1/audio/transcriptions" in body["paths"]
    assert "/api/v1/align" in body["paths"]


def test_web_ui(server):
    status, headers, raw = _get(f"{server}/")
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    assert b"/api/v1/process/chain" in raw


def test_process_separate_roundtrip(server, jax_router, tmp_path):
    payload = {"files": [_b64_wav(tmp_path)], "settings": {"noise_removal": "Nothing"}}
    status, body = _post(f"{server}/api/v1/process/separate", payload)
    assert status == 200
    names = [f["filename"] for f in body["files"]]
    assert any("(Vocals)" in n for n in names)
    assert base64.b64decode(body["files"][0]["content"])[:4] == b"RIFF"
    code, ref = jax_router.dispatch("POST", "/api/v1/process/separate", payload)
    assert code == 200
    _same_files(body, ref, tmp_path)


def test_chain_endpoint(server, jax_router, tmp_path):
    payload = {
        "files": [_b64_wav(tmp_path)],
        "processors": ["Separate", "Export", "Merge"],
        "settings": {"Separate": {"noise_removal": "Nothing"}, "Merge": {"pitch_shift": 1}},
    }
    status, body = _post(f"{server}/api/v1/process/chain", payload)
    assert status == 200
    assert len(body["files"]) == 1
    assert body["files"][0]["filename"].endswith("_merged.wav")
    code, ref = jax_router.dispatch("POST", "/api/v1/process/chain", payload)
    assert code == 200
    # Merge's pitch shift runs through each package's YIN periods
    # (test_torch_port_dsp.py::test_pitch_shift_matches_jax): 2e-3 of the peak
    a, b = (np.frombuffer(base64.b64decode(f["files"][0]["content"])[44:], "<i2") / 32767.0
            for f in (body, ref))
    assert a.shape == b.shape and np.abs(a - b).max() <= 2e-3 * np.abs(b).max() + PCM16


def test_chain_unported_processor_is_400(server, tmp_path):
    status, body = _post(f"{server}/api/v1/process/chain",
                         {"files": [_b64_wav(tmp_path)], "processors": ["Reverse"]})
    assert status == 400 and "Reverse" in body["error"]


@pytest.mark.parametrize("slug,settings", [
    ("convert", {"format": "wav"}),
    ("compare", {}),
    ("remaster", {"use_source_track_as_reference": False, "target_lufs": -16.0}),
    ("super_resolution", {"chunk_size": 5.0, "tgt_ensemble": True}),
])
def test_new_processor_routes(server, jax_router, tmp_path, slug, settings):
    """The four processors of this slice, each through its own route on the
    CPU server: HTTP 200 and the JAX router's files (WAVs to a 16-bit
    step; Compare's JSON to 1e-5 relative, its PNG present)."""
    payload = {"files": [_b64_wav(tmp_path, seconds=0.5)], "settings": settings}
    status, body = _post(f"{server}/api/v1/process/{slug}", payload)
    assert status == 200, body
    code, ref = jax_router.dispatch("POST", f"/api/v1/process/{slug}", payload)
    assert code == 200
    if slug != "compare":
        _same_files(body, ref, tmp_path)
        return
    assert [f["filename"] for f in body["files"]] == ["comparison.json", "comparison.png"]
    got, want = (json.loads(base64.b64decode(b["files"][0]["content"])) for b in (body, ref))
    for k in ("rms_diff", "spec_l1", "spec_max"):
        assert got[k] == pytest.approx(want[k], rel=1e-5)


def test_missing_files_is_400(server):
    status, body = _post(f"{server}/api/v1/process/separate", {"files": []})
    assert status == 400
    assert "error" in body


@pytest.mark.parametrize("path", ["/api/v1/does/not/exist", "/api/v1/yue/generate"])
def test_unknown_or_unported_route_404(server, path):
    status, _body = _post(f"{server}{path}", {})
    assert status == 404


def test_rvc_models_and_jobs(server):
    status, _h, raw = _get(f"{server}/api/v1/rvc/models")
    assert status == 200 and json.loads(raw)["models"] == []
    status, _h, _raw = _get(f"{server}/api/v1/rvc/job/nope")
    assert status == 404
    job = rvc_api.submit_job(lambda x, job_id: {"twice": 2 * x, "id": job_id}, 21)
    deadline = time.time() + 10
    while True:
        _s, _h, raw = _get(f"{server}/api/v1/rvc/job/{job}")
        info = json.loads(raw)
        if info["status"] != "running" or time.time() > deadline:
            break
        time.sleep(0.01)
    assert info["status"] == "done" and info["result"] == {"twice": 42, "id": job}


def test_clone_endpoints(server, jax_router):
    for path in ("/api/v1/clone/methods", "/api/v1/clone/voices"):
        status, _h, raw = _get(f"{server}{path}")
        assert status == 200
        assert json.loads(raw) == jax_router.dispatch("GET", path, {})[1]


def test_rvc_analyze(server, jax_router, tmp_path):
    body = {"files": [_b64_wav(tmp_path, seconds=0.5)]}
    status, resp = _post(f"{server}/api/v1/rvc/analyze", body)
    assert status == 200
    assert resp["analysis"] and 150 < resp["analysis"][0]["median_hz"] < 300
    _code, ref = jax_router.dispatch("POST", "/api/v1/rvc/analyze", body)
    # YIN on each side: its f0 agrees to a few fp32 ulps
    assert resp["analysis"][0] == pytest.approx(ref["analysis"][0], rel=1e-5)


def test_rvc_upload_download(server):
    content = base64.b64encode(b"fake npz").decode()
    status, resp = _post(f"{server}/api/v1/rvc/upload",
                         {"files": [{"filename": "v.npz", "content": content}]})
    assert status == 200 and resp["saved"] == ["v.npz"]
    status, headers, raw = _get(f"{server}/api/v1/rvc/download/v.npz")
    # raw-bytes contract (reference FileResponse semantics)
    assert status == 200 and raw == b"fake npz"
    assert "v.npz" in headers.get("Content-Disposition", "")
    _s, _h, raw = _get(f"{server}/api/v1/rvc/models")
    assert "v.npz" in json.loads(raw)["models"]
    status, _h, _raw = _get(f"{server}/api/v1/rvc/download/missing.npz")
    assert status == 404


def test_projects_and_load_project(server, roots, tmp_path):
    status, resp = _post(f"{server}/api/v1/process/load_project", {"project": "nope"})
    assert status >= 400
    status, resp = _post(f"{server}/api/v1/process/separate",
                         {"files": [_b64_wav(tmp_path, name="proj.wav", seconds=0.5)]})
    assert status == 200
    _s, _h, raw = _get(f"{server}/api/v1/process/projects")
    project = [p for p in json.loads(raw)["projects"] if p.startswith("proj_")][0]
    status, resp = _post(f"{server}/api/v1/process/load_project", {"project": project})
    assert status == 200 and resp["project"] == project
    assert os.path.join("source", "proj.wav") in resp["files"]
    assert any(f.startswith("stems") and "(Vocals)" in f for f in resp["files"])


def test_file_registry_roundtrip(tmp_path):
    from audiolab_tpu_torch.serve.files import file_response, register_file

    p = str(tmp_path / "x.bin")
    open(p, "wb").write(b"hello")
    fid = register_file(p)
    resp = file_response(fid)
    assert resp.body == b"hello"
    assert "x.bin" in resp.headers["Content-Disposition"]
    with pytest.raises(FileNotFoundError):
        file_response("nope")


@pytest.fixture
def speech_engines():
    """"dia" and "coqui" registered in both packages' speech tables (the tiny
    Dia over a narrow DAC, the capability XTTS at test width, each package
    holding the same weights); the tables are restored afterwards."""
    from audiolab_tpu.models import codecs as JC
    from audiolab_tpu.pipelines import tts as JT
    from audiolab_tpu.serve import tts_api as j_tts
    from audiolab_tpu_torch.pipelines import tts as TT
    from audiolab_tpu_torch.serve import tts_api as t_tts
    from tests import torch_port_tiny as tiny

    _cfg, jm, p, tm = tiny.dia()
    dcfg, dp, tdac = tiny.dac(codebook_size=17)
    jx, tx = tiny.xtts()
    saved = dict(j_tts._BACKENDS), dict(t_tts._BACKENDS)
    j_tts.register_backend("dia", JT.DiaTTSEngine(jm, p, JC.DACDecoder(dcfg), dp,
                                                  frames_per_word=2))
    j_tts.register_backend("coqui", JT.XTTSEngine(jx))
    t_tts.register_backend("dia", TT.DiaTTSEngine(tm, tdac, frames_per_word=2, device="cpu"))
    t_tts.register_backend("coqui", TT.XTTSEngine(tx))
    try:
        yield
    finally:
        for table, old in zip((j_tts._BACKENDS, t_tts._BACKENDS), saved):
            table.clear()
            table.update(old)


def test_speech_route_serves_chatterbox(server, jax_router, tmp_path):
    """POST /api/v1/audio/speech with "chatterbox" on the live port server and
    on the JAX router, each package's engine holding the tiny Chatterbox's
    weights (tests/torch_port_tiny.py): HTTP 200, a 24 kHz WAV of whole
    tokens (960 samples each), finite, from the Chatterbox engine and not
    from Dia; the voice listings the same.  The request takes the engine's
    500 tokens; the port's decode stops at the 64 + 4 rows of the tiny T3's
    speech positions (the JAX decode reads NaN rows past them, ROADMAP
    queue 3) and the two packages' draws differ, so the lengths are not
    compared."""
    from audiolab_tpu.serve import tts_api as j_tts
    from audiolab_tpu_torch.serve import tts_api as t_tts
    from tests import torch_port_tiny as tiny

    saved = dict(j_tts._BACKENDS), dict(t_tts._BACKENDS)
    jeng, eng = tiny.chatterbox_engines()
    t_tts.register_backend("chatterbox", eng)
    j_tts.register_backend("chatterbox", jeng)
    try:
        payload = {"model": "chatterbox", "input": "hi there"}
        code, body = _post(f"{server}/api/v1/audio/speech", payload)
        jcode, jbody = jax_router.dispatch("POST", "/api/v1/audio/speech", payload)
        assert code == jcode == 200
        assert body["sample_rate"] == jbody["sample_rate"] == eng.sr_out == 24000
        for tag, b in (("port", body), ("jax", jbody)):
            path = tmp_path / f"{tag}.wav"
            path.write_bytes(base64.b64decode(b["audio"]))
            w = read_wav(path)
            assert w.samples.shape[1] > 0 and w.samples.shape[1] % 960 == 0
            assert np.isfinite(w.samples).all()
            if tag == "port":
                assert w.samples.shape[1] <= 68 * 960
        status, _h, raw = _get(f"{server}/api/v1/audio/speech/voices")
        assert json.loads(raw) == jax_router.dispatch("GET", "/api/v1/audio/speech/voices",
                                                      {})[1]
    finally:
        for table, old in zip((j_tts._BACKENDS, t_tts._BACKENDS), saved):
            table.clear()
            table.update(old)


@pytest.mark.parametrize("model", ["dia", "coqui"])
def test_speech_route_serves_dia_and_coqui(server, jax_router, speech_engines, tmp_path,
                                           model):
    """POST /api/v1/audio/speech with "dia" and "coqui" on the live port
    server and on the JAX router: HTTP 200, a WAV at the engine's rate and
    length (the frame and code counts follow the text), finite, and the
    voice listing the same.  The draws of the two packages differ, so the
    samples are not compared here (tests/test_torch_port_{dia,xtts}.py hold
    them under the same draws)."""
    payload = {"model": model, "input": "[S1] hi there [S2] yo"}
    code, body = _post(f"{server}/api/v1/audio/speech", payload)
    jcode, jbody = jax_router.dispatch("POST", "/api/v1/audio/speech", payload)
    assert code == jcode == 200
    assert body["format"] == jbody["format"] == "wav"
    assert body["sample_rate"] == jbody["sample_rate"] == (44100 if model == "dia" else 24000)
    wavs = []
    for tag, b in (("port", body), ("jax", jbody)):
        path = tmp_path / f"{tag}.wav"
        path.write_bytes(base64.b64decode(b["audio"]))
        wavs.append(read_wav(path))
    assert wavs[0].samples.shape == wavs[1].samples.shape and wavs[0].samples.shape[1] > 0
    assert np.isfinite(wavs[0].samples).all()
    status, _h, raw = _get(f"{server}/api/v1/audio/speech/voices")
    assert status == 200
    assert json.loads(raw) == jax_router.dispatch("GET", "/api/v1/audio/speech/voices", {})[1]


def test_main_demo_backends_names_the_missing_items(caplog):
    """--demo-backends registers the random Zonos as "zonos", the random
    XTTS as "coqui", the random Chatterbox as "chatterbox" and the random
    Whisper transcriber as "whisper" on the given device, as the JAX server
    does, and names every engine the port does not have (no server)."""
    from audiolab_tpu_torch.pipelines.transcribe import Transcriber
    from audiolab_tpu_torch.pipelines.tts import ChatterboxCheckpointEngine, XTTSEngine, ZonosTTS
    from audiolab_tpu_torch.serve import transcribe_api, tts_api

    saved = dict(tts_api._BACKENDS)
    saved_tr = dict(transcribe_api._BACKENDS)
    try:
        with caplog.at_level(logging.INFO):
            port_main.register_demo_backends("cpu", logging.getLogger("test"))
        zonos, coqui = tts_api._BACKENDS["zonos"], tts_api._BACKENDS["coqui"]
        chatterbox = tts_api._BACKENDS["chatterbox"]
        assert isinstance(zonos, ZonosTTS) and zonos.device.type == "cpu"
        assert isinstance(coqui, XTTSEngine) and coqui.model.device.type == "cpu"
        assert isinstance(chatterbox, ChatterboxCheckpointEngine)
        assert chatterbox.device.type == "cpu"
        whisper = transcribe_api._BACKENDS["whisper"]
        assert isinstance(whisper, Transcriber) and whisper.device.type == "cpu"
    finally:
        tts_api._BACKENDS.clear()
        tts_api._BACKENDS.update(saved)
        transcribe_api._BACKENDS.clear()
        transcribe_api._BACKENDS.update(saved_tr)
    missing = caplog.text.split("no model yet for", 1)[1]
    for name in ("stable_audio", "acestep", "yue"):
        assert name in missing
    assert "chatterbox" not in missing and "whisper" not in missing
    assert "item 18 (" in caplog.text
    assert "item 17 (" not in caplog.text and "item 19 (" not in caplog.text


@pytest.fixture
def whisper_engines():
    """"whisper" registered in both packages' transcription tables (the demo
    widths on the same weights, tests/torch_port_tiny.py); the tables are
    restored afterwards."""
    from audiolab_tpu.serve import transcribe_api as j_tr
    from audiolab_tpu_torch.serve import transcribe_api as t_tr
    from tests import torch_port_tiny as tiny

    saved = dict(j_tr._BACKENDS), dict(t_tr._BACKENDS)
    j, t = tiny.transcriber_pair()
    j_tr.register_backend("whisper", j)
    t_tr.register_backend("whisper", t)
    try:
        yield
    finally:
        for table, old in zip((j_tr._BACKENDS, t_tr._BACKENDS), saved):
            table.clear()
            table.update(old)


def _gated_noise_wav(tmp_path, name, seconds, seed, sr=16000):
    rng = np.random.default_rng(seed)
    gate = np.repeat(rng.random(int(seconds * 4)) > 0.5, sr // 4)
    p = tmp_path / name
    write_wav(p, (0.2 * rng.standard_normal(len(gate)) * gate).astype(np.float32), sr)
    return {"filename": name, "content": base64.b64encode(p.read_bytes()).decode()}


@pytest.mark.parametrize("route,settings", [
    ("transcriptions", {}),
    ("transcriptions", {"response_format": "srt", "max_tokens": 48}),
    ("translations", {"response_format": "vtt"}),
])
def test_transcription_routes_answer_as_jax(server, jax_router, whisper_engines, tmp_path,
                                            route, settings):
    """POST /api/v1/audio/{transcriptions,translations} with "whisper" on
    the live port server and on the JAX router (the same demo weights): the
    same JSON (text, timed segments, energy-aligned words, the formatted
    export); a backend that is not loaded answers 501 on both."""
    payload = {"model": "whisper", "files": [_gated_noise_wav(tmp_path, "t.wav", 6.0, 7)],
               "settings": settings}
    code, body = _post(f"{server}/api/v1/audio/{route}", payload)
    jcode, ref = jax_router.dispatch("POST", f"/api/v1/audio/{route}",
                                     json.loads(json.dumps(payload)))
    assert code == jcode == 200
    assert body == ref and ref["results"][0]["segments"]
    code, _body = _post(f"{server}/api/v1/audio/{route}", dict(payload, model="nope"))
    assert code == jax_router.dispatch("POST", f"/api/v1/audio/{route}",
                                       dict(payload, model="nope"))[0] == 501


def test_align_route_answers_as_jax(server, jax_router, tmp_path):
    """POST /api/v1/align with a master and one take of the same gliding
    notes at other durations (tests/test_torch_port_align.py's, whose OLTW
    decisions are not near a tie), no transcriber registered (energy
    pseudo-words): the same aligned WAV and report as the JAX router's;
    a single file is refused on both."""
    from tests.test_torch_port_align import MASTER_D, PITCHES, TAKE_D, _notes

    files = []
    for name, durations, seed in (("master.wav", MASTER_D, 0), ("take.wav", TAKE_D, 1)):
        p = tmp_path / name
        write_wav(p, _notes(PITCHES, durations, seed), 16000)
        files.append({"filename": name, "content": base64.b64encode(p.read_bytes()).decode()})
    code, body = _post(f"{server}/api/v1/align", {"files": files})
    jcode, ref = jax_router.dispatch("POST", "/api/v1/align", {"files": files})
    assert code == jcode == 200
    assert [r["report"] for r in body["results"]] == [r["report"] for r in ref["results"]]
    assert ref["results"][0]["report"]["matched"] >= 1
    assert body == ref
    code, _body = _post(f"{server}/api/v1/align", {"files": files[:1]})
    assert code == jax_router.dispatch("POST", "/api/v1/align", {"files": files[:1]})[0] == 400


def test_main_serves_on_the_cpu_and_stops_on_sigterm(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "audiolab_tpu_torch.main", "--port", str(port),
         "--device", "cpu", "--output-root", str(tmp_path / "process")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        while True:
            try:
                status, _h, raw = _get(f"http://127.0.0.1:{port}/openapi.json")
                break
            except urllib.error.URLError:
                assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
                time.sleep(0.2)
        assert status == 200 and "/api/v1/process/chain" in json.loads(raw)["paths"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
