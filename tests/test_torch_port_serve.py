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


def test_route_table_equals_jax(server, jax_router):
    """Every route of the JAX router, YuE's two among them, and no other."""
    port = {(r.method, r.pattern) for r in create_app("unused", device="cpu").routes}
    ref = {(r.method, r.pattern) for r in jax_router.routes}
    assert port == ref, (sorted(ref - port), sorted(port - ref))
    assert len(ref) == 48
    assert {("POST", "/api/v1/yue/generate"), ("GET", "/api/v1/yue/stream/{file_id}")} <= port


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
    # every route of the JAX router is served: training, TTS, transcription,
    # alignment, music generation, ACE-Step's LoRA and YuE
    assert "/api/v1/yue/generate" in body["paths"]
    assert "/api/v1/yue/stream/{file_id}" in body["paths"]
    assert "/api/v1/acestep/lora/train" in body["paths"]
    assert "/api/v1/acestep/lora/generate" in body["paths"]
    assert "/api/v1/audio/generate" in body["paths"]
    assert "/api/v1/acestep/task" in body["paths"]
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


@pytest.mark.parametrize("path", ["/api/v1/does/not/exist", "/api/v1/yue/train"])
def test_unknown_or_unported_route_404(server, jax_router, path):
    """Paths neither router has: 404 from both."""
    status, _body = _post(f"{server}{path}", {})
    assert status == jax_router.dispatch("POST", path, {})[0] == 404


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
    XTTS as "coqui", the random Chatterbox as "chatterbox", the random
    Whisper transcriber as "whisper", and the random Stable Audio, ACE-Step
    and YuE as "stable_audio", "acestep" and "yue" on the given device, as
    the JAX server does; no engine is missing any more, and none is named
    as missing."""
    from audiolab_tpu_torch.models.yue import YuEPipeline
    from audiolab_tpu_torch.pipelines.acestep import ACEStepPipeline
    from audiolab_tpu_torch.pipelines.music import StableAudioPipeline
    from audiolab_tpu_torch.pipelines.transcribe import Transcriber
    from audiolab_tpu_torch.pipelines.tts import ChatterboxCheckpointEngine, XTTSEngine, ZonosTTS
    from audiolab_tpu_torch.serve import music_api, transcribe_api, tts_api

    saved = dict(tts_api._BACKENDS)
    saved_tr = dict(transcribe_api._BACKENDS)
    saved_mu = dict(music_api._BACKENDS)
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
        sa, ace = music_api._BACKENDS["stable_audio"], music_api._BACKENDS["acestep"]
        assert isinstance(sa, StableAudioPipeline) and sa.device.type == "cpu"
        assert isinstance(ace, ACEStepPipeline) and ace.device.type == "cpu"
        yue = music_api._BACKENDS["yue"]
        assert isinstance(yue, YuEPipeline) and yue.device.type == "cpu"
        assert next(yue.s1.parameters()).device.type == "cpu"
    finally:
        tts_api._BACKENDS.clear()
        tts_api._BACKENDS.update(saved)
        transcribe_api._BACKENDS.clear()
        transcribe_api._BACKENDS.update(saved_tr)
        music_api._BACKENDS.clear()
        music_api._BACKENDS.update(saved_mu)
    assert port_main.MISSING_DEMO_BACKENDS == {}
    assert "no model yet for" not in caplog.text and "item 18c (" not in caplog.text
    assert "stable_audio, acestep, yue" in caplog.text


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


# ------------------------------------------------------------------ music routes


@pytest.fixture(scope="module")
def music_backends():
    """"stable_audio" and "acestep" registered in both packages' music
    tables: the JAX demo backends (``random_stable_audio``, ``random_acestep``,
    their modules jitted) and the port's pipelines on the same weights, the
    port drawing the JAX keys' normals; 3 sampler steps.  The tables are
    restored afterwards."""
    import jax

    from audiolab_tpu.pipelines import acestep as j_ace
    from audiolab_tpu.pipelines import music as j_music
    from audiolab_tpu.serve import music_api as j_api
    from audiolab_tpu_torch.models import acestep as TA
    from audiolab_tpu_torch.models import codecs as TC
    from audiolab_tpu_torch.models import dit as TD
    from audiolab_tpu_torch.models import stable_audio as TS
    from audiolab_tpu_torch.pipelines import acestep as t_ace
    from audiolab_tpu_torch.pipelines import music as t_music
    from audiolab_tpu_torch.serve import music_api as t_api
    from audiolab_tpu_torch.utils import weights as W
    from tests import torch_port_tiny as tiny
    from tests.test_torch_port_acestep import JaxDraws

    js = j_music.random_stable_audio()
    js.model = tiny.Jitted(js.model)
    c = js.cfg
    tcfg = TS.StableAudioConfig(
        sr=c.sr, max_seconds=c.max_seconds, vae=TS.OobleckConfig(**vars(c.vae)),
        dit=TD.DiTConfig(**vars(c.dit)), text_dim=c.text_dim, text_layers=c.text_layers)

    class JaxKeyed(t_music.StableAudioPipeline):
        """The port's pipeline started from ``generate_audio``'s JAX latents."""

        def generate(self, prompt, seconds_total=10.0, seed=0, **kw):
            t_lat = TS.latent_frames(float(np.clip(seconds_total, 1.0, c.max_seconds)), c.sr,
                                     c.vae.hop)
            k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
            z = np.asarray(jax.random.normal(k_init, (1, t_lat, c.vae.latent_dim)))
            return super().generate(prompt, seconds_total=seconds_total, seed=seed,
                                    z=torch.from_numpy(z), **kw)

    import torch

    ts = JaxKeyed(tiny._load(TS.StableAudioModel(tcfg), W.stable_audio_from_jax(js.params)),
                  device="cpu")
    ja = j_ace.random_acestep()
    ja.model, ja.vocos = tiny.Jitted(ja.model), tiny.Jitted(ja.vocos)
    a, v = ja.cfg, ja.vocos.cfg
    acfg = TA.ACEStepConfig(sr=a.sr, mel_hop=a.mel_hop, dcae=TA.DCAEConfig(**vars(a.dcae)),
                            dit=TD.DiTConfig(**vars(a.dit)), text_dim=a.text_dim,
                            text_layers=a.text_layers, lyric_vocab=a.lyric_vocab)
    ta = t_ace.ACEStepPipeline(
        tiny._load(TA.ACEStepModel(acfg), W.acestep_from_jax(ja.params)),
        tiny._load(TC.Vocos(TC.VocosConfig(**vars(v)), in_dim=a.dcae.n_mels),
                   W.vocos_from_jax(ja.vocos_params)),
        device="cpu", draws=JaxDraws())
    ja.pcfg.steps = ta.pcfg.steps = 3
    saved = dict(j_api._BACKENDS), dict(t_api._BACKENDS)
    for api, sa, ace in ((j_api, js, ja), (t_api, ts, ta)):
        api._BACKENDS.clear()
        api.register_backend("stable_audio", sa)
        api.register_backend("acestep", ace)
    yield
    for api, table in zip((j_api, t_api), saved):
        api._BACKENDS.clear()
        api._BACKENDS.update(table)


def _same_audio(body, ref, tmp_path, tol=1e-4):
    """Same keys (but the file id) and values; the WAVs at one rate and shape,
    within ``tol`` of max|y| and a 16-bit step."""
    assert set(body) == set(ref)
    for k in set(body) - {"audio", "file_id"}:
        assert body[k] == ref[k], k
    out = []
    for tag, b in (("got", body), ("want", ref)):
        p = tmp_path / f"{tag}.wav"
        p.write_bytes(base64.b64decode(b["audio"]))
        out.append(read_wav(p))
    a, b = out
    assert a.sample_rate == b.sample_rate and a.samples.shape == b.samples.shape
    assert np.isfinite(a.samples).all() and a.samples.shape[-1] > 0
    assert np.abs(a.samples - b.samples).max() <= tol * np.abs(b.samples).max() + PCM16


def _music_clip(tmp_path, sr=8000, seconds=2.0):
    rng = np.random.default_rng(3)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size))
    p = tmp_path / "clip.wav"
    write_wav(p, x.astype(np.float32)[None], sr)
    return {"filename": "clip.wav", "content": base64.b64encode(p.read_bytes()).decode()}


MUSIC_POSTS = {
    "audio_generate": ("/api/v1/audio/generate", dict(
        prompt="warm pads", settings={"seconds_total": 1.0, "steps": 3, "cfg_scale": 3.0,
                                      "negative_prompt": "noise", "seed": 2})),
    "audio_continue": ("/api/v1/audio/continue", dict(
        prompt="glass", settings={"seconds_total": 1.0, "steps": 3, "seed": 1}, clip=16000)),
    "acestep_generate": ("/api/v1/acestep/generate", dict(
        prompt="lofi beat", lyrics="[verse] la la", duration=1.5, infer_step=3, seed=4)),
    "acestep_retake": ("/api/v1/acestep/task", dict(
        task="retake", prompt="jazz", settings={"variance": 0.4, "seed": 5}, clip=8000)),
    "acestep_repaint": ("/api/v1/acestep/task", dict(
        task="repaint", prompt="jazz", settings={"start_s": 0.5, "end_s": 1.5, "seed": 6},
        clip=8000)),
    "acestep_edit": ("/api/v1/acestep/task", dict(
        task="edit", tags="rock", settings={"strength": 0.7, "lyrics": "[chorus] oh"},
        clip=8000)),
    "acestep_extend": ("/api/v1/acestep/task", dict(
        task="extend", prompt="rock", settings={"right_s": 1.0, "left_s": 0.5}, clip=8000)),
}


@pytest.mark.parametrize("case", sorted(MUSIC_POSTS))
def test_music_routes_match_the_jax_router(server, jax_router, music_backends, tmp_path, case):
    """The POST music routes on the demo backends (same weights, JAX's
    draws): status, keys and audio within 1e-4 of max|y| and a 16-bit step;
    the file id downloads the same WAV."""
    path, body = MUSIC_POSTS[case]
    body = dict(body)
    sr = body.pop("clip", None)
    if sr:
        body["files"] = [_music_clip(tmp_path, sr=sr)]
    status, resp = _post(f"{server}{path}", body)
    code, ref = jax_router.dispatch("POST", path, body)
    assert status == code == 200, resp
    _same_audio(resp, ref, tmp_path)
    st, _h, raw = _get(f"{server}/api/v1/audio/download/{resp['file_id']}")
    assert st == 200 and raw == base64.b64decode(resp["audio"])


def _job_result(poll, job_id, seconds=120):
    deadline = time.time() + seconds
    while True:
        info = poll(job_id)
        if info["status"] != "running" or time.time() > deadline:
            return info
        time.sleep(0.05)


@pytest.fixture
def lora_backends():
    """"acestep" in both music tables: the pipelines of
    ``tests/test_torch_port_lora.py`` (random_acestep's widths with filled
    weights; the demo backend's flax init zeroes the DiT's output projection,
    so no adapter could show there), restored afterwards."""
    from audiolab_tpu.serve import music_api as j_api
    from audiolab_tpu_torch.serve import music_api as t_api
    from tests.test_torch_port_lora import pipelines

    saved = [dict(api._BACKENDS) for api in (j_api, t_api)]
    for api, be in zip((j_api, t_api), pipelines()):
        api.register_backend("acestep", be)
    yield t_api._BACKENDS["acestep"]
    for api, table in zip((j_api, t_api), saved):
        api._BACKENDS.clear()
        api._BACKENDS.update(table)


def test_acestep_lora_routes_match_the_jax_router(server, jax_router, lora_backends, tmp_path):
    """``lora/train`` on two clips: both routers' jobs end done with a
    finite loss and an ``.npz`` of the same paths and shapes.
    ``lora/generate`` with an adapter of the trained one's keys and shapes
    but N(0, 0.3^2) factors (two training steps move a tiny model's audio by
    less than a 16-bit step), registered in both packages' file tables: the
    same audio as JAX's within 1e-4 of max|y| and a 16-bit step, and not the
    base audio; the base generate at the same seed is bit-equal before and
    after the adapter request, and the backend's weights unchanged."""
    import torch

    from audiolab_tpu.serve import files as j_files
    from audiolab_tpu_torch.serve import files as t_files

    clips = [dict(_music_clip(tmp_path, sr=8000), prompt=p, lyrics="[verse] la la")
             for p in ("jazz", "rock")]
    body = {"clips": clips, "settings": {"steps": 2, "rank": 4, "lr": 0.05}}
    status, resp = _post(f"{server}/api/v1/acestep/lora/train", body)
    code, ref = jax_router.dispatch("POST", "/api/v1/acestep/lora/train", body)
    assert status == code == 200 and set(resp) == set(ref) == {"job_id"}
    got = _job_result(lambda j: json.loads(_get(f"{server}/api/v1/rvc/job/{j}")[2]),
                      resp["job_id"])
    want = _job_result(lambda j: jax_router.dispatch("GET", f"/api/v1/rvc/job/{j}", {})[1],
                       ref["job_id"])
    assert got["status"] == want["status"] == "done", (got, want)
    assert set(got["result"]) == set(want["result"]) == {"loss", "lora_path", "file_id"}
    assert np.isfinite(got["result"]["loss"])
    with np.load(got["result"]["lora_path"]) as a, np.load(want["result"]["lora_path"]) as b:
        assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}

    backend = lora_backends
    before = {k: v.clone() for k, v in backend.model.state_dict().items()}
    base = dict(prompt="lofi beat", duration=1.5, infer_step=3, seed=4)
    s0, first = _post(f"{server}/api/v1/acestep/lora/generate", base)
    rng = np.random.default_rng(8)
    path = str(tmp_path / "adapter.npz")
    with np.load(want["result"]["lora_path"]) as trained:
        np.savez(path, **{k: (0.3 * rng.standard_normal(trained[k].shape)).astype(np.float32)
                          for k in trained.files})
    status, resp = _post(f"{server}/api/v1/acestep/lora/generate",
                         dict(base, lora_file_id=t_files.register_file(path)))
    code, ref = jax_router.dispatch("POST", "/api/v1/acestep/lora/generate",
                                    dict(base, lora_file_id=j_files.register_file(path)))
    assert s0 == status == code == 200, resp
    _same_audio(resp, ref, tmp_path)
    s1, again = _post(f"{server}/api/v1/acestep/lora/generate", base)
    assert s1 == 200 and again["audio"] == first["audio"]
    assert resp["audio"] != first["audio"]
    _same_audio(first, jax_router.dispatch("POST", "/api/v1/acestep/generate", base)[1],
                tmp_path)
    assert all(torch.equal(v, backend.model.state_dict()[k]) for k, v in before.items())
    # the JAX route reads any server path a client names (ROADMAP queue 3);
    # the port refuses the key
    assert jax_router.dispatch("POST", "/api/v1/acestep/lora/generate",
                               dict(base, lora_path=path))[0] == 200
    status, err = _post(f"{server}/api/v1/acestep/lora/generate", dict(base, lora_path=path))
    assert status == 400 and "lora_path" in err["error"]


def test_music_listings_and_errors_match_the_jax_router(server, jax_router, music_backends):
    for path in ("/api/v1/audio/models", "/api/v1/audio/formats"):
        status, _h, raw = _get(f"{server}{path}")
        assert status == 200 and json.loads(raw) == jax_router.dispatch("GET", path, {})[1]
    assert json.loads(_get(f"{server}/api/v1/audio/models")[2])["models"] == [
        "acestep", "stable_audio"]
    for path, body in (("/api/v1/acestep/task", {"task": "remix", "files": []}),
                       ("/api/v1/acestep/task", {"task": "retake"}),
                       ("/api/v1/audio/continue", {"prompt": "x"})):
        status, _resp = _post(f"{server}{path}", body)
        assert status == jax_router.dispatch("POST", path, body)[0] == 400, (path, body)
    assert _get(f"{server}/api/v1/audio/download/nope")[0] == 404


def test_generation_settings_keep_what_generate_names():
    """The body's top-level knobs merge under ``settings`` (``settings`` wins)
    and, for a ``generate`` without ``**kwargs``, only the parameters it
    names pass, as the JAX package's ``_generate_with`` filters them."""
    from audiolab_tpu_torch.serve.music_api import generation_settings

    class Named:
        def generate(self, prompt, seed=0, duration=1.0):
            return prompt

    class Open:
        def generate(self, prompt, **kw):
            return prompt

    body = {"prompt": "x", "model": "m", "seed": 3, "extra": 1,
            "settings": {"duration": 2.0, "seed": 5, "other": 2}}
    assert generation_settings(Named(), body) == {"duration": 2.0, "seed": 5}
    assert generation_settings(Open(), body) == {"duration": 2.0, "seed": 5, "other": 2,
                                                 "extra": 1}


@pytest.fixture
def yue_backends():
    """"yue" in both packages' music tables: the JAX demo pipeline
    (``random_yue``) and the port's on its weights with the JAX keys' draws
    (tests/test_torch_port_yue.py); the tables are restored afterwards."""
    from audiolab_tpu.serve import music_api as j_api
    from audiolab_tpu_torch.serve import music_api as t_api
    from tests.test_torch_port_yue import pipelines

    saved = [dict(api._BACKENDS) for api in (j_api, t_api)]
    for api, be in zip((j_api, t_api), pipelines("seanet")):
        api.register_backend("yue", be)
    yield
    for api, table in zip((j_api, t_api), saved):
        api._BACKENDS.clear()
        api._BACKENDS.update(table)


def test_yue_routes_match_the_jax_router(server, jax_router, yue_backends, tmp_path):
    """POST /api/v1/yue/generate (knobs at the top level and under
    ``settings``): the JAX router's keys and audio within 1e-4 of max|y| and
    a 16-bit step; GET /api/v1/yue/stream/{file_id} gives the same WAV; an
    unknown knob is refused by both."""
    body = {"prompt": "pop upbeat", "lyrics": "la la la\n\nsecond verse", "n_segments": 2,
            "settings": {"seconds_per_segment": 0.2, "seed": 3}}
    status, resp = _post(f"{server}/api/v1/yue/generate", body)
    code, ref = jax_router.dispatch("POST", "/api/v1/yue/generate", body)
    assert status == code == 200, resp
    assert resp["sample_rate"] == ref["sample_rate"] == 16000
    _same_audio(resp, ref, tmp_path)
    st, _h, raw = _get(f"{server}/api/v1/yue/stream/{resp['file_id']}")
    assert st == 200 and raw == base64.b64decode(resp["audio"])
    assert _get(f"{server}/api/v1/yue/stream/nope")[0] == 404
    bad = dict(body, settings={"seconds_per_segment": 0.2, "temperature": 0.5})
    status, _resp = _post(f"{server}/api/v1/yue/generate", bad)
    assert status == jax_router.dispatch("POST", "/api/v1/yue/generate", bad)[0]
