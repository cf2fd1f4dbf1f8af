"""The port's deployable export and its training routes, on the CPU.

- An ``.npz`` exported by the port loads in the JAX package's
  ``load_generator`` and infers the audio the port infers (1e-5, fp32).
- An ``.npz`` written by the JAX package's ``export_generator`` (from a
  filled ``jax.eval_shape`` tree, tests/torch_port_tiny.py ``synth``) loads
  in the port, and the port writes the same entries for it.
- ``merge_models`` and ``extract_small_model`` give what the JAX package's
  give, entry for entry.
- ``POST /api/v1/rvc/train``, ``/rvc/resume`` and ``/rvc/build_index``
  through the port's ``create_app(device="cpu")`` on a 2 s tone (tiny
  synthesizer, the full discriminator, as tests/test_rvc_train_api.py runs
  the JAX router), and the trained model converts audio through the port's
  ``VoiceConverter``.
- Chain requests during a training job leave cuDNN's TF32 off in every
  module of every training step (the job holds the inference lock).
"""

import base64
import json
import time
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.train import checkpoint as JC
from audiolab_tpu_torch.core.audio_io import write_wav
from audiolab_tpu_torch.models.rvc import synthesizer as TSy
from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter
from audiolab_tpu_torch.serve import rvc_api
from audiolab_tpu_torch.serve.api import create_app
from audiolab_tpu_torch.train import checkpoint as TC
from audiolab_tpu_torch.train import rvc as TR
from audiolab_tpu_torch.train.rvc_train import _hubert_apply_for
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

SYNTH = dict(spec_channels=1025, segment_size=3840, inter_channels=16, hidden_channels=16,
             filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
             spk_embed_dim=4, gin_channels=16)


def _entries(path) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _same_entries(a, b) -> None:
    ea, eb = _entries(a), _entries(b)
    assert set(ea) == set(eb)
    assert json.loads(str(ea.pop("__config__"))) == json.loads(str(eb.pop("__config__")))
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


def _infer_inputs(b=2, t=10):
    rng = np.random.default_rng(6)
    phone = rng.standard_normal((b, t, 32)).astype(np.float32)
    f0 = rng.uniform(100, 400, (b, t)).astype(np.float32)
    pitch = rng.integers(1, 255, (b, t)).astype(np.int32)
    return phone, np.array([t, t - 3], np.int32), pitch, f0, np.array([1, 3], np.int32)


def _port_infer(module, args) -> np.ndarray:
    phone, lengths, pitch, f0, sid = (torch.from_numpy(a) for a in args)
    with torch.no_grad():
        return module.infer(phone, lengths.long(), pitch.long(), f0, sid.long()).numpy()


def _jax_infer(params, cfg, args) -> np.ndarray:
    fn = jax.jit(lambda p, *a: JSy.SynthesizerTrn(cfg).apply(
        {"params": p}, *a, None, method=JSy.SynthesizerTrn.infer))
    return np.asarray(fn(params, *(jnp.asarray(a) for a in args)))


def test_port_export_loads_in_jax(tmp_path):
    """The port's trained generator (posterior encoder and all) exported,
    loaded by the JAX package, inferring what the port infers."""
    _, _, tg, _ = tiny.train_pair()
    cfg = TSy.SynthesizerConfig(**tiny.SYNTH)
    path = TC.export_generator(str(tmp_path / "port.npz"), tg, cfg)
    params, jcfg = JC.load_generator(path)
    assert "enc_q" not in params and asdict(jcfg) == asdict(cfg)
    args = _infer_inputs()
    np.testing.assert_allclose(_port_infer(tg.eval(), args), _jax_infer(params, jcfg, args),
                               atol=1e-5, rtol=0)


def test_jax_export_loads_in_port(tmp_path):
    p, tm = tiny.synth()
    jcfg = JSy.SynthesizerConfig(**tiny.SYNTH)
    jpath = JC.export_generator(str(tmp_path / "jax.npz"), p, jcfg)
    tree, cfg = TC.load_generator(jpath)
    assert asdict(cfg) == asdict(jcfg)
    port = TSy.SynthesizerTrn(cfg)
    port.load_state_dict(W.synthesizer_from_jax(tree), strict=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    _same_entries(TC.export_generator(str(tmp_path / "port.npz"), port, cfg), jpath)


def test_merge_and_extract_match_jax(tmp_path):
    """merge_models of two exports (alpha 0.3) entry for entry as JAX's;
    extract_small_model of a port checkpoint equals the export of its G."""
    cfg = TSy.SynthesizerConfig(**tiny.SYNTH)
    gp = tiny.train_pair()[0]
    other = tiny.filled(gp, 21)
    a = TC.export_generator(str(tmp_path / "a.npz"), gp, cfg)
    b = TC.export_generator(str(tmp_path / "b.npz"), other, cfg)
    _same_entries(TC.merge_models(a, b, str(tmp_path / "m_port.npz"), alpha=0.3),
                  JC.merge_models(a, b, str(tmp_path / "m_jax.npz"), alpha=0.3))
    state, _, _ = TR.create_train_state(cfg, seed=2, periods=(2,), device="cpu")
    mgr = TC.checkpoint_manager(str(tmp_path / "ckpt"))
    TC.save_train_state(mgr, 0, state)
    _same_entries(TC.extract_small_model(str(tmp_path / "ckpt"), str(tmp_path / "s.npz"), cfg),
                  TC.export_generator(str(tmp_path / "g.npz"), state.gen, cfg))


def _wait(router, job: str, timeout: float = 300.0) -> dict:
    deadline = time.time() + timeout
    while True:
        _code, status = router.dispatch("GET", f"/api/v1/rvc/job/{job}", {})
        if status["status"] != "running" or time.time() > deadline:
            return status
        time.sleep(0.2)


def test_train_resume_build_index_through_the_server(tmp_path):
    router = create_app(str(tmp_path / "process"), device="cpu")
    sr = 48000
    t = np.arange(int(sr * 2.0)) / sr
    p = tmp_path / "a.wav"
    write_wav(str(p), (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)
    files = [{"filename": "a.wav", "content": base64.b64encode(p.read_bytes()).decode()}]
    settings = {"epochs": 1, "batch_size": 2, "sr": sr, "feat_channels": 32,
                "slice_seconds": 0.8, "synth_overrides": SYNTH}
    code, resp = router.dispatch("POST", "/api/v1/rvc/train",
                                 {"files": files, "name": "tinyvoice", "settings": settings})
    assert code == 200
    status = _wait(router, resp["job_id"])
    assert status["status"] == "done", status
    assert all(np.isfinite(v) for v in status["result"]["metrics"].values())
    _code, models = router.dispatch("GET", "/api/v1/rvc/models", {})
    assert {"tinyvoice.npz", "tinyvoice.index.npz"} <= set(models["models"])
    exp = tmp_path / "models" / "exp" / "tinyvoice"
    first = json.loads((exp / "train_state.json").read_text())["step"]
    assert first == 1          # 3 slices of 0.8 s, batch 2: one step an epoch

    code, resp = router.dispatch("POST", "/api/v1/rvc/resume",
                                 {"name": "tinyvoice", "settings": settings | {"epochs": 2}})
    assert code == 200 and resp["resumed"]
    status = _wait(router, resp["job_id"])
    assert status["status"] == "done", status
    assert json.loads((exp / "train_state.json").read_text())["step"] == first + 1
    code, resp = router.dispatch("POST", "/api/v1/rvc/resume", {"name": "nobody"})
    assert code == 404

    code, resp = router.dispatch("POST", "/api/v1/rvc/build_index", {"name": "tinyvoice"})
    assert code == 200
    index = np.load(resp["index"])["features"]
    assert index.shape[1] == 32 and np.isfinite(index).all()

    tree, cfg = TC.load_generator(str(tmp_path / "models" / "rvc" / "tinyvoice.npz"))
    synth = TSy.SynthesizerTrn(cfg)
    synth.load_state_dict(W.synthesizer_from_jax(tree), strict=True)
    vc = VoiceConverter(synth, _hubert_apply_for(settings, "cpu"), index_features=index,
                        cfg=RVCPipelineConfig(f0_method="yin"), device="cpu")
    out = vc.convert((0.3 * np.sin(2 * np.pi * 200 * np.arange(16000) / 16000)
                      ).astype(np.float32), seed=0)
    assert out.shape == (sr,) and np.isfinite(out).all()


def test_chain_requests_during_a_training_job_leave_tf32_off(tmp_path, monkeypatch):
    """Chain requests that allow cuDNN's TF32 for their convolutions (as the
    bf16 policy does, for 0.2 s each) arrive while a training job runs: the
    job's device stages hold the inference lock, so every module of G and D
    in every step runs with TF32 off."""
    import threading

    from audiolab_tpu_torch.core import precision
    from audiolab_tpu_torch.serve import api
    from audiolab_tpu_torch.train import trainer

    def chain(*_a, **_kw):
        with precision._tf32_convolutions():
            time.sleep(0.2)
        return []

    flags = []
    real_state = trainer.create_train_state

    def create_train_state(*a, **kw):
        out = real_state(*a, **kw)
        for m in (*out[1].modules(), *out[2].modules()):
            m.register_forward_pre_hook(
                lambda *_: flags.append(torch.backends.cudnn.allow_tf32))
        return out

    monkeypatch.setattr(api, "run_chain", chain)
    monkeypatch.setattr(trainer, "create_train_state", create_train_state)
    router = create_app(str(tmp_path / "process"), device="cpu")
    sr = 48000
    t = np.arange(int(sr * 2.0)) / sr
    p = tmp_path / "a.wav"
    write_wav(str(p), (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)
    files = [{"filename": "a.wav", "content": base64.b64encode(p.read_bytes()).decode()}]
    settings = {"epochs": 2, "batch_size": 2, "sr": sr, "feat_channels": 32,
                "slice_seconds": 0.8, "synth_overrides": SYNTH}
    code, resp = router.dispatch("POST", "/api/v1/rvc/train",
                                 {"files": files, "name": "v", "settings": settings})
    assert code == 200
    done = threading.Event()
    requests = []

    def client():
        while not done.is_set():
            requests.append(router.dispatch("POST", "/api/v1/process/chain",
                                            {"files": files, "processors": ["Merge"]})[0])
            time.sleep(0.02)

    thread = threading.Thread(target=client)
    thread.start()
    try:
        status = _wait(router, resp["job_id"])
    finally:
        done.set()
        thread.join()
    assert status["status"] == "done", status
    assert len(requests) >= 2 and set(requests) == {200}
    assert flags and not any(flags), f"{sum(flags)} of {len(flags)} modules ran with TF32 on"
    assert torch.backends.cudnn.allow_tf32 is False


def test_update_job_reports_progress():
    job = rvc_api.submit_job(lambda job_id: rvc_api.update_job(job_id, 0.5, "half") or 1)
    deadline = time.time() + 10
    while rvc_api._JOBS[job]["status"] == "running" and time.time() < deadline:
        time.sleep(0.01)
    assert rvc_api._JOBS[job]["status"] == "done"
    assert rvc_api._JOBS[job]["message"] == "half"
    rvc_api.update_job("nope", 0.1, "unknown jobs are ignored")


def test_voice_names_stay_one_path_component(tmp_path):
    """A voice name is joined into the server's folders: the routes keep its
    last component and refuse ``..`` (the JAX routes join it unchecked)."""
    assert rvc_api._voice_name({"name": "../../etc/voice"}) == "voice"
    router = create_app(str(tmp_path / "process"), device="cpu")
    for route in ("resume", "build_index"):
        code, resp = router.dispatch("POST", f"/api/v1/rvc/{route}", {"name": ".."})
        assert code == 400 and "bad voice name" in resp["error"]
    code, _ = router.dispatch("POST", "/api/v1/rvc/train", {"name": "../x", "files": []})
    assert code == 200
    assert (tmp_path / "datasets" / "x").is_dir() and not (tmp_path.parent / "x").exists()
