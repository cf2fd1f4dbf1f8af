"""Multi-take alignment endpoint (counterpart of audiolab_tpu/serve/align_api.py;
reference layouts/align.py: align takes to a master track via word timings,
sentence matching and time warping).

POST /api/v1/align with base64 WAV files: the first file is the master,
the rest are takes.  Word timings come from the registered transcription
backend when one is registered and finds words, else from the energy
aligner over one synthetic segment (pipelines/forced_align.py).  The
features are taken on the app's device; the work holds the inference lock.
"""

from __future__ import annotations

import base64
import os
import tempfile

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio, write_audio
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.pipelines.align import align_take
from audiolab_tpu_torch.pipelines.forced_align import energy_align_words
from audiolab_tpu_torch.serve.inference_lock import INFERENCE_LOCK

_TRANSCRIBER: list[object] = []


def register_transcriber(backend) -> None:
    """Optional: word timings from a transcription engine
    (``.transcribe(path) -> dict`` with word-timed segments)."""
    _TRANSCRIBER[:] = [backend]


def _words_of(path: str) -> tuple[np.ndarray, int, list[dict]]:
    a = read_audio(path).to_mono()
    x = np.asarray(a.samples[0], np.float32)
    if _TRANSCRIBER:
        res = _TRANSCRIBER[0].transcribe(path)
        words = [w for s in res.get("segments", []) for w in s.get("words", [])]
        if words:
            return x, a.sample_rate, words
    # no transcriber: pseudo-words from energy so structural alignment
    # still works (each voiced region becomes a "word")
    n_pseudo = max(4, int(len(x) / a.sample_rate * 2))
    words = energy_align_words(x, a.sample_rate, 0.0, len(x) / a.sample_rate,
                               [f"w{i}" for i in range(n_pseudo)])
    return x, a.sample_rate, words


def register(router, device: torch.device) -> None:
    """The align route; its features are taken on ``device``."""

    @router.post("/api/v1/align", "Align takes to a master track")
    def align(_params, body):
        files = body.get("files", [])
        if len(files) < 2:
            raise ValueError("need a master file and at least one take")
        out = []
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for f in files:
                p = os.path.join(tmp, os.path.basename(f.get("filename", f"in{len(paths)}.wav")))
                with open(p, "wb") as fh:
                    fh.write(base64.b64decode(f["content"]))
                paths.append(p)
            with INFERENCE_LOCK:
                master, sr, mwords = _words_of(paths[0])
                for i, p in enumerate(paths[1:], 1):
                    take, tsr, twords = _words_of(p)
                    if tsr != sr:
                        take = np.asarray(resample_poly_np(take, tsr, sr), np.float32)
                    aligned, report = align_take(master, take, sr, mwords, twords,
                                                 device=device)
                    op = os.path.join(tmp, f"aligned_{i}.wav")
                    write_audio(op, aligned, sr)
                    with open(op, "rb") as fh:
                        content = base64.b64encode(fh.read()).decode()
                    out.append({"filename": f"aligned_{i}.wav", "content": content,
                                "report": report})
        return {"results": out}
