"""Served-file registry (counterpart of audiolab_tpu/serve/files.py):
generation endpoints register outputs under short ids; download/stream
endpoints return them (the reference's /api/v1/*/download/... and
/api/v1/yue/stream/{id} routes)."""

from __future__ import annotations

import os
import threading
import uuid

_FILES: dict[str, str] = {}
_LOCK = threading.Lock()


def register_file(path: str) -> str:
    fid = uuid.uuid4().hex[:12]
    with _LOCK:
        _FILES[fid] = os.path.abspath(path)
    return fid


def get_file(fid: str) -> str:
    with _LOCK:
        path = _FILES.get(fid)
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"unknown file id {fid}")
    return path


def file_response(fid: str):
    """RAW file bytes with download headers — the reference's download
    routes stream FileResponse bodies (e.g. layouts/tts.py speech
    download), not JSON envelopes."""
    import mimetypes

    from audiolab_tpu_torch.serve.http import RawResponse

    path = get_file(fid)
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.basename(path)
    ctype = mimetypes.guess_type(name)[0] or "application/octet-stream"
    return RawResponse(data, content_type=ctype, headers={
        "Content-Disposition": f'attachment; filename="{name}"'})
