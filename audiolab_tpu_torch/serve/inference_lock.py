"""Global inference lock (counterpart of audiolab_tpu/serve/inference_lock.py):
the stdlib HTTP server is threaded, but requests that run models on the
card must serialize — the processors share one separator and one converter,
whose config a Clone request rewrites, and concurrent passes would split
the card's memory (the reference is effectively serial too: one Gradio
queue, one GPU)."""

from __future__ import annotations

import threading

INFERENCE_LOCK = threading.RLock()
