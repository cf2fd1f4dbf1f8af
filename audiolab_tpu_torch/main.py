"""Server entry point (counterpart of audiolab_tpu/main.py; reference:
main.py — CLI flags --listen/--port/--api-only, logging setup with per-lib
silencing, graceful shutdown).

    python -m audiolab_tpu_torch.main --port 7860            # on the card
    python -m audiolab_tpu_torch.main --port 7860 --device cpu

The REST surface and the web UI at / are served by the stdlib server; the
processors run their DSP on ``--device``, which defaults to the card and
fails without one.  Models are injected through the processors'
``configure`` by a caller that has weights.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from http.server import ThreadingHTTPServer

# the models each --demo-backends backend needs, by ROADMAP queue 1 item
DEMO_BACKEND_ITEMS = ("17 (TTS: zonos, coqui, chatterbox)",
                      "18 (music: stable_audio, acestep, yue)",
                      "19 (transcription: whisper)")


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
    )
    for noisy in ("urllib3", "matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("audiolab_tpu_torch")
    parser.add_argument("--listen", action="store_true", help="bind 0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--api-only", action="store_true", help="REST only (default: also UI when available)")
    parser.add_argument("--output-root", default="outputs/process")
    parser.add_argument(
        "--demo-backends", action="store_true",
        help="register random-weight generation backends (tts/music/"
             "transcribe); the port has none of their models yet")
    parser.add_argument("--device", default="cuda",
                        help="where the processors run (default: the card)")
    args = parser.parse_args(argv)

    setup_logging()
    log = logging.getLogger("audiolab_tpu_torch")

    if args.demo_backends:
        log.error("--demo-backends: the port has no TTS, music or transcription "
                  "models yet (ROADMAP queue 1, items %s)", ", ".join(DEMO_BACKEND_ITEMS))
        return 2

    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import make_handler

    router = create_app(output_root=args.output_root, device=args.device)
    host = "0.0.0.0" if args.listen else "127.0.0.1"
    server = ThreadingHTTPServer((host, args.port), make_handler(router))

    def shutdown(_sig, _frame):
        log.info("shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    log.info("serving on http://%s:%d (api at /api/v1, device %s)", host, args.port,
             args.device)
    server.serve_forever()
    server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
