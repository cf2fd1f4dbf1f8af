"""Server entry point (counterpart of audiolab_tpu/main.py; reference:
main.py — CLI flags --listen/--port/--api-only, logging setup with per-lib
silencing, graceful shutdown).

    python -m audiolab_tpu_torch.main --port 7860            # on the card
    python -m audiolab_tpu_torch.main --port 7860 --device cpu

The REST surface and the web UI at / are served by the stdlib server; the
processors run their DSP on ``--device``, which defaults to the card and
fails without one.  Models are injected through the processors'
``configure`` by a caller that has weights.  ``--demo-backends`` registers
a random-weight Zonos as the "zonos" TTS engine, the random XTTS as "coqui",
the random Chatterbox as "chatterbox", the random Whisper transcriber as
"whisper", and the random Stable Audio and ACE-Step as the "stable_audio"
and "acestep" music backends on ``--device``, as the JAX server does, and
names the engines the port does not have yet.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from http.server import ThreadingHTTPServer

# the JAX server's demo engines the port has no model for yet, by ROADMAP
# queue 1 item
MISSING_DEMO_BACKENDS = {"18c (YuE)": ("yue",)}


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
    )
    for noisy in ("urllib3", "matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


def register_demo_backends(device: str, log: logging.Logger) -> None:
    """Register the random-weight demo engines the port has (Zonos as
    "zonos", the XTTS engine as "coqui", Chatterbox as "chatterbox", the
    Whisper transcriber as "whisper", Stable Audio as "stable_audio" and
    ACE-Step as "acestep", on ``device``) and log the ones it does not have
    yet."""
    from audiolab_tpu_torch.pipelines.acestep import random_acestep
    from audiolab_tpu_torch.pipelines.music import random_stable_audio
    from audiolab_tpu_torch.pipelines.transcribe import random_transcriber
    from audiolab_tpu_torch.pipelines.tts import random_chatterbox, random_xtts, random_zonos
    from audiolab_tpu_torch.serve import music_api, transcribe_api, tts_api

    log.info("loading demo (random-weight) backends on %s: zonos, coqui, chatterbox, "
             "whisper, stable_audio, acestep", device)
    tts_api.register_backend("zonos", random_zonos(device=device))
    tts_api.register_backend("coqui", random_xtts(device=device))
    tts_api.register_backend("chatterbox", random_chatterbox(device=device))
    transcribe_api.register_backend("whisper", random_transcriber(device=device))
    music_api.register_backend("stable_audio", random_stable_audio(device=device))
    music_api.register_backend("acestep", random_acestep(device=device))
    log.warning("--demo-backends: the port has no model yet for %s",
                "; ".join(f"{', '.join(names)} (ROADMAP queue 1, item {item})"
                          for item, names in MISSING_DEMO_BACKENDS.items()))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("audiolab_tpu_torch")
    parser.add_argument("--listen", action="store_true", help="bind 0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--api-only", action="store_true", help="REST only (default: also UI when available)")
    parser.add_argument("--output-root", default="outputs/process")
    parser.add_argument(
        "--demo-backends", action="store_true",
        help="register random-weight generation backends (the port has the zonos, coqui "
             "and chatterbox TTS engines, the whisper transcriber and the stable_audio "
             "and acestep music backends; yue is logged as missing)")
    parser.add_argument("--device", default="cuda",
                        help="where the processors run (default: the card)")
    args = parser.parse_args(argv)

    setup_logging()
    log = logging.getLogger("audiolab_tpu_torch")

    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import make_handler

    router = create_app(output_root=args.output_root, device=args.device)
    if args.demo_backends:
        register_demo_backends(args.device, log)
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
