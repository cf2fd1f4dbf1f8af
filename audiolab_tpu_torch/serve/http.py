"""Minimal threaded JSON HTTP server (stdlib only; counterpart of
audiolab_tpu/serve/http.py, a copy of its framework-free code).

The reference serves its REST surface through FastAPI+uvicorn (api.py,
main.py:200-216); this environment ships neither, so the same endpoint
table (SURVEY §2.4) is served by a small router on http.server.  The
route registry doubles as the OpenAPI document source.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

Handler = Callable[[dict, dict], Any]  # (path_params, body) -> response


class RawResponse:
    """Non-JSON response (HTML/JS/binary) from a route handler."""

    def __init__(self, body: bytes | str, content_type: str = "text/html",
                 headers: dict[str, str] | None = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.content_type = content_type
        self.headers = dict(headers or {})


class Route:
    def __init__(self, method: str, pattern: str, fn: Handler, description: str = ""):
        self.method = method
        self.pattern = pattern
        self.description = description
        self.fn = fn
        self.regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )


class Router:
    def __init__(self):
        self.routes: list[Route] = []

    def add(self, method: str, pattern: str, fn: Handler, description: str = "") -> None:
        self.routes.append(Route(method.upper(), pattern, fn, description))

    def get(self, pattern: str, description: str = ""):
        def deco(fn):
            self.add("GET", pattern, fn, description)
            return fn

        return deco

    def post(self, pattern: str, description: str = ""):
        def deco(fn):
            self.add("POST", pattern, fn, description)
            return fn

        return deco

    def dispatch(self, method: str, path: str, body: dict) -> tuple[int, Any]:
        for route in self.routes:
            if route.method != method:
                continue
            m = route.regex.match(path)
            if m:
                try:
                    result = route.fn(m.groupdict(), body)
                    return 200, result
                except FileNotFoundError as e:
                    return 404, {"error": str(e)}
                except (ValueError, KeyError) as e:
                    return 400, {"error": str(e)}
                except NotImplementedError as e:
                    return 501, {"error": str(e) or "not implemented"}
                except Exception as e:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()
                    return 500, {"error": f"{type(e).__name__}: {e}"}
        return 404, {"error": f"no route {method} {path}"}

    def openapi(self) -> dict:
        paths: dict[str, dict] = {}
        for r in self.routes:
            paths.setdefault(r.pattern, {})[r.method.lower()] = {
                "description": r.description
            }
        return {
            "openapi": "3.1.0",
            "info": {"title": "audiolab_tpu", "version": "0.1.0"},
            "paths": paths,
        }


def make_handler(router: Router):
    class JSONHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _respond(self, code: int, payload: Any) -> None:
            extra = {}
            if isinstance(payload, RawResponse):
                data, ctype = payload.body, payload.content_type
                extra = payload.headers
            else:
                data, ctype = json.dumps(payload).encode(), "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for hk, hv in extra.items():
                self.send_header(hk, hv)
            # "*" mirrors the reference's CORS policy (api.py:98-104); an
            # operator can pin it (e.g. to the UI origin) via env.
            self.send_header(
                "Access-Control-Allow-Origin",
                os.environ.get("AUDIOLAB_CORS_ORIGIN", "*"),
            )
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            code, payload = router.dispatch("GET", self.path.split("?")[0], {})
            self._respond(code, payload)

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b"{}"
            try:
                body = json.loads(raw) if raw.strip() else {}
            except json.JSONDecodeError:
                self._respond(400, {"error": "invalid JSON body"})
                return
            code, payload = router.dispatch("POST", self.path.split("?")[0], body)
            self._respond(code, payload)

        def log_message(self, fmt, *args):  # quiet
            pass

    return JSONHandler


def serve_forever(router: Router, host: str = "127.0.0.1", port: int = 7860):
    server = ThreadingHTTPServer((host, port), make_handler(router))
    server.serve_forever()


def serve_background(router: Router, host: str = "127.0.0.1", port: int = 0):
    """Start in a daemon thread; returns (server, actual_port)."""
    server = ThreadingHTTPServer((host, port), make_handler(router))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]
