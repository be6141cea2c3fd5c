"""The scrape surface: ``/metrics`` (+``/healthz``) over a registry.

The port's copy of ``kubeflow_tpu/obs/http.py``.

Every long-running process grows the same two endpoints the serving
stack already had: the controller manager and the scheduler via
``python -m kubeflow_tpu.controllers --metrics-port``, workers via
``spec.observability.metricsPort``, probers via the support
MetricsServer. Components can mount extra endpoints through
``handlers`` — the worker uses this for the on-demand profiler trigger
(``POST /profile?steps=N``) and the flight-recorder peek
(``GET /flightrecorder``) without growing a second HTTP stack. stdlib
only — mirrors webapps/_http.py's threaded-server lifecycle without
making the base ``obs`` layer depend on webapps.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .registry import Registry, default_registry

# a mounted endpoint: (method, path) -> callable(query: dict) returning
# (status_code, json-serializable body)
Handler = Callable[[dict], tuple]


class ObsServer:
    """Serves ``registry.render()`` on ``/metrics``, a liveness
    ``/healthz``, and any mounted ``handlers``; daemon thread, ephemeral
    port when ``port=0``."""

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "0.0.0.0", port: int = 0,
                 name: str = "obs-metrics",
                 handlers: Optional[dict] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.name = name
        registry_ref = self.registry
        handlers_ref = dict(handlers or {})

        class RequestHandler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self, method: str) -> None:
                path, _, rawq = self.path.partition("?")
                path = path.rstrip("/")
                handler = handlers_ref.get((method, path))
                if handler is None:
                    self._send(404, b"not found", "text/plain")
                    return
                query = {k: v[0] for k, v in
                         urllib.parse.parse_qs(rawq).items()}
                try:
                    code, body = handler(query)
                except Exception as e:  # noqa: BLE001 — a handler bug
                    # must not kill the scrape surface's server thread
                    code, body = 500, {"error": f"{type(e).__name__}: {e}"}
                self._send(code, json.dumps(body).encode(),
                           "application/json")

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics":
                    self._send(200, registry_ref.render().encode(),
                               "text/plain; version=0.0.4")
                elif path in ("/healthz", ""):
                    self._send(200, b'{"ok": true}', "application/json")
                else:
                    self._dispatch("GET")

            def do_POST(self):
                # drain any body so keep-alive connections stay in sync;
                # handler inputs ride the query string
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
                self._dispatch("POST")

        self._httpd = ThreadingHTTPServer((host, port), RequestHandler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name=self.name)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
