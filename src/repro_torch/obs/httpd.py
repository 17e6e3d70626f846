"""Opt-in metrics endpoint for processes without a catalog server.

The catalog server already exposes ``/metrics``; the trainer, the
insitu CLI and bare benchmark processes had no scrape surface at all.
:func:`serve_metrics` starts a daemon-threaded stdlib HTTP server that
renders a :class:`~repro_torch.obs.metrics.MetricsRegistry` (the global
``REGISTRY`` by default) in the Prometheus text format, plus a JSON
twin and a tiny health probe:

  ``/metrics``  Prometheus text exposition (0.0.4)
  ``/snapshot`` the JSON snapshot of the same registry
  ``/healthz``  200 "ok" liveness probe

Wired to ``launch/train.py --metrics-port`` (and usable from anything
else: ``obs.serve_metrics(9090)``). ``port=0`` binds an ephemeral port
— read it back from the returned handle's ``.port``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import REGISTRY


class MetricsServer:
    """Handle for a running scrape endpoint; ``close()`` to stop."""

    def __init__(self, httpd: ThreadingHTTPServer,
                 thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_metrics(port: int = 0, *, host: str = "127.0.0.1",
                  registry=None) -> MetricsServer:
    """Start a background Prometheus scrape endpoint; returns a
    :class:`MetricsServer` (``.port``, ``.url``, ``.close()``)."""
    reg = REGISTRY if registry is None else registry

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0]
            if path in ("/metrics", "/"):
                body = reg.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/snapshot":
                body = json.dumps(reg.snapshot()).encode()
                ctype = "application/json"
            elif path == "/healthz":
                body, ctype = b"ok\n", "text/plain"
            else:
                self.send_error(404, "unknown path")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # scrape traffic is not news
            pass

    httpd = ThreadingHTTPServer((host, int(port)), _Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="obs-metrics-http", daemon=True)
    thread.start()
    return MetricsServer(httpd, thread)
