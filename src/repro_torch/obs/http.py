"""Stdlib HTTP metrics endpoint (a copy of ``repro.obs.http``):

``start_metrics_server(registry, port)`` spins a daemon
``ThreadingHTTPServer`` serving

  * ``GET /metrics``       — Prometheus text exposition 0.0.4
  * ``GET /metrics.json``  — the registry's JSON snapshot (what
                             ``python -m repro_torch.obs.report`` renders)
  * ``GET /healthz``       — 200 "ok"

and returns a handle with ``.port`` (useful with ``port=0``) and
``.close()``.  Wired into ``python -m repro_torch.launch.serve --metrics-port``.
"""
from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger("repro_torch.obs")

__all__ = ["MetricsServer", "start_metrics_server"]


class _Handler(BaseHTTPRequestHandler):
    registry = None                   # set on the per-server subclass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype + "; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):                 # noqa: N802 (stdlib handler API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            self._send(200, self.registry.to_prometheus(),
                       "text/plain; version=0.0.4")
        elif path == "/metrics.json":
            self._send(200, self.registry.to_json(), "application/json")
        elif path == "/healthz":
            self._send(200, "ok\n", "text/plain")
        else:
            self._send(404, f"not found: {path}\n", "text/plain")

    def log_message(self, fmt, *args):   # route to logging, not stderr
        log.debug("metrics http: " + fmt, *args)


class MetricsServer:
    """A running metrics endpoint; ``close()`` stops it."""

    def __init__(self, registry, port: int = 9100, host: str = "0.0.0.0"):
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()
        log.info("metrics endpoint on http://%s:%d/metrics",
                 self.host, self.port)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(registry=None, port: int = 9100,
                         host: str = "0.0.0.0") -> MetricsServer:
    """Serve ``registry`` (default: the process-wide one) over HTTP."""
    if registry is None:
        from .metrics import default_registry
        registry = default_registry()
    return MetricsServer(registry, port=port, host=host)
