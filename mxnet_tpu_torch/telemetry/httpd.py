"""Live metrics endpoint: stdlib-http ``/metrics`` + ``/healthz`` (ref:
``mxnet_tpu/telemetry/httpd.py``).

A tiny ``ThreadingHTTPServer`` on a daemon thread serving:

- ``GET /metrics``  — the default registry rendered as Prometheus text
  (format 0.0.4; point a scrape config at it);
- ``GET /healthz``  — liveness JSON (status, uptime, rank, pid).

``MXTPU_METRICS_PORT`` starts it at telemetry import; ``port=0`` binds
an ephemeral port (tests read ``server.port``).  No request touches
the training/serving threads: every number is read from the registry's
snapshot surfaces under their own locks.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..base import MXNetError, getenv
from . import metrics

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """One endpoint bound to one registry (default: the default
    registry).  ``start()`` returns self; ``stop()`` releases the
    port."""

    def __init__(self, port=None, host="0.0.0.0", registry=None):
        if port is None:
            port = getenv("METRICS_PORT", 0, int)
        self._port = int(port)
        self._host = host
        self._registry = registry or metrics.default_registry()
        self._httpd = None
        self._thread = None
        self._t0 = time.monotonic()

    @property
    def port(self):
        """The actually-bound port (resolves ``port=0``)."""
        if self._httpd is None:
            return self._port
        return self._httpd.server_address[1]

    def start(self):
        if self._httpd is not None:
            raise MXNetError("MetricsServer already started")
        registry = self._registry
        t0 = self._t0

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                if path in ("/metrics", "/metrics/"):
                    metrics.count_scrape()
                    body = registry.render().encode()
                    self._reply(200, _CONTENT_TYPE, body)
                elif path in ("/healthz", "/health", "/healthz/"):
                    payload = {
                        "status": "ok",
                        "uptime_s": round(time.monotonic() - t0, 3),
                        "pid": os.getpid(),
                        "rank": _rank(),
                    }
                    hz = _health_payload()
                    if hz is not None:
                        # an armed HealthMonitor owns the verdict:
                        # status flips ok <-> degraded with its SLO
                        # rules; with no monitor this stays the plain
                        # liveness 200 above
                        payload.update(hz)
                    body = (json.dumps(payload) + "\n").encode()
                    self._reply(200, "application/json", body)
                else:
                    self._reply(404, "text/plain",
                                b"try /metrics or /healthz\n")

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log spam
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mxtpu-metrics-endpoint")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)
        self._httpd = None
        self._thread = None


def _health_payload():
    """The armed HealthMonitor's status dict, or None (no monitor) —
    a liveness probe must never fail because the interpretation layer
    hiccuped."""
    try:
        from . import health

        return health.healthz()
    except Exception:  # noqa: BLE001 — liveness answers regardless
        return None


def _rank():
    try:
        from ..parallel import dist

        return int(dist.rank())
    except Exception:  # noqa: BLE001 — pre-init: rank 0
        return 0


_server = None
_server_lock = threading.Lock()


def start_metrics_server(port=None, host="0.0.0.0", registry=None):
    """Start (or return) the process-wide endpoint singleton."""
    global _server
    with _server_lock:
        if _server is None:
            _server = MetricsServer(port=port, host=host,
                                    registry=registry).start()
        return _server


def stop_metrics_server():
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None


def metrics_server():
    """The running singleton, or None."""
    return _server
