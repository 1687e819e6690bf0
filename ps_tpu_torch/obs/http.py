"""The opt-in Prometheus /metrics endpoint, one a process.

Counterpart of ``ps_tpu/obs/http.py``. ``metrics_port``
(``PS_METRICS_PORT``) starts a small threaded HTTP server bound to
``bind`` (loopback by default) that serves the process registry as
Prometheus text at ``/metrics``. Port 0 binds an ephemeral port (read
``.port``); unset serves nothing and costs nothing.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["MetricsServer", "start_metrics_server", "stop_metrics_server"]


class MetricsServer:
    """Threaded HTTP server for one registry's /metrics."""

    def __init__(self, port: int = 0, bind: str = "127.0.0.1",
                 registry=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from ps_tpu_torch.obs.metrics import default_registry

        reg = registry if registry is not None else default_registry()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    body = reg.render_prometheus().encode()
                except Exception as e:  # scrape must see the failure
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(repr(e).encode())
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not stderr news
                pass

        self._httpd = ThreadingHTTPServer((bind, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._t = threading.Thread(target=self._httpd.serve_forever,
                                   daemon=True, name="ps-metrics-http")
        self._t.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._t.join(timeout=5)


_server: Optional[MetricsServer] = None
_lock = threading.Lock()


def start_metrics_server(port: Optional[int] = None,
                         bind: str = "127.0.0.1") -> Optional[MetricsServer]:
    """Start (or return) the process's /metrics server. ``port=None``
    reads ``PS_METRICS_PORT``; still-None means disabled (returns None).
    Idempotent: the first successful start wins — later calls return the
    live server regardless of the port they asked for (one process, one
    scrape target)."""
    global _server
    if port is None:
        from ps_tpu_torch.config import env_int

        # a validated service-level read: unset or blank keeps the
        # endpoint disabled
        port = env_int("PS_METRICS_PORT", None, lo=0, hi=65535)
        if port is None:
            return _server
    err: Optional[OSError] = None
    with _lock:
        if _server is None:
            try:
                _server = MetricsServer(port=port, bind=bind)
            except OSError as e:
                # a second process on the host with the same fixed port
                # (primary + backup services, mp drills): the opt-in
                # endpoint must NEVER take the data plane down with it.
                # The warning is emitted below, after the lock: logging
                # does its own locking and I/O.
                err = e
        server = _server
    if err is not None:
        import logging

        logging.getLogger(__name__).warning(
            "/metrics endpoint disabled: could not bind %s:%s "
            "(%s) — another process on this host probably holds "
            "the port; give each process its own PS_METRICS_PORT",
            bind, port, err)
        return None
    return server


def stop_metrics_server() -> None:
    global _server
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
