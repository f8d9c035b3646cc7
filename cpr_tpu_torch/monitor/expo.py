"""The `--metrics-port` HTTP exposition endpoint.

Port of cpr_tpu/monitor/expo.py, host only: the same code with its imports
from cpr_tpu_torch.

A stdlib `ThreadingHTTPServer` on a daemon thread serving GET
`/metrics` (and `/`) as Prometheus text format 0.0.4 — zero new
dependencies, invisible to the asyncio serve loop.  The server takes a
`render` callable rather than a registry so a process can compose its
payload (the router concatenates its own registry with fleet-board
gauges); whatever `render` returns at scrape time is the body, so the
exposition is always as live as the underlying counters.

Port 0 binds an ephemeral port; `start()` returns the bound port and
callers publish it (the serve ready-file gains a `metrics_port` key)
so scrapers can find it without a fixed allocation.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cpr_tpu_torch.monitor.registry import PROMETHEUS_CONTENT_TYPE

log = logging.getLogger(__name__)


class MetricsServer:
    """Daemon-thread HTTP scrape endpoint around one render callable."""

    def __init__(self, render, host: str = "127.0.0.1", port: int = 0):
        self._render = render
        self.host = host
        self.port = port  # replaced by the bound port after start()
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        render = self._render

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = render().encode("utf-8")
                except Exception as e:  # noqa: BLE001 — a broken render
                    # must 500 the scrape, never kill the serve process
                    log.warning("metrics render failed: %r", e)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not stderr news
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="cpr-metrics",
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
