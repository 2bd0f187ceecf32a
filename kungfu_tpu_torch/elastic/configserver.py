"""HTTP cluster-config store (trimmed copy of
``kungfu_tpu/elastic/configserver.py``).

The reference's REST contract (``elastic/configserver/configserver.go:
24-112``), routes and JSON documents alike:

* ``GET  /get``   -> ``{"version": N, "cluster": {...}}`` (404 when cleared)
* ``PUT  /put``   -> body = cluster JSON; validated; version + 1
* ``POST /reset`` -> body = cluster JSON; reset to version 0
* ``DELETE /``    -> clear
* ``GET  /stop``  -> shut the server down

The live-monitoring routes the reference mounts beside these
(``/push``, ``/cluster``, ``/metrics``, ``/alerts``, ``/decisions``)
come with the cluster aggregator; until then they answer 404, as the
reference's do when no aggregator is mounted.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kungfu_tpu_torch.comm.host import POLL_INTERVAL_S
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("config-server")

#: the reference's monitoring routes, 404 without an aggregator
_MONITOR_ROUTES = ("/push", "/cluster", "/metrics", "/alerts", "/decisions")


class ConfigServer:
    """The versioned cluster document behind an HTTP server.  ``port=0``
    binds a port the OS assigns; :attr:`port` and :attr:`url` report the
    bound one.  :meth:`start` serves on a daemon thread, :meth:`stop`
    shuts it down."""

    def __init__(self, port: int = 9100, cluster: Optional[Cluster] = None,
                 host: str = "0.0.0.0"):
        self._lock = threading.Lock()
        self._cluster = cluster
        self._version = 0
        self._thread: Optional[threading.Thread] = None
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                _log.debug(fmt, *args)

            def _reply(self, code: int, body: bytes = b""):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _cluster_body(self) -> Optional[Cluster]:
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    return Cluster.from_json(self.rfile.read(n).decode())
                except (ValueError, KeyError) as e:
                    self._reply(400, json.dumps({"error": str(e)}).encode())
                    return None

            def do_GET(self):
                if self.path.startswith("/stop"):
                    self._reply(200, b"{}")
                    threading.Thread(target=srv.stop, daemon=True).start()
                    return
                if self.path.startswith(_MONITOR_ROUTES):
                    self._reply(404, b'{"error": "no aggregator"}')
                    return
                with srv._lock:
                    if srv._cluster is None:
                        self._reply(404, b'{"error": "no cluster"}')
                        return
                    body = json.dumps(
                        {"version": srv._version,
                         "cluster": json.loads(srv._cluster.to_json())}
                    ).encode()
                self._reply(200, body)

            def do_PUT(self):
                cluster = self._cluster_body()
                if cluster is None:
                    return
                with srv._lock:
                    srv._cluster = cluster
                    srv._version += 1
                    v = srv._version
                _log.info("cluster updated to version %d (n=%d)", v,
                          cluster.size())
                self._reply(200, json.dumps({"version": v}).encode())

            def do_POST(self):
                if self.path.startswith(_MONITOR_ROUTES):
                    self._reply(404, b'{"error": "no aggregator"}')
                    return
                cluster = self._cluster_body()
                if cluster is None:
                    return
                with srv._lock:
                    srv._cluster = cluster
                    srv._version = 0
                self._reply(200, b'{"version": 0}')

            def do_DELETE(self):
                with srv._lock:
                    srv._cluster = None
                    srv._version = 0
                self._reply(200, b"{}")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        #: the bound port (the OS's choice when ``port`` is 0)
        self.port = self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/get"

    def start(self) -> "ConfigServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(POLL_INTERVAL_S,), daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def snapshot(self):
        with self._lock:
            return self._version, self._cluster
