"""HTTP cluster-config store (trimmed copy of
``kungfu_tpu/elastic/configserver.py``).

The reference's REST contract (``elastic/configserver/configserver.go:
24-112``), routes and JSON documents alike:

* ``GET  /get``   -> ``{"version": N, "cluster": {...}}`` (404 when cleared)
* ``PUT  /put``   -> body = cluster JSON; validated; version + 1
* ``POST /reset`` -> body = cluster JSON; reset to version 0
* ``DELETE /``    -> clear
* ``GET  /stop``  -> shut the server down

With a :class:`~kungfu_tpu_torch.monitor.aggregator.ClusterAggregator`
mounted (``aggregator=``), two more routes serve the live cluster plane:

* ``POST /push``    -> rank snapshot or control event into ``ingest``
  (400 on a malformed payload)
* ``GET  /cluster`` -> the rolling cluster view (JSON)

* ``GET  /metrics`` -> the cluster plane's Prometheus text followed by
  this process's registry

Without one they answer 404, as the reference's do.  ``/alerts`` and
``/decisions`` answer 404 until ROADMAP A9b ports the sentinel.

``python -m kungfu_tpu_torch.elastic.configserver [-port P] [-host H]
[-monitor]`` runs one alone (the reference's ``kf-config-server``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kungfu_tpu_torch.comm.host import POLL_INTERVAL_S
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("config-server")

#: the reference's sentinel routes, which wait for ROADMAP A9b (404)
_A9B_ROUTES = ("/alerts", "/decisions")


class ConfigServer:
    """The versioned cluster document behind an HTTP server.  ``port=0``
    binds a port the OS assigns; :attr:`port` and :attr:`url` report the
    bound one.  :meth:`start` serves on a daemon thread, :meth:`stop`
    shuts it down."""

    def __init__(self, port: int = 9100, cluster: Optional[Cluster] = None,
                 host: str = "0.0.0.0", aggregator=None):
        self._lock = threading.Lock()
        self._cluster = cluster
        self._version = 0
        self._thread: Optional[threading.Thread] = None
        #: mounted live-monitoring plane (None: its routes answer 404)
        self.aggregator = aggregator
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                _log.debug(fmt, *args)

            def _reply(self, code: int, body: bytes = b"",
                       content_type: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
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
                if self.path.startswith("/cluster"):
                    agg = srv.aggregator
                    if agg is None:
                        self._reply(404, b'{"error": "no aggregator"}')
                        return
                    view = agg.cluster_view(srv._cluster_info())
                    self._reply(200, json.dumps(view).encode())
                    return
                if self.path.startswith(_A9B_ROUTES):
                    self._reply(404, b'{"error": "no sentinel"}')
                    return
                if self.path.startswith("/metrics"):
                    agg = srv.aggregator
                    if agg is None:
                        self._reply(404, b'{"error": "no aggregator"}')
                        return
                    # the cluster view and this process's own registry
                    # (the aggregator ticks its control-event counter there)
                    text = (agg.render_prometheus(srv._cluster_info())
                            + REGISTRY.render_prometheus())
                    self._reply(200, text.encode(),
                                content_type="text/plain; version=0.0.4")
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
                if self.path.startswith("/push"):
                    agg = srv.aggregator
                    n = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(n)
                    if agg is None:
                        self._reply(404, b'{"error": "no aggregator"}')
                        return
                    try:
                        agg.ingest(json.loads(body.decode()))
                    except (ValueError, KeyError) as e:
                        self._reply(400,
                                    json.dumps({"error": str(e)}).encode())
                        return
                    self._reply(200, b"{}")
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

    def _cluster_info(self) -> Optional[dict]:
        """``{version, size, workers}`` for the aggregator's cluster
        health, or None when no cluster is stored.  The config lock is
        released before the aggregator's own lock is taken."""
        version, cluster = self.snapshot()
        if cluster is None:
            return None
        return {
            "version": version,
            "size": cluster.size(),
            "workers": [str(w) for w in cluster.workers],
        }


def main(argv=None) -> int:
    """A config server alone (reference ``configserver.py:205``, the
    ``kf-config-server`` entry).  ``-monitor`` mounts the cluster
    aggregator (``/push``, ``/cluster``, ``/metrics``)."""
    import argparse
    import time

    p = argparse.ArgumentParser(prog="kf-config-server")
    p.add_argument("-port", type=int, default=9100)
    p.add_argument("-host", default="0.0.0.0")
    p.add_argument("-monitor", action="store_true",
                   help="mount the live cluster aggregator "
                        "(/push, /cluster, /metrics)")
    ns = p.parse_args(argv)
    aggregator = None
    if ns.monitor:
        from kungfu_tpu_torch.monitor.aggregator import ClusterAggregator

        aggregator = ClusterAggregator()
    srv = ConfigServer(port=ns.port, host=ns.host,
                       aggregator=aggregator).start()
    _log.info("config server listening on %s:%d", ns.host, srv.port)
    try:
        while srv._thread is not None and srv._thread.is_alive():
            time.sleep(0.5)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
