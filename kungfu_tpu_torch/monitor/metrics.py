"""Network monitoring: egress/ingress counters, rates, ``/metrics``
(port of ``kungfu_tpu/monitor/metrics.py``).

Per-remote-peer byte counters sampled into rates every
``KF_CONFIG_MONITORING_PERIOD`` seconds (default 1), fed by both host
channels (:mod:`kungfu_tpu_torch.comm.host`) and exposed through an HTTP
``/metrics`` endpoint at ``worker port + 10000`` and through
:meth:`NetMonitor.egress_rates` (``Peer.get_egress_rates``).  Enabled by
``KF_CONFIG_ENABLE_MONITORING``.  :func:`publish_device_memory` feeds the
card's allocator gauges to the rank reporter.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils.envs import MONITORING_PERIOD
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("metrics")

DEFAULT_PERIOD_S = 1.0
METRICS_PORT_OFFSET = 10000  # reference peer.go:92


class _RateCounter:
    __slots__ = ("total", "last_total", "rate")

    def __init__(self):
        self.total = 0
        self.last_total = 0
        self.rate = 0.0

    def sample(self, dt: float):
        d = self.total - self.last_total
        self.rate = d / dt if dt > 0 else 0.0
        self.last_total = self.total


class NetMonitor:
    """Byte counters per remote address, sampled into rates periodically."""

    def __init__(self, period: float = DEFAULT_PERIOD_S):
        self.period = period
        self._egress: Dict[str, _RateCounter] = defaultdict(_RateCounter)
        self._ingress: Dict[str, _RateCounter] = defaultdict(_RateCounter)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def egress(self, addr: str, nbytes: int) -> None:
        with self._lock:
            self._egress[addr].total += nbytes

    def ingress(self, addr: str, nbytes: int) -> None:
        with self._lock:
            self._ingress[addr].total += nbytes

    def _sample_loop(self):
        t0 = time.time()
        while not self._stop.wait(self.period):
            now = time.time()
            dt, t0 = now - t0, now
            with self._lock:
                for c in self._egress.values():
                    c.sample(dt)
                for c in self._ingress.values():
                    c.sample(dt)
                eg = sum(c.total for c in self._egress.values())
                ing = sum(c.total for c in self._ingress.values())
            # mirror the aggregate totals into the unified registry so
            # they render alongside the timeline/engine metrics (the
            # per-peer breakdown stays in render_prometheus — mirroring
            # it per label would double every line)
            REGISTRY.gauge("kf_net_egress_bytes").set(eg)
            REGISTRY.gauge("kf_net_ingress_bytes").set(ing)

    def start(self) -> "NetMonitor":
        self._thread = threading.Thread(target=self._sample_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def egress_rates(self, addrs: Optional[List[str]] = None) -> List[float]:
        """Bytes/sec toward each addr (reference GetEgressRates)."""
        with self._lock:
            if addrs is None:
                addrs = sorted(self._egress)
            return [self._egress[a].rate if a in self._egress else 0.0 for a in addrs]

    def totals(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                "egress": {a: c.total for a, c in self._egress.items()},
                "ingress": {a: c.total for a, c in self._ingress.items()},
            }

    def render_prometheus(self, extra: Optional[Dict[str, float]] = None) -> str:
        lines = []
        with self._lock:
            for a, c in sorted(self._egress.items()):
                lines.append(f'kf_egress_bytes_total{{peer="{a}"}} {c.total}')
                lines.append(f'kf_egress_bytes_per_sec{{peer="{a}"}} {c.rate:.1f}')
            for a, c in sorted(self._ingress.items()):
                lines.append(f'kf_ingress_bytes_total{{peer="{a}"}} {c.total}')
                lines.append(f'kf_ingress_bytes_per_sec{{peer="{a}"}} {c.rate:.1f}')
        for k, v in (extra or {}).items():
            lines.append(f"{k} {v}")
        return "\n".join(lines) + "\n"


class MetricsServer:
    """HTTP ``/metrics`` endpoint (reference ``monitor/server.go``).

    Renders the :class:`NetMonitor` per-peer counters AND the unified
    :data:`~kungfu_tpu_torch.monitor.registry.REGISTRY` (collective latency
    histograms, retry/fault/shrink counters, timeline drop counter) in
    one scrape.

    Binding: ``port=0`` asks the OS for an ephemeral port; a *taken*
    fixed port degrades to an ephemeral bind with a warning instead of
    an unhandled ``OSError`` — a stale process squatting
    worker-port+10000 must not kill the peer.  So does a port past 65535
    (a worker on a port above 55535), where the reference's raises
    ``OverflowError`` (ROADMAP C25).  :attr:`port` always holds the port
    actually bound."""

    def __init__(self, monitor: NetMonitor, port: int, host: str = "0.0.0.0",
                 extra_fn=None):
        mon = monitor

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                _log.debug(fmt, *args)

            def do_GET(self):
                if not self.path.startswith("/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                # section isolation: a raised exception inside a user
                # extra_fn (or a render bug in one section) must not 500
                # the whole scrape — Prometheus would mark the target
                # down and every OTHER healthy series would vanish with
                # it.  Render what renders; report the rest as comment
                # lines (legal exposition-format noise).
                errors: list = []
                extra = None
                if extra_fn is not None:
                    try:
                        extra = extra_fn()
                    except Exception as e:  # noqa: BLE001 - user callback
                        errors.append(f"extra_fn: {type(e).__name__}: {e}")
                try:
                    text = mon.render_prometheus(extra)
                except Exception as e:  # noqa: BLE001
                    text = ""
                    errors.append(f"netmonitor: {type(e).__name__}: {e}")
                try:
                    text += REGISTRY.render_prometheus()
                except Exception as e:  # noqa: BLE001
                    errors.append(f"registry: {type(e).__name__}: {e}")
                for err in errors:
                    _log.warning("metrics scrape section failed: %s", err)
                    text += "# error: " + err.replace("\n", " ") + "\n"
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            self._server = ThreadingHTTPServer((host, port), Handler)
        except (OSError, OverflowError) as e:
            if port == 0:
                raise
            _log.warning(
                "metrics port %d unavailable (%s); binding an ephemeral "
                "port instead", port, e,
            )
            self._server = ThreadingHTTPServer((host, 0), Handler)
        self._server.daemon_threads = True
        #: the port actually bound (differs from the request under
        #: port=0 or the taken-port fallback)
        self.port = self._server.server_address[1]

    def start(self) -> "MetricsServer":
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def monitoring_period_from_env() -> float:
    import os

    try:
        return float(os.environ.get(MONITORING_PERIOD, DEFAULT_PERIOD_S))
    except ValueError:
        return DEFAULT_PERIOD_S


def publish_device_memory() -> bool:
    """Poll the local cards' allocator into the registry:
    ``kf_device_memory_bytes{kind="in_use"|"limit"}`` summed over the
    visible CUDA devices (``torch.cuda.memory_allocated`` and each
    device's total memory).  Returns False, publishing nothing, where
    there is no CUDA device, as the reference's does on a CPU backend;
    it never raises, because a raise in the reporter's
    ``pre_snapshot_fn`` would cost the snapshot its event window."""
    try:
        import torch

        if not torch.cuda.is_available():
            return False
        n = torch.cuda.device_count()
        in_use = sum(int(torch.cuda.memory_allocated(d)) for d in range(n))
        limit = sum(int(torch.cuda.get_device_properties(d).total_memory)
                    for d in range(n))
    except Exception:  # noqa: BLE001 - monitoring must not raise
        return False
    if n == 0:
        return False
    REGISTRY.gauge("kf_device_memory_bytes", kind="in_use").set(in_use)
    if limit:
        REGISTRY.gauge("kf_device_memory_bytes", kind="limit").set(limit)
    return True
