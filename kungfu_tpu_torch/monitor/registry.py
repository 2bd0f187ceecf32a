"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

Trimmed copy of ``kungfu_tpu/monitor/registry.py`` (stdlib only): the
same metric types, names, labels and percentile estimate, and the same
Prometheus exposition text (:meth:`MetricsRegistry.render_prometheus`,
which :class:`~kungfu_tpu_torch.monitor.metrics.MetricsServer` and the
config server's ``/metrics`` serve).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

#: default latency buckets (seconds): 100 µs .. 60 s, roughly log-spaced
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with min/max/percentile summaries."""

    __slots__ = ("buckets", "_counts", "_lock", "count", "sum", "min", "max")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        # one slot per finite bucket + the +Inf overflow slot
        self._counts = [0] * (len(self.buckets) + 1)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Estimated ``q``-quantile by linear interpolation inside the
        bucket holding the target rank; the open +Inf bucket reports the
        observed max."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            target = q * total
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                prev_cum = cum
                cum += c
                if cum < target:
                    continue
                if i == len(self.buckets):  # +Inf bucket
                    return self.max
                lo = self.buckets[i - 1] if i > 0 else min(self.min, self.buckets[i])
                hi = self.buckets[i]
                est = lo + (hi - lo) * (target - prev_cum) / c
                return min(max(est, self.min), self.max)
            return self.max

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0}
            base = {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max}
        base["p50"] = self.percentile(0.50)
        base["p95"] = self.percentile(0.95)
        base["p99"] = self.percentile(0.99)
        return base

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs, Prometheus-style; the final
        entry is ``(inf, total)``."""
        with self._lock:
            out = []
            cum = 0
            for le, c in zip(self.buckets, self._counts):
                cum += c
                out.append((le, cum))
            out.append((float("inf"), cum + self._counts[-1]))
            return out


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(labels[k]))}"'
                     for k in sorted(labels))
    return "{" + inner + "}"


#: ``# HELP`` text per metric family.  Stock Prometheus scrapers accept
#: samples without metadata, but exposition-format validators (and every
#: dashboard's tooltip) want the HELP/TYPE header — new metrics get a
#: generic line until someone writes a better one.
METRIC_HELP: Dict[str, str] = {
    "kf_collective_latency_seconds":
        "collective duration by plane (host engine / device) and op",
    "kf_engine_collectives_total":
        "engine collectives started (any op)",
    "kf_engine_retries_total":
        "engine send retries after transient wire faults",
    "kf_peer_faults_total":
        "per-peer deadline exhaustions raised as PeerFailureError",
    "kf_chaos_injections_total": "chaos faults injected, by clause kind",
    "kf_detector_down_total": "failure-detector down verdicts",
    "kf_shrink_events_total": "shrink-to-survivors phase events, by phase",
    "kf_strategy_swaps_total":
        "consensus-fenced strategy/schedule swaps (kf-adapt), by arm",
    "kf_host_pool_size":
        "host-plane responder/sender pool size (scaled with peer count)",
    "kf_slice_events_total":
        "slice-granular recovery phase events (multislice), by phase",
    "kf_timeline_dropped_total":
        "flight-recorder ring evictions (a nonzero value means the "
        "skew/xray windows are incomplete — kftop raises TRACE LOSS)",
    "kf_mfu":
        "model-FLOPs utilization: analytic model FLOP/s over the "
        "detected (or KF_XRAY_PEAK_FLOPS-pinned) chip peak (kf-xray)",
    "kf_model_flops_s":
        "analytic model FLOP/s actually sustained (EMA; the MFU "
        "numerator — reported alone on CPU meshes with no honest peak)",
    "kf_step_phase_seconds":
        "per-step wall decomposition by kf-xray phase (compute / "
        "comm_exposed / comm_hidden / input_stall / straggler_wait)",
    "kf_opt_state_bytes":
        "per-rank optimizer-state footprint (worst device; ZeRO shards "
        "count one chunk, replicated state counts fully)",
    "kf_overlap_inflight":
        "async collective handles issued and not yet complete "
        "(kf-overlap in-flight window; 0 = fully drained)",
    "kf_overlap_efficiency":
        "per-handle hidden-wire fraction observed at wait(): 1.0 = the "
        "collective finished before the caller needed it (fully hidden), "
        "0.0 = the caller blocked for the whole wire time",
    "kf_kv_cache_bytes":
        "per-rank paged KV-cache footprint (allocated pages x page "
        "bytes; the serving analog of kf_opt_state_bytes)",
    "kf_serve_requests_total":
        "serving request lifecycle events (kf-serve router), by outcome "
        "(accept / reject / complete / replay / lost)",
    "kf_serve_prefill_tokens_total":
        "prefill tokens by source: computed ran the forward, reused "
        "came from the paged KV cache's prefix chain",
    "kf_serve_ttft_seconds":
        "time to first token (admission to first decode), worker-side",
    "kf_serve_token_seconds":
        "decode-step latency per generated token, worker-side",
    "kf_serve_e2e_seconds":
        "end-to-end request latency (submit to completion incl. "
        "routing, queueing, and any post-failure replay), router-side",
    "kf_serve_queue_depth":
        "router accepted-but-unfinished requests (admission bound: "
        "KF_SERVE_QUEUE_DEPTH)",
    "kf_serve_active_requests":
        "decode slots occupied on this engine (continuous batching)",
    "kf_ckpt_last_step":
        "newest step this rank's persist plane made durable "
        "(kf-persist; -1-ish float 0.0 before the first write)",
    "kf_ckpt_age_seconds":
        "seconds since this rank's last durable manifest write — grows "
        "while the writer is wedged; kftop raises CKPT STALE past 3 "
        "persist periods",
    "kf_ckpt_bytes_total":
        "cumulative bytes this rank streamed into durable manifests "
        "(gauge-typed: the plane owns the accumulation)",
    "kf_ckpt_period_seconds":
        "configured persist period (KF_PERSIST_PERIOD; 0 = persist at "
        "every commit) — the denominator of the CKPT STALE alarm",
    "kf_net_egress_bytes":
        "aggregate egress bytes (mirrored from NetMonitor)",
    "kf_net_ingress_bytes":
        "aggregate ingress bytes (mirrored from NetMonitor)",
    "kf_cluster_control_events_total":
        "control events (shrink/resize/...) received by the aggregator",
    "kf_alerts_total":
        "kf-sentinel rule firings by rule name (changepoint regressions, "
        "SLO burn rates, watermarks); each firing cuts an incident "
        "flight record under KF_SENTINEL_DIR",
    "kf_jit_compiles_total":
        "XLA compilations observed through the jax monitoring hook — a "
        "nonzero steady-state rate means a shape/dtype is retriggering "
        "jit (the dynamic twin of the static recompile-hazard rule)",
    "kf_jit_compile_seconds":
        "wall seconds per observed XLA compilation (jax monitoring "
        "hook; absent on jax versions without it)",
    "kf_device_memory_bytes":
        "accelerator memory by kind (in_use / limit) from "
        "device.memory_stats(); absent on backends without stats (CPU)",
    "kf_gns":
        "EMA-smoothed gradient-noise-scale estimate (OpenAI GNS; "
        "kf-pulse) — piggybacks on already-reduced gradient buckets, "
        "sampled every KF_PULSE_EVERY steps; absent on a single worker "
        "where the two-batch estimator is undefined",
    "kf_grad_variance":
        "EMA-smoothed cross-peer gradient variance E_i|g_i - g_avg|^2 "
        "from the same reduced buckets as kf_gns (kf-pulse)",
    "kf_grad_norm":
        "per-parameter-group gradient L2 norm, group= label keyed by "
        "the sharding kind (kf-pulse)",
    "kf_decisions_total":
        "adaptive-control decisions recorded in the kf-ledger, by "
        "actor= label — each one carries a durable (knob, old, new, "
        "evidence) record joined to its measured effect",
}


class MetricsRegistry:
    """Name+labels → metric instance, with one Prometheus rendering."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kwargs):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(**kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels,
                         buckets=buckets or DEFAULT_LATENCY_BUCKETS)

    def snapshot(self) -> Dict[str, object]:
        """``{rendered-name: value-or-summary}`` for tests/tools."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for (name, labels), m in items:
            key = name + _label_str(dict(labels))
            out[key] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus exposition text: per metric *family* one ``# HELP``
        + ``# TYPE`` header (label variants sort together, so the header
        lands once), then the samples — whose names and label encoding
        are byte-identical to the pre-HELP/TYPE rendering, so existing
        scrape configs and dashboards keep matching."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        lines: List[str] = []
        last_family = None
        for (name, labels), m in items:
            ld = dict(labels)
            if name != last_family:
                kind = ("counter" if isinstance(m, Counter)
                        else "gauge" if isinstance(m, Gauge)
                        else "histogram")
                lines.append(f"# HELP {name} "
                             f"{METRIC_HELP.get(name, 'kungfu-tpu metric')}")
                lines.append(f"# TYPE {name} {kind}")
                last_family = name
            if isinstance(m, Counter):
                lines.append(f"{name}{_label_str(ld)} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"{name}{_label_str(ld)} {m.value:.6g}")
            else:  # Histogram: the _bucket/_sum/_count encoding
                for le, cum in m.bucket_counts():
                    le_s = "+Inf" if le == float("inf") else f"{le:g}"
                    bl = dict(ld, le=le_s)
                    lines.append(f"{name}_bucket{_label_str(bl)} {cum}")
                lines.append(f"{name}_sum{_label_str(ld)} {m.sum:.6g}")
                lines.append(f"{name}_count{_label_str(ld)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-global registry rendered by ``/metrics``
REGISTRY = MetricsRegistry()
