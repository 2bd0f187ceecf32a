"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

Trimmed copy of ``kungfu_tpu/monitor/registry.py`` (stdlib only): the
same metric types, names, labels and percentile estimate; the
Prometheus rendering comes with the metrics server of a later slice.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Tuple

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


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(labels[k]))}"'
                     for k in sorted(labels))
    return "{" + inner + "}"


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

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-global registry
REGISTRY = MetricsRegistry()
