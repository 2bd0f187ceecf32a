"""Scoped tracing and profiling (port of ``kungfu_tpu/utils/trace.py``).

* :func:`trace_scope` — context manager: when ``KF_CONFIG_ENABLE_TRACE``
  is truthy it logs entry depth and duration and accumulates per-name
  (count, total) stats and a latency histogram; near-zero cost when off.
  :func:`traced` is its decorator form.
* :func:`trace_report` — the aggregated table of every scope seen
  (:func:`reset_trace_stats` clears it); ``timeline.span`` regions feed
  it too, through :func:`record_duration`.
* :func:`device_trace` — a ``torch.profiler`` capture of the wrapped
  region, written as a Chrome trace under ``logdir``.  The reference
  writes jax's profiler directory (XPlane); the port's file is
  ``torch.profiler``'s Chrome-trace JSON (ROADMAP C27).

The module imports nothing but the stdlib and the port's registry and
logger at import; ``torch`` is imported inside :func:`device_trace`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, Optional, Tuple

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("trace")

ENABLE_TRACE = "KF_CONFIG_ENABLE_TRACE"

_local = threading.local()
_stats_lock = threading.Lock()
_stats: Dict[str, Tuple[int, float]] = {}
#: per-name duration histograms (monitor.registry.Histogram, imported
#: lazily: utils stays importable without the monitor package)
_hists: Dict[str, object] = {}
_Histogram = None
#: numbers the Chrome traces written by this process
_trace_seq = itertools.count()


def trace_enabled() -> bool:
    return os.environ.get(ENABLE_TRACE, "").lower() in ("1", "true", "yes")


def _hist_cls():
    global _Histogram
    if _Histogram is None:
        from kungfu_tpu_torch.monitor.registry import Histogram

        _Histogram = Histogram
    return _Histogram


def record_duration(name: str, dt: float) -> None:
    """Feed one scope duration into the per-name stats and its latency
    histogram: ``timeline.span`` regions report here, so
    :func:`trace_report` covers them like any :func:`trace_scope`."""
    # resolve the histogram class before taking the lock: its first call
    # imports the monitor package
    cls = _hist_cls()
    with _stats_lock:
        n, total = _stats.get(name, (0, 0.0))
        _stats[name] = (n + 1, total + dt)
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = cls()
    # the histogram has its own lock; observe outside this one
    h.observe(dt)


@contextlib.contextmanager
def trace_scope(name: str, force: bool = False):
    """Time a region when tracing is on; nested scopes are indented by
    depth in the log and feed :func:`record_duration`."""
    if not (force or trace_enabled()):
        yield
        return
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _local.depth = depth
        record_duration(name, dt)
        _log.info("%s%s took %.3fms", "  " * depth, name, dt * 1e3)


def traced(fn=None, *, name: Optional[str] = None):
    """Decorator form of :func:`trace_scope` (the scope is ``name`` or
    the function's ``__qualname__``)."""
    if fn is None:
        return functools.partial(traced, name=name)

    scope = name or fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with trace_scope(scope):
            return fn(*args, **kwargs)

    return wrapper


def trace_report() -> Dict[str, Dict[str, float]]:
    """Aggregated scope stats: ``{name: {count, total_s, mean_ms, min_ms,
    max_ms, p50_ms, p95_ms}}``, the tail keys from the fixed-bucket
    histogram, as the reference's."""
    with _stats_lock:
        snap = dict(_stats)
        hists = dict(_hists)
    out: Dict[str, Dict[str, float]] = {}
    for name, (n, total) in snap.items():
        row = {
            "count": n,
            "total_s": total,
            "mean_ms": (total / n * 1e3) if n else 0.0,
        }
        h = hists.get(name)
        if h is not None and h.count:
            s = h.summary()
            row["min_ms"] = s["min"] * 1e3
            row["max_ms"] = s["max"] * 1e3
            row["p50_ms"] = s["p50"] * 1e3
            row["p95_ms"] = s["p95"] * 1e3
        out[name] = row
    return out


def reset_trace_stats() -> None:
    with _stats_lock:
        _stats.clear()
        _hists.clear()


@contextlib.contextmanager
def device_trace(logdir: str, force: bool = False, device="cuda"):
    """Capture a ``torch.profiler`` trace of the wrapped region and write
    it as ``logdir/trace-<pid>-<n>.json`` (Chrome-trace JSON).  A no-op
    yielding ``None`` unless tracing is enabled or ``force``; otherwise
    yields the profiler, whose ``events()`` and ``key_averages()`` the
    caller may read after the block.

    ``device`` is the card by default: the profiler then records the
    CUDA activity (each kernel by name on the device timeline) beside
    the host's, and the call raises where there is no card.  Only a
    caller that names the CPU gets a CPU-only trace."""
    if not (force or trace_enabled()):
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_trace: the card was asked for and there is no CUDA "
                "device (pass device='cpu' for a host-only trace)")
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    elif dev.type == "cpu":
        activities = [ProfilerActivity.CPU]
    else:
        raise ValueError(f"device_trace: no profiler for device {dev}")
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        path = os.path.join(
            logdir, f"trace-{os.getpid()}-{next(_trace_seq)}.json")
        prof.export_chrome_trace(path)
        _log.info("device trace written to %s", path)
