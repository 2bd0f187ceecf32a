"""Trace gate and per-scope duration aggregates (trimmed copy of
``kungfu_tpu/utils/trace.py``; its ``device_trace`` is ``jax.profiler``
and has no counterpart here — ``torch.profiler`` is used directly)."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Tuple

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("trace")
_local = threading.local()

ENABLE_TRACE = "KF_CONFIG_ENABLE_TRACE"

_stats_lock = threading.Lock()
_stats: Dict[str, Tuple[int, float]] = {}


def trace_enabled() -> bool:
    return os.environ.get(ENABLE_TRACE, "").lower() in ("1", "true", "yes")


def record_duration(name: str, dt: float) -> None:
    """Feed one scope duration into the per-name (count, total) stats."""
    with _stats_lock:
        n, total = _stats.get(name, (0, 0.0))
        _stats[name] = (n + 1, total + dt)



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
