"""Trace gate and per-scope duration aggregates (trimmed copy of
``kungfu_tpu/utils/trace.py``; its ``device_trace`` is ``jax.profiler``
and has no counterpart here — ``torch.profiler`` is used directly)."""

from __future__ import annotations

import os
import threading
from typing import Dict, Tuple

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

