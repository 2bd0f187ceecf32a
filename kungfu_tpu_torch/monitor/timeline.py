"""Flight recorder: bounded in-process ring of structured events.

Trimmed copy of ``kungfu_tpu/monitor/timeline.py`` keeping what the
port's engine and cost model call — :func:`span`, :func:`event`,
:func:`enabled`, :func:`parse_trace_context`, :func:`context_attrs`,
:func:`snapshot`, :func:`reset` and :func:`dump` — so the serving
spans keep their names (``serve/prefill``, ``serve/decode``) and the
dump keeps its JSONL schema.  Events are ``(ts, rank, step, kind, name,
dur, attrs)``; recording is gated by ``KF_CONFIG_ENABLE_TRACE``.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils.trace import record_duration, trace_enabled

#: ring capacity override (events); default 65536
CAP_ENV = "KF_CONFIG_TIMELINE_CAP"
DEFAULT_CAP = 65536

#: the event vocabulary of the port (a subset of the reference's)
EVENT_KINDS = frozenset({
    "serve",   # serving engine prefill/decode spans (serve/engine.py)
    "xray",    # MFU sample mark (ops/costmodel.py)
    "mark",    # generic one-shot annotation
})

_lock = threading.Lock()
_ring: collections.deque = collections.deque()
_cap: Optional[int] = None  # resolved lazily from CAP_ENV
_dropped = 0
_span_seq = itertools.count(1)
_tls = threading.local()


def _ctx_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_trace() -> Tuple[Optional[str], Optional[str]]:
    """``(trace_id, span_id)`` of the innermost ambient span on this thread."""
    st = _ctx_stack()
    return st[-1] if st else (None, None)


def parse_trace_context(tc) -> Tuple[Optional[str], Optional[str]]:
    """``(trace, parent)`` from ``"trace"`` or ``"trace@parent"``;
    ``(None, None)`` on anything malformed."""
    if not isinstance(tc, str) or not tc:
        return None, None
    trace, sep, parent = tc.partition("@")
    if not trace:
        return None, None
    return trace, (parent or None) if sep else None


def context_attrs(trace: Optional[str],
                  parent: Optional[str] = None) -> Dict[str, str]:
    """Span attrs for an explicitly propagated context (empty without one)."""
    if not trace:
        return {}
    attrs = {"trace": trace}
    if parent is not None:
        attrs["parent"] = parent
    return attrs


def enabled() -> bool:
    """The ``KF_CONFIG_ENABLE_TRACE`` gate."""
    return trace_enabled()


def _capacity() -> int:
    global _cap
    if _cap is None:
        try:
            _cap = max(1, int(os.environ.get(CAP_ENV, "") or DEFAULT_CAP))
        except ValueError:
            _cap = DEFAULT_CAP
    return _cap


def _append(ts: float, rank: Optional[int], kind: str, name: str,
            dur: float, attrs: Optional[Dict]) -> None:
    global _dropped
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown timeline kind {kind!r}")
    ev = (ts, rank, -1, kind, name, dur, attrs or None)
    cap = _capacity()
    with _lock:
        if len(_ring) >= cap:
            _ring.popleft()
            _dropped += 1
            REGISTRY.counter("kf_timeline_dropped_total").inc()
        _ring.append(ev)


def event(kind: str, name: str, rank: Optional[int] = None,
          force: bool = False, **attrs) -> None:
    """One-shot mark, recorded when tracing is enabled (or ``force``)."""
    if not (force or trace_enabled()):
        return
    if "trace" not in attrs:
        tr, parent = current_trace()
        if tr is not None:
            attrs["trace"] = tr
            if parent is not None:
                attrs.setdefault("parent", parent)
    _append(time.time(), rank, kind, name, 0.0, attrs)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("kind", "name", "rank", "attrs", "_t0", "_ts",
                 "span_id", "_trace", "_parent")

    def __init__(self, kind, name, rank, attrs):
        self.kind = kind
        self.name = name
        self.rank = rank
        self.attrs = attrs

    def __enter__(self):
        attrs = self.attrs or {}
        trace, parent = attrs.get("trace"), attrs.get("parent")
        if trace is None:
            trace, ambient_parent = current_trace()
            if parent is None:
                parent = ambient_parent
        self.span_id = f"s{self.rank if self.rank is not None else 'x'}." \
                       f"{next(_span_seq)}"
        self._trace, self._parent = trace, parent
        _ctx_stack().append((trace, self.span_id))
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        dt = time.perf_counter() - self._t0
        _ctx_stack().pop()
        attrs = dict(self.attrs or {})
        if et is not None:
            attrs["error"] = et.__name__
        attrs["span"] = self.span_id
        if self._trace is not None:
            attrs["trace"] = self._trace
        if self._parent is not None:
            attrs["parent"] = self._parent
        _append(self._ts, self.rank, self.kind, self.name, dt, attrs)
        record_duration(self.name, dt)
        return False


def span(kind: str, name: str, rank: Optional[int] = None,
         force: bool = False, **attrs):
    """Timed region recording one event with ``dur`` set; a shared no-op
    when tracing is off.  The duration is host wall time: a region that
    launches CUDA work without synchronising measures the enqueue."""
    if not (force or trace_enabled()):
        return _NOOP_SPAN
    return _Span(kind, name, rank, attrs or None)


def dropped() -> int:
    with _lock:
        return _dropped


def snapshot() -> List[Dict]:
    """Current ring contents as dicts, oldest first."""
    with _lock:
        evs = list(_ring)
    return [{"ts": ts, "rank": r, "step": s, "kind": k, "name": n, "dur": d,
             "attrs": a or {}} for ts, r, s, k, n, d, a in evs]


def reset(cap: Optional[int] = None) -> None:
    """Clear the ring; ``cap`` pins a capacity."""
    global _dropped, _cap, _span_seq
    with _lock:
        _ring.clear()
        _dropped = 0
        _cap = max(1, cap) if cap is not None else None
        _span_seq = itertools.count(1)


def dump(path: str) -> int:
    """Write the ring as JSONL (header line first); returns the count."""
    events = snapshot()
    header = {"kftrace": 1, "rank": None, "pid": os.getpid(),
              "dropped": dropped(), "wall": time.time()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(header) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return len(events)
