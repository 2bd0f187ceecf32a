"""Flight recorder: bounded in-process ring of structured events.

Trimmed copy of ``kungfu_tpu/monitor/timeline.py`` keeping what the
port's serving engine, cost model, pulse monitor, chaos controller and
host collective engine call: :func:`span`, :func:`event`,
:func:`enabled`, the causal context (:func:`parse_trace_context`,
:func:`context_attrs`, :func:`collective_trace_id`), the process-default
rank and step (:func:`set_rank`, :func:`set_step`, :func:`current_step`,
:func:`current_rank`), the counted kinds (``retry``, ``deadline``,
``chaos``, ``swap`` and the rest tick their registry counters even with
tracing off), :func:`snapshot`, :func:`events_tail` (the cursor the
bandit drivers read), :func:`reset`, :func:`dump` and
:func:`maybe_dump` (``KF_CONFIG_TRACE_DUMP``, also at exit).  Events are
``(ts, rank, step, kind, name, dur, attrs)`` in the reference's
vocabulary, so the engine's ``collective``, ``overlap`` and ``deadline``
events come out as the reference's do; recording is gated by
``KF_CONFIG_ENABLE_TRACE``.  :func:`format_trace_context` is the wire
form the p2p blob store's requests carry.  Not ported: ``trace_ctx``,
which no ported module calls.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.trace import record_duration, trace_enabled

_log = get_logger("timeline")

#: JSONL dump location: a directory (one ``trace-*.jsonl`` per process)
#: or an exact ``*.jsonl`` path (single-process runs)
DUMP_ENV = "KF_CONFIG_TRACE_DUMP"

#: ring capacity override (events); default 65536
CAP_ENV = "KF_CONFIG_TIMELINE_CAP"
DEFAULT_CAP = 65536

#: the event vocabulary (the reference's)
EVENT_KINDS = frozenset({
    "collective",  # host-engine collective span (comm/engine.py)
    "device",      # device-plane collective span (comm/device.py)
    "send",        # host-channel frame egress mark, byte-counted
    "recv",        # host-channel frame ingress mark, byte-counted
    "retry",       # engine send retry after a transient wire fault
    "deadline",    # per-peer deadline exhausted -> PeerFailureError
    "signal",      # detector heartbeat intake (begin/end/epoch/...)
    "down",        # detector down verdict / local down report
    "shrink",      # shrink-to-survivors phase boundary
    "slice",       # slice-granular recovery phase (elastic/shrink.py:
                   # verdict / self-excluded / leader-consensus /
                   # propose / quorum-lost at the multislice grain)
    "chaos",       # fault injection fired (chaos/inject.py)
    "swap",        # consensus-fenced strategy/schedule swap (kf-adapt:
                   # monitor/adapt_device.py — host arm or device
                   # per-bucket schedule installed in lockstep)
    "overlap",     # async collective handle lifecycle (kf-overlap,
                   # comm/engine.py: "issue" / "complete" marks carrying
                   # tag, nbytes, and the in-flight queue depth).  A hot
                   # kind: recorded only when tracing is on — the
                   # always-on surfaces are the kf_overlap_inflight
                   # gauge and the kf_overlap_efficiency histogram.
                   # Since kf-xray, recorded marks also ride the monitor
                   # pushes (aggregator.REPORT_KINDS ⊇ xray.XRAY_KINDS:
                   # the online attribution needs the async-tag set)
    "serve",       # serving-plane engine/router lifecycle (kf-serve,
                   # serve/engine.py + serve/router.py: prefill/decode
                   # spans — hot, ring-only — plus the rare worker-dead/
                   # slice-dead/readmit marks of the serving fault
                   # ladder)
    "pp",          # pipeline-parallel lifecycle (kf-pipeline,
                   # parallel/pp.py): "fwd"/"bwd" stage-compute spans
                   # and the "bubble" span — the time a stage blocks on
                   # a cross-DCN activation/gradient hop — plus the
                   # rare "buddy-replicate"/"stage-recarve" marks of
                   # the elastic stage re-carve.  A hot kind, recorded
                   # only when tracing is on; recorded spans ride the
                   # monitor pushes (REPORT_KINDS) so kf-xray's online
                   # step decomposition attributes bubble time as its
                   # own phase (monitor/xray.py::PHASES pp_bubble)
    "input",       # input-pipeline wait span (kf-xray: the consumer-side
                   # block for the next batch — datasets/prefetch.py and
                   # any loader that wants its stall attributed.  A hot
                   # kind, one span per consumed batch, recorded only
                   # when tracing is on; recorded spans also ride the
                   # monitor pushes (REPORT_KINDS) so the online
                   # input_stall attribution sees them)
    "xray",        # kf-xray attribution mark (monitor/xray.py /
                   # ops/costmodel.py: the rank-local per-step phase
                   # split and MFU sample, so a dump carries the same
                   # decomposition the live gauges export)
    "request",     # serving request lifecycle mark (kf-serve router:
                   # "accept" / "reject" / "complete" / "replay" /
                   # "lost").  A counted kind: every mark ticks
                   # kf_serve_requests_total{what=<name>} even with
                   # tracing off, like the chaos/shrink counters
    "ckpt",        # durable persist plane (kf-persist,
                   # elastic/persist.py): "persist-issue" /
                   # "persist-done" marks around each async manifest
                   # write and the "restore" mark of a cold restart —
                   # rare boundary events, so always recordable; the
                   # always-on surfaces are the kf_ckpt_* gauges
    "alert",       # kf-sentinel rule firing (monitor/sentinel.py): a
                   # detector/burn-rate/watermark rule crossed its
                   # threshold and an incident flight record was cut.
                   # A counted kind labeled by RULE name: every firing
                   # ticks kf_alerts_total{rule=...} even with tracing
                   # off — an alert that /metrics cannot count did not
                   # happen
    "decision",    # adaptive-actor knob change (kf-ledger,
                   # monitor/ledger.py: a bandit swap, a batch-width
                   # move, an autoscale resize, a shrink — any actor
                   # writing a durable decision record).  A counted
                   # kind labeled by ACTOR name: every decision ticks
                   # kf_decisions_total{actor=...} even with tracing
                   # off — a knob change /metrics cannot count did not
                   # happen
    "pulse",       # gradient-signal sample mark (kf-pulse,
                   # monitor/pulse.py: the GNS/variance pair computed
                   # every KF_PULSE_EVERY steps).  A hot-ish kind,
                   # recorded only when tracing is on — the always-on
                   # surfaces are the kf_gns / kf_grad_variance /
                   # kf_grad_norm gauges
    "step",        # training-step mark
    "mark",        # generic one-shot annotation
})

#: kinds whose registry counters tick even with tracing off — rare
#: events that /metrics must count unconditionally.  Values are the
#: counter names; chaos/shrink additionally label by the event name
#: (a closed set: clause kinds / phase names).
_COUNTED_KINDS = {
    "retry": "kf_engine_retries_total",
    "deadline": "kf_peer_faults_total",
    "chaos": "kf_chaos_injections_total",
    "down": "kf_detector_down_total",
    "shrink": "kf_shrink_events_total",
    "slice": "kf_slice_events_total",
    "swap": "kf_strategy_swaps_total",
    "request": "kf_serve_requests_total",
    "alert": "kf_alerts_total",
    "decision": "kf_decisions_total",
}
_LABELED_KINDS = ("chaos", "shrink", "slice", "swap", "request", "alert",
                  "decision")
#: label KEY per labeled kind; default "what".  Alerts label by "rule"
#: so the counter reads kf_alerts_total{rule="regress:step_time_s"} —
#: the name SLO dashboards group by; decisions label by ACTOR the same
#: way (kf_decisions_total{actor="bandit-host"}).
_LABEL_KEYS = {"alert": "rule", "decision": "actor"}

_lock = threading.Lock()
_ring: collections.deque = collections.deque()
_cap: Optional[int] = None  # resolved lazily from CAP_ENV
_dropped = 0
_rank: Optional[int] = None
_step = -1
_span_seq = itertools.count(1)
_tls = threading.local()


def new_span_id() -> str:
    """Process-unique span id (``s<rank>.<n>``)."""
    r = _rank if _rank is not None else "x"
    return f"s{r}.{next(_span_seq)}"


def collective_trace_id(version, step, op: str, tag: str) -> str:
    """Deterministic cross-rank trace id of one logical collective, from
    values every participant holds: the cluster version, the step, and
    the collective's op and tag."""
    return f"c{version}.{step}.{op}.{tag}"


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


def format_trace_context(trace: Optional[str],
                         parent: Optional[str] = None) -> Optional[str]:
    """The compact wire form :func:`parse_trace_context` reads."""
    if not trace:
        return None
    return f"{trace}@{parent}" if parent else trace


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


def set_rank(rank: Optional[int]) -> None:
    """Default rank stamped on events whose call site passes none."""
    global _rank
    _rank = rank


def set_step(step: int) -> None:
    """Current training step, stamped on subsequent events."""
    global _step
    _step = step


def current_step() -> int:
    """The step last stamped by :func:`set_step` (``-1`` before the
    first)."""
    return _step


def current_rank() -> Optional[int]:
    """The process-default rank installed by :func:`set_rank`."""
    return _rank


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
    ev = (ts, rank if rank is not None else _rank, _step, kind, name, dur,
          attrs or None)
    cap = _capacity()
    with _lock:
        if len(_ring) >= cap:
            _ring.popleft()
            _dropped += 1
            REGISTRY.counter("kf_timeline_dropped_total").inc()
        _ring.append(ev)


def _count(kind: str, name: str) -> None:
    metric = _COUNTED_KINDS.get(kind)
    if metric is None:
        return
    if kind in _LABELED_KINDS:
        REGISTRY.counter(metric,
                         **{_LABEL_KEYS.get(kind, "what"): name}).inc()
    else:
        REGISTRY.counter(metric).inc()


def event(kind: str, name: str, rank: Optional[int] = None,
          force: bool = False, **attrs) -> None:
    """One-shot mark.  Counted kinds always tick their registry counter;
    the ring records only when tracing is enabled (or ``force``)."""
    _count(kind, name)
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
        self.span_id = new_span_id()
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
        if self.kind in ("collective", "device"):
            REGISTRY.histogram(
                "kf_collective_latency_seconds",
                plane=self.kind, op=attrs.get("op") or self.name,
            ).observe(dt)
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


def events_tail(since: int, kinds: Optional[frozenset] = None
                ) -> Tuple[int, List[Dict]]:
    """``(cursor, events)``: every event appended after the ``since``
    cursor (0 = the beginning), optionally filtered by kind, oldest
    first.  The cursor counts every append (evicted and live), so an
    incremental reader never reads an event twice or misses one still in
    the ring; events evicted before the read are gone (:func:`dropped`
    says how many)."""
    with _lock:
        total = _dropped + len(_ring)
        start = max(0, since - _dropped)
        evs = list(_ring)[start:] if start < len(_ring) else []
    if kinds is not None:
        evs = [e for e in evs if e[3] in kinds]
    return total, [{"ts": ts, "rank": r, "step": s, "kind": k, "name": n,
                    "dur": d, "attrs": a or {}}
                   for ts, r, s, k, n, d, a in evs]


def reset(cap: Optional[int] = None) -> None:
    """Clear the ring; ``cap`` pins a capacity."""
    global _dropped, _cap, _step, _span_seq
    with _lock:
        _ring.clear()
        _dropped = 0
        _cap = max(1, cap) if cap is not None else None
        _step = -1
        _span_seq = itertools.count(1)


def dump(path: str) -> int:
    """Write the ring as JSONL (header line first); returns the count."""
    events = snapshot()
    header = {"kftrace": 1, "rank": _rank, "pid": os.getpid(),
              "dropped": dropped(), "wall": time.time()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(header) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return len(events)


def dump_path_from_env() -> Optional[str]:
    """``KF_CONFIG_TRACE_DUMP`` resolved to this process's dump file, or
    None when dumping is not configured."""
    target = os.environ.get(DUMP_ENV, "").strip()
    if not target:
        return None
    if target.endswith(".jsonl"):
        return target
    r = _rank if _rank is not None else "x"
    return os.path.join(target, f"trace-r{r}-p{os.getpid()}.jsonl")


def maybe_dump() -> Optional[str]:
    """Dump to the env-configured path if set and the ring is non-empty;
    returns the path written (later calls overwrite with a superset)."""
    path = dump_path_from_env()
    if path is None:
        return None
    with _lock:
        if not _ring:
            return None
    try:
        n = dump(path)
    except OSError as e:
        _log.warning("cannot dump timeline to %s: %s", path, e)
        return None
    _log.info("%d event(s) dumped to %s", n, path)
    return path


atexit.register(maybe_dump)
