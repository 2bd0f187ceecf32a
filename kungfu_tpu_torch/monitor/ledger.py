"""kf-ledger: durable decision records and their measured effects (port
of ``kungfu_tpu/monitor/ledger.py``, stdlib only).

Every adaptive actor (the host and device collective bandits, the
overlap-depth bandit, the serving batch-width controller and autoscaler,
``ServeFleet``, the shrink) writes one decision record ``(actor, knob,
old, new, consensus_seq, trace_id, evidence)`` through
:func:`record_decision`, and the ledger later joins it to its measured
effect: the median shift of a history series between the ``window``
samples before the decision and the ``window`` after, scored in MAD units
with :mod:`~kungfu_tpu_torch.monitor.detect`'s scale floor.  Both kinds
land in the ``decisions`` :class:`~kungfu_tpu_torch.monitor.history.
HistoryRing` stream under ``KF_SENTINEL_DIR``, beside the ``cluster``
stream whose samples feed the join.  The effect is a pure function of
the records, so :func:`replay_effects` recomputes it offline byte for
byte, and the records are the reference's, so either package's ``kfhist
--decisions`` reads the other's directory.

Record fields are the closed schema :data:`LEDGER_FIELDS`, written
through :func:`ledger_record` and read through :func:`lfield`, both of
which raise on an unknown name.  With ``KF_SENTINEL_DIR`` unset
:func:`active` is ``None`` and :func:`record_decision` returns after one
env check; every decision ticks the counted ``decision`` timeline kind
(``kf_decisions_total{actor=...}``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from kungfu_tpu_torch.monitor import detect, history, timeline
from kungfu_tpu_torch.utils import envs

#: the decisions stream name under ``KF_SENTINEL_DIR``
DECISIONS_STREAM = "decisions"

#: the closed record-field schema, enforced by :func:`ledger_record` and
#: :func:`lfield`.  Two record kinds share it: ``decision`` (the knob
#: change + provenance) and ``effect`` (the measured before/after
#: verdict joined back by ``decision_seq``).
LEDGER_FIELDS = frozenset({
    # both kinds
    "kfledger", "kind", "seq", "wall",
    # decision records
    "actor", "knob", "old", "new", "step", "consensus_seq", "trace_id",
    "evidence", "history_n", "series_n", "effect_series", "good_direction",
    # effect records
    "decision_seq", "series", "window", "threshold", "before_median",
    "before_mad", "after_median", "shift", "score", "verdict",
})

#: the series a decision is judged against when its actor names none —
#: every adaptive actor ultimately answers to step time
DEFAULT_EFFECT_SERIES = "step_time_s"
#: the shift direction that counts as an improvement for the default
#: series (step time going DOWN is good)
DEFAULT_GOOD_DIRECTION = "down"


def ledger_record(**fields) -> dict:
    """Schema-checked record builder (the ledger analog of
    ``aggregator.make_snapshot``): unknown field names raise."""
    unknown = set(fields) - LEDGER_FIELDS
    if unknown:
        raise ValueError(f"unknown ledger field(s) {sorted(unknown)}")
    return dict(fields)


def lfield(obj: Optional[dict], name: str, default=None):
    """Schema-checked record read (the ledger analog of
    ``aggregator.field``): reading a name outside :data:`LEDGER_FIELDS`
    raises instead of returning a silent ``None``."""
    if name not in LEDGER_FIELDS:
        raise KeyError(f"unknown ledger field {name!r}")
    if not isinstance(obj, dict):
        return default
    return obj.get(name, default)


def judge(decision: dict, before: List[float],
          after: List[float]) -> Optional[dict]:
    """The pure effect verdict: the median shift of the effect series
    across the decision boundary, scored in MAD units with the EXACT
    :func:`~kungfu_tpu_torch.monitor.detect.changepoint` scale floor (and its
    9/6-decimal rounding), so online and offline computations are
    byte-identical.  ``None`` while the after window is short (the
    decision is still pending); verdict ``insufficient`` when the
    BEFORE window never had a full baseline."""
    window = int(lfield(decision, "window",
                        detect.DEFAULT_WINDOW) or detect.DEFAULT_WINDOW)
    threshold = float(lfield(decision, "threshold",
                             detect.DEFAULT_THRESHOLD)
                      or detect.DEFAULT_THRESHOLD)
    series = lfield(decision, "effect_series") or DEFAULT_EFFECT_SERIES
    good = lfield(decision, "good_direction") or DEFAULT_GOOD_DIRECTION
    if len(after) < window:
        return None
    after = [float(v) for v in after[:window]]
    base = ledger_record(
        kfledger=1,
        kind="effect",
        decision_seq=lfield(decision, "seq"),
        actor=lfield(decision, "actor"),
        knob=lfield(decision, "knob"),
        series=series,
        good_direction=good,
        window=window,
        threshold=threshold,
    )
    if len(before) < window:
        base.update(ledger_record(
            verdict="insufficient",
            before_median=None, before_mad=None, after_median=None,
            shift=None, score=None))
        return base
    before = [float(v) for v in before[-window:]]
    base_med = detect.median(before)
    base_mad = detect.mad(before, base_med)
    after_med = detect.median(after)
    shift = after_med - base_med
    scale = max(base_mad,
                detect.DEFAULT_REL_FLOOR * abs(base_med)
                / max(threshold, 1.0),
                detect.ABS_FLOOR)
    score = shift / scale                      # SIGNED, unlike changepoint
    if abs(score) < threshold:
        verdict = "neutral"
    elif (score < 0) == (good == "down"):
        verdict = "improved"
    else:
        verdict = "regressed"
    base.update(ledger_record(
        before_median=round(base_med, 9),
        before_mad=round(base_mad, 9),
        after_median=round(after_med, 9),
        shift=round(shift, 9),
        score=round(score, 6),
        verdict=verdict,
    ))
    return base


class DecisionLedger:
    """One run's decision stream: durable appends + the online join.

    The owner (the :class:`~kungfu_tpu_torch.monitor.sentinel.Sentinel`, or a
    test) feeds every cluster history record through :meth:`on_sample`;
    :meth:`decide` snapshots the effect series' trailing ``window``
    samples as the BEFORE evidence and parks the decision until the
    AFTER window fills, at which point the verdict is appended to the
    same stream.  All state needed by the join is IN the records, so
    the offline replay (:func:`replay_effects`) is self-contained."""

    def __init__(self, root: str, window: int = detect.DEFAULT_WINDOW,
                 threshold: float = detect.DEFAULT_THRESHOLD,
                 keep_bytes: Optional[int] = None):
        self.root = root
        self.window = max(2, int(window))
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        self._ring = history.HistoryRing(root, DECISIONS_STREAM,
                                         keep_bytes=keep_bytes)
        self._seq = 0                      # decision records appended
        self._samples_seen = 0             # cluster records observed
        self._series_n: Dict[str, int] = {}    # per-series sample counts
        self._tails: Dict[str, List[float]] = {}  # trailing `window` each
        self._pending: List[dict] = []     # [{decision, after: []}]
        self._effects: List[dict] = []     # judged effects (bounded)
        self._decisions: List[dict] = []   # decision records (bounded)
        self._max_kept = 256

    # -- write side -------------------------------------------------------
    def decide(self, actor: str, knob: str, old, new,
               consensus_seq=None, trace_id: Optional[str] = None,
               evidence: Optional[dict] = None,
               effect_series: str = DEFAULT_EFFECT_SERIES,
               good_direction: str = DEFAULT_GOOD_DIRECTION,
               step: Optional[int] = None,
               wall: Optional[float] = None) -> dict:
        """Append one decision record; returns it.  ``trace_id``
        defaults to the ambient timeline trace so a decision made while
        handling a traced operation joins its causal chain."""
        if trace_id is None:
            trace_id = timeline.current_trace()[0]
        if step is None:
            step = timeline.current_step()
        with self._lock:
            self._seq += 1
            rec = ledger_record(
                kfledger=1,
                kind="decision",
                seq=self._seq,
                wall=wall,
                actor=str(actor),
                knob=str(knob),
                old=old,
                new=new,
                step=step,
                consensus_seq=consensus_seq,
                trace_id=trace_id,
                evidence=evidence or {},
                history_n=self._samples_seen,
                series_n=self._series_n.get(effect_series, 0),
                effect_series=effect_series,
                good_direction=good_direction,
                window=self.window,
                threshold=self.threshold,
            )
            self._ring.append(rec)
            self._decisions.append(rec)
            del self._decisions[:-self._max_kept]
            self._pending.append({
                "decision": rec,
                "before": list(self._tails.get(effect_series, [])),
                "after": [],
            })
        # counted kind labeled by actor: kf_decisions_total{actor=...}
        # ticks even with tracing off; force=True lands the mark in the
        # flight recorder regardless, like alerts — rare events both
        timeline.event("decision", str(actor), force=True,
                       knob=str(knob), old=old, new=new,
                       seq=self._seq, consensus_seq=consensus_seq)
        return rec

    # -- sample feed ------------------------------------------------------
    def on_sample(self, record: dict) -> List[dict]:
        """One cluster history record (the sentinel's ``_observe_locked``
        appends it to the ``cluster`` stream, then feeds it here, so the
        ledger's sample counts mirror the durable stream exactly).
        Judges any pending decision whose after window just filled;
        returns the effect records appended by this sample."""
        series = record.get("series")
        if not isinstance(series, dict):
            series = {}
        out: List[dict] = []
        with self._lock:
            self._samples_seen += 1
            for name, value in series.items():
                if isinstance(value, bool) \
                        or not isinstance(value, (int, float)):
                    continue
                v = float(value)
                self._series_n[name] = self._series_n.get(name, 0) + 1
                tail = self._tails.setdefault(name, [])
                tail.append(v)
                del tail[:-self.window]
                for p in self._pending:
                    d = p["decision"]
                    if lfield(d, "effect_series") == name \
                            and len(p["after"]) < self.window:
                        p["after"].append(v)
            still = []
            for p in self._pending:
                effect = judge(p["decision"], p["before"], p["after"])
                if effect is None:
                    still.append(p)
                    continue
                self._ring.append(effect)
                self._effects.append(effect)
                del self._effects[:-self._max_kept]
                out.append(effect)
            self._pending = still
        return out

    # -- read side --------------------------------------------------------
    def summary(self) -> dict:
        """The ``decisions`` shape ``alerts_view()`` /
        ``policy.sentinel_signals()`` publish: counts by verdict plus
        the newest effect — enough for a policy to steer by without
        reading the stream."""
        with self._lock:
            by_verdict: Dict[str, int] = {}
            for e in self._effects:
                v = str(lfield(e, "verdict"))
                by_verdict[v] = by_verdict.get(v, 0) + 1
            return {
                "total": self._seq,
                "judged": len(self._effects),
                "pending": len(self._pending),
                "by_verdict": dict(sorted(by_verdict.items())),
                "last": dict(self._effects[-1]) if self._effects else None,
            }

    def view(self) -> dict:
        """The ``/decisions`` JSON: recent decision records with their
        effects joined by ``decision_seq``, plus the summary."""
        with self._lock:
            effects = {lfield(e, "decision_seq"): e for e in self._effects}
            rows = []
            for d in self._decisions:
                seq = lfield(d, "seq")
                rows.append({
                    "decision": dict(d),
                    "effect": (dict(effects[seq])
                               if seq in effects else None),
                })
        return {
            "kfledger": 1,
            "decisions": rows,
            "summary": self.summary(),
        }


# -- offline replay (kfhist --decisions) ------------------------------------
def replay_effects(root: str) -> dict:
    """Recompute every judged decision's effect record offline from the
    durable ``decisions`` + ``cluster`` streams — the exact
    :func:`judge` math over the exact sample slices the online ledger
    saw (``series_n`` positions the decision inside the effect series),
    so each replayed record must equal the stream's online effect
    record byte for byte.  Returns online/replayed pairs plus the
    stream's raw decisions for rendering."""
    decisions_raw, skipped = history.scan_stream(root, DECISIONS_STREAM)
    cluster, _ = history.scan_stream(root, "cluster")
    series = history.series_from_records(cluster)
    decisions = [r for r in decisions_raw if r.get("kind") == "decision"]
    online = {lfield(r, "decision_seq"): r for r in decisions_raw
              if r.get("kind") == "effect"}
    rows = []
    for d in decisions:
        name = lfield(d, "effect_series") or DEFAULT_EFFECT_SERIES
        pos = int(lfield(d, "series_n") or 0)
        window = int(lfield(d, "window",
                            detect.DEFAULT_WINDOW) or detect.DEFAULT_WINDOW)
        xs = series.get(name, [])
        before = xs[max(0, pos - window):pos]
        after = xs[pos:pos + window]
        replayed = judge(d, before, after)
        rows.append({
            "decision": d,
            "online": online.get(lfield(d, "seq")),
            "replayed": replayed,
        })
    return {
        "kfledger": 1,
        "records": len(decisions_raw),
        "skipped": skipped,
        "decisions": rows,
    }


# -- module-global registry (env-keyed, like the sentinel plane) ------------
_registry_lock = threading.Lock()
_ledgers: Dict[str, DecisionLedger] = {}


def ledger_for(root: str, window: Optional[int] = None,
               threshold: Optional[float] = None,
               keep_bytes: Optional[int] = None) -> DecisionLedger:
    """The per-root singleton: the sentinel constructs it with ITS
    window/threshold, and every actor's :func:`record_decision` (keyed
    off the same ``KF_SENTINEL_DIR``) lands in the same instance — one
    stream, one sample feed, one seq space."""
    with _registry_lock:
        led = _ledgers.get(root)
        if led is None:
            led = _ledgers[root] = DecisionLedger(
                root,
                window=(window if window is not None
                        else envs.sentinel_knobs()["window"]),
                threshold=(threshold if threshold is not None
                           else envs.sentinel_knobs()["threshold"]),
                keep_bytes=keep_bytes,
            )
        return led


def active() -> Optional[DecisionLedger]:
    """The env-keyed ledger, or ``None`` when ``KF_SENTINEL_DIR`` is
    unset (the whole accountability plane gated on the same one token
    as the sentinel — a decision stream with no sample feed would
    never judge anything)."""
    root = (os.environ.get(history.DIR_ENV, "") or "").strip()
    if not root:
        return None
    return ledger_for(root)


def record_decision(actor: str, knob: str, old, new,
                    **kwargs) -> Optional[dict]:
    """The one-line actor hook: appends a decision record when the
    plane is on, returns ``None`` (after one env check) when it is not.
    Never raises — an unwritable ledger must not take an adaptive
    actor down with it."""
    led = active()
    if led is None:
        return None
    try:
        return led.decide(actor, knob, old, new, **kwargs)
    except Exception:  # noqa: BLE001 - accountability must not break actors
        return None


def reset() -> None:
    """Drop every env-keyed ledger instance (tests — a process-global
    registry otherwise leaks state across tmp dirs)."""
    with _registry_lock:
        _ledgers.clear()
