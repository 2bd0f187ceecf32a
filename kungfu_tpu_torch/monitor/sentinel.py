"""kf-sentinel: the aggregator's judging plane (port of
``kungfu_tpu/monitor/sentinel.py``, stdlib only).

A :class:`Sentinel` attached to the :class:`~kungfu_tpu_torch.monitor.
aggregator.ClusterAggregator` samples the cluster view at most once per
``KF_SENTINEL_PERIOD`` of the aggregator's clock, and per sample:

1. **remembers**: appends the rollup series and each rank's condensed row
   to the durable :mod:`~kungfu_tpu_torch.monitor.history` rings under
   ``KF_SENTINEL_DIR``;
2. **judges**: runs :mod:`~kungfu_tpu_torch.monitor.detect` (median-shift
   changepoints per series, two-window SLO burn rates) and the watermark
   rules over rolling buffers capped at exactly the tail
   :func:`~kungfu_tpu_torch.monitor.detect.changepoint` normalizes to, so
   ``kfhist --verdict`` over the durable history gives the same verdicts;
3. **alerts**: a rule that starts holding fires once (edge-triggered, no
   wall-clock cooldown): ``timeline.event("alert", rule, force=True)``
   ticks ``kf_alerts_total{rule=...}``, and an incident bundle (the recent
   history, the merged timeline tail, the kf-xray verdict, the detector
   verdicts, the active config) is written atomically under
   ``KF_SENTINEL_DIR/incidents/``.

With ``KF_SENTINEL_DIR`` unset :func:`Sentinel.from_env` returns ``None``
and the aggregator's views are unchanged.  The env is read directly
through the mirror constants below, whose defaults equal
:func:`kungfu_tpu_torch.utils.envs.sentinel_knobs` and
:class:`kungfu_tpu_torch.serve.slo.SLORules`.  History records, incident
bundles and ``/alerts`` are the reference's, field for field.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from kungfu_tpu_torch.monitor import detect, history, timeline
from kungfu_tpu_torch.monitor import ledger as ledgerlib
from kungfu_tpu_torch.monitor.aggregator import field, sum_metric
from kungfu_tpu_torch.utils import envs

# the sentinel's knobs (KF_SENTINEL_DIR and the rest of its rows in
# utils/envs.py) are read through envs.sentinel_knobs(); the
# serving SLO budgets are the SAME tokens serve/slo.py steers by: one
# knob, two consumers (target and alarm must never disagree)
TTFT_BUDGET_ENV = envs.SERVE_SLO_TTFT_MS
E2E_BUDGET_ENV = envs.SERVE_SLO_E2E_MS
# the knobs' names, as the reference's mirror constants name them
DIR_ENV = envs.SENTINEL_DIR
PERIOD_ENV = envs.SENTINEL_PERIOD
WINDOW_ENV = envs.SENTINEL_WINDOW
THRESHOLD_ENV = envs.SENTINEL_THRESHOLD
MFU_FLOOR_ENV = envs.SENTINEL_MFU_FLOOR
STEP_CEILING_ENV = envs.SENTINEL_STEP_CEILING_S
WARMUP_ENV = envs.SENTINEL_WARMUP_STEPS
INCIDENT_WINDOW_ENV = envs.SENTINEL_INCIDENT_WINDOW
SLO_SHORT_ENV = envs.SENTINEL_SLO_SHORT
SLO_LONG_ENV = envs.SENTINEL_SLO_LONG

DEFAULT_PERIOD_S = 1.0
DEFAULT_WARMUP_STEPS = 32
DEFAULT_INCIDENT_WINDOW = 64
DEFAULT_SLO_SHORT = 6
DEFAULT_SLO_LONG = 24
DEFAULT_SLO_SHORT_FRAC = 0.5
DEFAULT_SLO_LONG_FRAC = 0.25
DEFAULT_TTFT_BUDGET_MS = 500.0
DEFAULT_E2E_BUDGET_MS = 5000.0

#: series the changepoint rules judge, and the shift direction that is
#: BAD (a step-time drop or an MFU rise is an improvement, not an
#: incident) — rule names are ``regress:<series>``
CHANGEPOINT_SERIES = {
    "step_time_s": "up",
    "ttft_ms": "up",
    "e2e_ms": "up",
    "mfu": "down",
    # kf-pulse: a RISING gradient noise scale means the current batch
    # size stopped averaging the noise away — the convergence-efficiency
    # regression the GNS→batch-size autopilot (ROADMAP item 4) steers by
    "gns": "up",
}

#: merged timeline events an incident flight record carries at most
INCIDENT_EVENT_TAIL = 256

#: sentinel history stream names
CLUSTER_STREAM = "cluster"


def rank_stream(rank: int) -> str:
    return f"rank-{int(rank)}"


def extract_series(view: dict) -> Dict[str, float]:
    """The cluster-rollup sample one ``/cluster`` view yields: the flat
    ``{series: float}`` dict that is appended to the durable ``cluster``
    stream AND fed to the online detector — ONE extraction, so the two
    can never see different numbers.  A quantity the view cannot supply
    yet (no serving section, no MFU gauge) is simply absent: part-time
    series accumulate identically online and offline."""
    out: Dict[str, float] = {}
    rows = field(view, "ranks") or []
    step_times = [field(r, "step_time_s") for r in rows]
    step_times = [float(v) for v in step_times if v is not None]
    if step_times:
        out["step_time_s"] = sum(step_times) / len(step_times)
    steps = [field(r, "step") for r in rows]
    steps = [int(s) for s in steps if isinstance(s, int) and s >= 0]
    if steps:
        out["step"] = float(max(steps))
    egress = sum(float((field(r, "net") or {}).get("egress_bytes", 0))
                 for r in rows)
    if rows:
        out["egress_bytes"] = egress
    opt_bytes = sum(sum_metric(field(r, "gauges"), "kf_opt_state_bytes")
                    for r in rows)
    if opt_bytes:
        out["opt_state_bytes"] = opt_bytes
    mem = sum((field(r, "gauges") or {}).get(
        'kf_device_memory_bytes{kind="in_use"}', 0.0) for r in rows)
    if mem:
        out["device_mem_bytes"] = float(mem)
    compiles = sum(sum_metric(field(r, "counters"), "kf_jit_compiles_total")
                   for r in rows)
    if compiles:
        out["jit_compiles"] = float(compiles)
    # kf-pulse gauges: every reporting rank publishes the SAME collective
    # estimate (the inner mean is a collective), so the rollup is the
    # mean over the ranks carrying the gauge — identical per-rank values
    # pass through unchanged, and a straggler snapshot cannot double-count
    gns = [(field(r, "gauges") or {}).get("kf_gns") for r in rows]
    gns = [float(v) for v in gns if v is not None]
    if gns:
        out["gns"] = sum(gns) / len(gns)
    gvar = [(field(r, "gauges") or {}).get("kf_grad_variance") for r in rows]
    gvar = [float(v) for v in gvar if v is not None]
    if gvar:
        out["grad_variance"] = sum(gvar) / len(gvar)
    xr = field(view, "xray")
    if xr:
        mfu = field(xr, "mfu")
        if mfu:
            vals = [float(v) for v in mfu.values()]
            out["mfu"] = sum(vals) / len(vals)
        for ph, v in (field(xr, "phase_seconds") or {}).items():
            out[f"phase_{ph}"] = float(v)
    srv = field(view, "serving")
    if srv:
        ttft = field(srv, "ttft_ms")
        if ttft is not None:
            out["ttft_ms"] = float(ttft)
        e2e = field(srv, "e2e_ms")
        if e2e is not None:
            out["e2e_ms"] = float(e2e)
        out["kv_bytes"] = float(field(srv, "kv_bytes") or 0)
    return out


class Sentinel:
    """The aggregator's attached judge (see module docstring).

    Constructor arguments mirror the sentinel env knobs above;
    :func:`from_env` is the production path and returns ``None`` when
    ``KF_SENTINEL_DIR`` is unset — the whole plane gated on one token.
    """

    def __init__(self, root: str,
                 keep_bytes: Optional[int] = None,
                 period_s: float = DEFAULT_PERIOD_S,
                 window: int = detect.DEFAULT_WINDOW,
                 threshold: float = detect.DEFAULT_THRESHOLD,
                 mfu_floor: float = 0.0,
                 step_ceiling_s: float = 0.0,
                 warmup_steps: int = DEFAULT_WARMUP_STEPS,
                 incident_window: int = DEFAULT_INCIDENT_WINDOW,
                 slo_budgets: Optional[Dict[str, float]] = None,
                 slo_short: int = DEFAULT_SLO_SHORT,
                 slo_long: int = DEFAULT_SLO_LONG,
                 slo_short_frac: float = DEFAULT_SLO_SHORT_FRAC,
                 slo_long_frac: float = DEFAULT_SLO_LONG_FRAC):
        self.root = root
        self.period_s = float(period_s)
        self.window = max(2, int(window))
        self.threshold = float(threshold)
        self.mfu_floor = float(mfu_floor)
        self.step_ceiling_s = float(step_ceiling_s)
        self.warmup_steps = int(warmup_steps)
        self.incident_window = max(1, int(incident_window))
        self.slo_budgets = dict(slo_budgets) if slo_budgets else {
            "ttft_ms": DEFAULT_TTFT_BUDGET_MS,
            "e2e_ms": DEFAULT_E2E_BUDGET_MS,
        }
        self.slo_short = max(1, int(slo_short))
        self.slo_long = max(self.slo_short, int(slo_long))
        self.slo_short_frac = float(slo_short_frac)
        self.slo_long_frac = float(slo_long_frac)
        self._lock = threading.Lock()
        self._cluster_ring = history.HistoryRing(root, CLUSTER_STREAM,
                                                 keep_bytes=keep_bytes)
        # the decision ledger shares the sentinel's root and detector
        # knobs; ledger_for() registers the instance so every actor's
        # env-keyed record_decision() lands in the SAME stream whose
        # sample feed _observe_locked drives
        self.ledger = ledgerlib.ledger_for(root, window=self.window,
                                           threshold=self.threshold,
                                           keep_bytes=keep_bytes)
        self._rank_rings: Dict[int, history.HistoryRing] = {}
        self._keep_bytes = keep_bytes
        # per-series rolling buffers, capped at EXACTLY the tail
        # detect.changepoint() self-normalizes to — the offline replay
        # of the durable history computes the identical verdicts
        cap = (detect.BASELINE_WINDOWS + 1) * self.window
        self._cap = cap
        self._samples: Dict[str, deque] = {}
        self._records = 0                  # cluster records appended
        self._recent: deque = deque(maxlen=self.incident_window)
        self._last_sample_t: Optional[float] = None
        self._active: set = set()          # edge-trigger state
        self._alerts: List[dict] = []      # fired-alert log (bounded)
        self._max_alerts = 256
        self._incident_seq = 0
        self._compile_baseline: Optional[float] = None

    # -- construction -----------------------------------------------------
    @classmethod
    def from_env(cls) -> Optional["Sentinel"]:
        """The production constructor: ``None`` (no sentinel, no cost)
        unless ``KF_SENTINEL_DIR`` names the history root."""
        k = envs.sentinel_knobs()
        root = k["dir"].strip()
        if not root:
            return None
        return cls(
            root,
            keep_bytes=history.keep_bytes_from_env(),
            period_s=k["period_s"],
            window=k["window"],
            threshold=k["threshold"],
            mfu_floor=k["mfu_floor"],
            step_ceiling_s=k["step_ceiling_s"],
            warmup_steps=k["warmup_steps"],
            incident_window=k["incident_window"],
            slo_budgets={
                "ttft_ms": envs.parse_float_env(TTFT_BUDGET_ENV,
                                                DEFAULT_TTFT_BUDGET_MS),
                "e2e_ms": envs.parse_float_env(E2E_BUDGET_ENV,
                                               DEFAULT_E2E_BUDGET_MS),
            },
            slo_short=k["slo_short"],
            slo_long=k["slo_long"],
        )

    # -- aggregator hook --------------------------------------------------
    def on_ingest(self, agg) -> None:
        """The aggregator's post-ingest hook (called OUTSIDE its lock,
        guarded by the caller): samples at most once per ``period_s`` of
        the aggregator's clock — which is the fake clock in tests, so
        sampling cadence is deterministic."""
        now = agg._time()
        with self._lock:
            if (self._last_sample_t is not None
                    and self.period_s > 0
                    and now - self._last_sample_t < self.period_s):
                return
            self._last_sample_t = now
        view = agg.cluster_view()
        events = agg._all_events()
        self.observe(view, events)

    # -- the sample -------------------------------------------------------
    def observe(self, view: dict, events: Optional[List[dict]] = None
                ) -> List[dict]:
        """One sentinel sample over a ``/cluster`` view: record history,
        update buffers, evaluate every rule, fire edge-triggered alerts.
        Returns the alerts fired BY THIS SAMPLE (usually empty)."""
        with self._lock:
            return self._observe_locked(view, events or [])

    def _observe_locked(self, view: dict, events: List[dict]) -> List[dict]:
        series = extract_series(view)
        wall = field(view, "wall")
        record = {
            "kfhist": 1,
            "wall": wall,
            "series": series,
            "stale": field(view, "stale") or [],
            "straggler": field(view, "straggler"),
        }
        self._cluster_ring.append(record)
        self._records += 1
        self._recent.append(record)
        # the decision ledger sees EXACTLY the records the cluster
        # stream holds, in order — its series_n positions are therefore
        # replayable offline from the durable stream (kfhist --decisions)
        try:
            self.ledger.on_sample(record)
        except Exception:  # noqa: BLE001 - the join must not take sampling down
            pass
        for row in field(view, "ranks") or []:
            rank = field(row, "rank")
            if not isinstance(rank, int):
                continue
            ring = self._rank_rings.get(rank)
            if ring is None:
                ring = self._rank_rings[rank] = history.HistoryRing(
                    self.root, rank_stream(rank),
                    keep_bytes=self._keep_bytes)
            ring.append({
                "kfhist": 1,
                "wall": wall,
                "step": field(row, "step"),
                "step_time_s": field(row, "step_time_s"),
                "strategy": field(row, "strategy"),
                "net": field(row, "net") or {},
            })
        for name, value in series.items():
            buf = self._samples.get(name)
            if buf is None:
                buf = self._samples[name] = deque(maxlen=self._cap)
            buf.append(value)
        firing = self._evaluate(view, series)
        fired = []
        fired_rules = set(firing)
        for rule in sorted(fired_rules - self._active):
            alert = {
                "rule": rule,
                "wall": wall,
                "evidence": firing[rule],
            }
            self._fire(alert, view, events)
            fired.append(alert)
        # edge-trigger bookkeeping: a rule must RECOVER before it can
        # fire again (no wall-clock cooldown — deterministic under fake
        # clocks)
        self._active = fired_rules
        return fired

    # -- rules ------------------------------------------------------------
    def verdicts(self) -> Dict[str, dict]:
        """The per-series changepoint verdicts over the current buffers
        — the SAME object ``kfhist --verdict`` rebuilds from the durable
        history (asserted in tests)."""
        return detect.window_verdicts(
            {k: list(v) for k, v in self._samples.items()},
            window=self.window, threshold=self.threshold)

    def _evaluate(self, view: dict,
                  series: Dict[str, float]) -> Dict[str, dict]:
        """Every rule over the current buffers: ``{rule: evidence}`` of
        the rules satisfied RIGHT NOW (edge detection is the caller's)."""
        firing: Dict[str, dict] = {}
        verdicts = self.verdicts()
        for name, bad_direction in CHANGEPOINT_SERIES.items():
            v = verdicts.get(name)
            if v and v["shifted"] and v["direction"] == bad_direction:
                firing[f"regress:{name}"] = v
        for name, budget_ms in self.slo_budgets.items():
            buf = self._samples.get(name)
            if not buf:
                continue
            burn = detect.slo_burn(list(buf), budget_ms,
                                   self.slo_short, self.slo_long,
                                   self.slo_short_frac, self.slo_long_frac)
            if burn and burn["burning"]:
                firing[f"sloburn:{name}"] = burn
        if self.mfu_floor > 0 and 0 < series.get("mfu", self.mfu_floor + 1) \
                < self.mfu_floor:
            firing["watermark:mfu"] = {"mfu": series["mfu"],
                                       "floor": self.mfu_floor}
        if self.step_ceiling_s > 0 \
                and series.get("step_time_s", 0.0) > self.step_ceiling_s:
            firing["watermark:step_time"] = {
                "step_time_s": series["step_time_s"],
                "ceiling_s": self.step_ceiling_s}
        stale_slices = field(view, "stale_slices") or []
        if stale_slices:
            firing["watermark:stale_slice"] = {"slices": stale_slices}
        ckpt = self._ckpt_stale(view)
        if ckpt:
            firing["watermark:ckpt_age"] = {"ranks": ckpt}
        recompile = self._recompile_steady(series)
        if recompile:
            firing["watermark:recompile_steady"] = recompile
        return firing

    @staticmethod
    def _ckpt_stale(view: dict) -> List[dict]:
        """kftop's CKPT STALE condition, rule-ified: manifest age > 3x
        the persist period on any rank (one condition, two consumers —
        the dashboard alarm and this alert must agree)."""
        out = []
        for row in field(view, "ranks") or []:
            gauges = field(row, "gauges") or {}
            period = sum_metric(gauges, "kf_ckpt_period_seconds")
            age = sum_metric(gauges, "kf_ckpt_age_seconds")
            if period > 0 and age > 3 * period:
                out.append({"rank": field(row, "rank"),
                            "age_s": age, "period_s": period})
        return out

    def _recompile_steady(self, series: Dict[str, float]) -> Optional[dict]:
        """Compiles AFTER warmup (in the port, CUDA-graph captures: see
        :func:`kungfu_tpu_torch.monitor.metrics.install_compile_metrics`):
        the baseline count is pinned the first sample past
        ``warmup_steps``; any growth beyond it means a new shape was
        captured mid-run."""
        step = series.get("step")
        compiles = series.get("jit_compiles")
        if step is None or compiles is None or step <= self.warmup_steps:
            return None
        if self._compile_baseline is None:
            self._compile_baseline = compiles
            return None
        if compiles > self._compile_baseline:
            return {"compiles": compiles,
                    "baseline": self._compile_baseline,
                    "after_step": self.warmup_steps}
        return None

    # -- alert fan-out ----------------------------------------------------
    def _fire(self, alert: dict, view: dict, events: List[dict]) -> None:
        rule = alert["rule"]
        self._alerts.append(alert)
        del self._alerts[:-self._max_alerts]
        # counted kind: ticks kf_alerts_total{rule=...} even with
        # tracing off; force=True lands it in the flight recorder ring
        # regardless, so the dump of a broken run shows its alerts
        timeline.event("alert", rule, force=True, wall=alert["wall"])
        try:
            alert["incident"] = self._dump_incident(alert, view, events)
        except OSError:
            # an unwritable incident dir must not take the plane down;
            # the alert itself (counter, timeline, /alerts) still fired
            alert["incident"] = None

    def _dump_incident(self, alert: dict, view: dict,
                       events: List[dict]) -> str:
        """The incident flight record: bounded evidence, atomically
        written (a crash mid-dump leaves no torn bundle)."""
        self._incident_seq += 1
        safe_rule = alert["rule"].replace(":", "-").replace("/", "-")
        strategies = {str(field(r, "rank")): field(r, "strategy") or ""
                      for r in field(view, "ranks") or []}
        bundle = {
            "kfincident": 1,
            "wall": alert["wall"],
            "alert": {k: alert[k] for k in ("rule", "wall", "evidence")},
            # history_n lets the offline replay select the SAME record
            # prefix this verdict was computed over: kfhist --verdict
            # --upto <history_n> must reproduce `verdicts` exactly
            "history_n": self._records,
            "history": list(self._recent),
            "timeline_tail": events[-INCIDENT_EVENT_TAIL:],
            "xray": field(view, "xray"),
            "verdicts": self.verdicts(),
            "config": {
                "cluster": field(view, "cluster"),
                "strategies": strategies,
                "serving": field(view, "serving"),
                "stale": field(view, "stale") or [],
                "active_alerts": sorted(self._active | {alert["rule"]}),
            },
        }
        inc_dir = os.path.join(self.root, "incidents")
        os.makedirs(inc_dir, exist_ok=True)
        path = os.path.join(
            inc_dir, f"incident-{self._incident_seq:06d}-{safe_rule}.json")
        history._atomic_write(
            path, json.dumps(bundle, sort_keys=True).encode("utf-8"))
        return path

    # -- read side --------------------------------------------------------
    def alerts_view(self) -> dict:
        """The ``/alerts`` JSON: active rules, the fired-alert log, and
        the live detector verdicts."""
        with self._lock:
            return {
                "kfsentinel": 1,
                "active": sorted(self._active),
                "alerts": [
                    {k: a.get(k) for k in
                     ("rule", "wall", "evidence", "incident")}
                    for a in self._alerts
                ],
                "verdicts": self.verdicts(),
                "records": self._records,
                "window": self.window,
                "threshold": self.threshold,
                "decisions": self.ledger.summary(),
            }
