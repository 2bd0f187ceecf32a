"""kfmon: the live cluster observability plane (port of
``kungfu_tpu/monitor/aggregator.py``, stdlib only).

Every rank runs a :class:`RankReporter` thread that pushes a compact
:func:`make_snapshot` to a :class:`ClusterAggregator` mounted in the
elastic :class:`~kungfu_tpu_torch.elastic.configserver.ConfigServer`
(``POST /push``), which serves the rolling cluster view as ``GET
/cluster``: per-rank freshness (a rank is *stale* after
``KF_CONFIG_MONITOR_STALE_AFTER`` seconds without a snapshot), slice
grouping, online skew and straggler verdicts over the pushed collective
spans (:mod:`~kungfu_tpu_torch.monitor.skew`), the step-time
attribution (:mod:`~kungfu_tpu_torch.monitor.xray`), the serving and
gradient-signal rollups, and the control events the elastic layer posts
(:func:`post_control`).

Snapshot and view field names are the declared schema constants below,
and the wire is the reference's JSON, so either package's reporter
pushes to either package's aggregator.  The plane is off unless
``KF_CONFIG_ENABLE_CLUSTER_MONITOR`` is truthy.

:meth:`ClusterAggregator.render_prometheus` gives the cluster plane's
Prometheus series, which the config server merges into ``/metrics``.
:meth:`ClusterAggregator.attach_sentinel` attaches the judging plane
(:mod:`~kungfu_tpu_torch.monitor.sentinel`): it samples after each
ingest and adds the ``alerts`` section to ``/cluster`` and
``kf_cluster_alerts_active`` to ``/metrics``.  Without one, both are
what they were before the sentinel existed.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional

from kungfu_tpu_torch.monitor import skew as skewlib
from kungfu_tpu_torch.monitor import xray as xraylib
from kungfu_tpu_torch.monitor.registry import REGISTRY, _escape_label_value
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("kfmon")

# env mirror constants, defined next to their reader like timeline.py's
# DUMP_ENV/CAP_ENV; utils/envs.py registers the same tokens for the
# env-contract scan
ENABLE_ENV = "KF_CONFIG_ENABLE_CLUSTER_MONITOR"
PUSH_PERIOD_ENV = "KF_CONFIG_MONITOR_PUSH_PERIOD"
STALE_AFTER_ENV = "KF_CONFIG_MONITOR_STALE_AFTER"

DEFAULT_PUSH_PERIOD_S = 1.0
#: stale = this many push periods without a snapshot (when
#: KF_CONFIG_MONITOR_STALE_AFTER does not pin an absolute value)
STALE_PERIODS = 3.0

#: wire-format version stamped on every snapshot/control message
WIRE_VERSION = 1

#: one snapshot = one JSON object with EXACTLY these fields.  Producers
#: go through :func:`make_snapshot`, consumers through :func:`field` —
#: both enforced to literal members of this set by the ``agg-schema``
#: kflint rule (and revalidated at runtime, for payloads built by hand).
SNAPSHOT_FIELDS = frozenset({
    "kfmon",         # wire version (int)
    "rank",          # stable process identity (bootstrap rank)
    "slice",         # TPU slice id (None on single-slice jobs)
    "pid",           # sender pid
    "wall",          # sender wall-clock at build time
    "step",          # current training step (-1 before the first)
    "step_time_s",   # EMA seconds per step (None until measurable)
    "counters",      # {metric-key: int} cumulative registry counters
    "gauges",        # {metric-key: float} registry gauges (GNS et al.)
    "latency",       # {metric-key: {count, sum}} histogram DELTAS
    "events",        # recent flight-recorder events (skew feedstock)
    "net",           # {egress_bytes, ingress_bytes} cumulative totals
    "strategy",      # active allreduce strategy name ("" = default)
})

#: fields of the ``/cluster`` view (and its per-rank rows / control
#: entries) — the read-side vocabulary ``kftop`` renders from.
VIEW_FIELDS = frozenset({
    "kfmon", "wall", "stale_after_s", "cluster", "ranks", "stale",
    "skew", "slowest_per_step", "straggler", "controls",
    # slice grouping (multislice jobs; empty on single-slice)
    "slices", "stale_slices",
    # cluster-health subfields
    "version", "size", "workers", "quorum_margin", "last_control",
    # per-rank row subfields (snapshot fields age_s/stale are computed)
    "rank", "slice", "pid", "step", "step_time_s", "age_s", "counters",
    "gauges", "latency", "net", "strategy",
    # per-slice group subfields ("slice"/"ranks"/"stale" shared above)
    "all_stale",
    # control-event subfields
    "kind", "attrs",
    # skew-row subfields (monitor/skew.py row dicts)
    "op", "tag", "slowest_rank", "slowest_s", "fastest_rank",
    "fastest_s", "skew_s", "total_s",
    # kf-sentinel section (present ONLY when a Sentinel is attached —
    # the disabled plane is byte-identical to the pre-sentinel view):
    # active rules + fired-alert log + live detector verdicts, plus the
    # kf-ledger decision summary a policy steers by
    "alerts", "active", "rule", "evidence", "incident", "verdicts",
    "decisions",
    # kf-pulse section (None when no rank exports the gradient-signal
    # gauges): cluster means of the kf_gns / kf_grad_variance gauges and
    # the per-group kf_grad_norm{group=} rollup
    "pulse", "gns", "grad_variance", "groups",
    # serving summary (kf-serve; None on deployments with no serve
    # metrics): cluster-wide sums of the per-rank serve gauges/counters
    # plus window-mean latencies from the pushed histogram deltas
    "serving", "active", "queued", "kv_bytes", "completed", "rejected",
    "replayed", "ttft_ms", "e2e_ms",
    # kf-xray section (None when the window holds nothing attributable):
    # the step-time attribution + verdict computed by monitor/xray.py —
    # the SAME implementation `kftrace --critical-path` runs offline —
    # plus the MFU / model-FLOPs rollup from the pushed gauges
    "xray", "verdict", "phases", "steps", "culprit", "critical_rank",
    "dominant", "steps_seen", "wall_s", "mfu", "model_flops_s",
    "phase_seconds", "dropped_events",
})


def _esc_label(v) -> str:
    """Prometheus exposition-format label-value escaping (one rule set
    for the whole package — registry.py owns it)."""
    return _escape_label_value(str(v))


def _parse_float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: floor on the push period: a 0/negative env value must not turn every
#: rank into a busy-loop of HTTP POSTs (disable via the ENABLE env, not
#: a zero period)
MIN_PUSH_PERIOD_S = 0.05


def push_period_from_env() -> float:
    v = _parse_float_env(PUSH_PERIOD_ENV, DEFAULT_PUSH_PERIOD_S)
    if v <= 0:
        return DEFAULT_PUSH_PERIOD_S
    # clamp a too-small positive value UP rather than ignoring it, so
    # every consumer of the knob (reporter period, staleness default,
    # the launcher's aggregator) lands on the same effective period
    return max(v, MIN_PUSH_PERIOD_S)


def stale_after_from_env(period: Optional[float] = None) -> float:
    period = push_period_from_env() if period is None else period
    return _parse_float_env(STALE_AFTER_ENV, STALE_PERIODS * period)


def make_snapshot(**fields) -> dict:
    """Build one wire snapshot; unknown field names raise — the runtime
    backstop behind the static ``agg-schema`` rule."""
    unknown = set(fields) - SNAPSHOT_FIELDS
    if unknown:
        raise ValueError(
            f"unknown snapshot field(s) {sorted(unknown)}; the schema is "
            f"SNAPSHOT_FIELDS in kungfu_tpu_torch/monitor/aggregator.py"
        )
    snap = {"kfmon": WIRE_VERSION}
    snap.update(fields)
    return snap


def field(obj: dict, name: str, default=None):
    """Schema-checked read of one snapshot/view field.  Call sites must
    pass a string literal from the declared schema (``agg-schema``
    kflint rule) — so a typo'd field fails lint instead of silently
    rendering an empty ``kftop`` column."""
    return obj.get(name, default)


def sum_metric(mapping: Optional[dict], name: str) -> float:
    """Sum of a pushed counter/gauge over its label variants (the
    registry renders ``kf_x_total{what="y"}`` per label set).  The ONE
    implementation of the label-key match — the serving rollup here and
    kftop's per-rank columns must never disagree on it."""
    return sum(v for k, v in (mapping or {}).items()
               if k == name or k.startswith(name + "{"))


def control_event(kind: str, rank: Optional[int] = None, **attrs) -> dict:
    """A control-plane event (shrink/resize/...) for :func:`post_control`."""
    return {
        "kfmon_control": WIRE_VERSION,
        "kind": kind,
        "rank": rank,
        "wall": time.time(),
        "attrs": attrs,
    }


def server_base(config_server_url: str) -> str:
    """The aggregator's HTTP base from any config-server URL: scheme +
    authority, path dropped (``http://h:9100/get`` → ``http://h:9100``)."""
    from urllib.parse import urlsplit

    url = config_server_url.strip().rstrip("/")
    if "://" not in url:
        # a bare host:port would parse its host as a scheme
        url = "http://" + url
    parts = urlsplit(url)
    return f"{parts.scheme}://{parts.netloc}"


def _post_json(url: str, obj: dict, timeout: float) -> None:
    req = urllib.request.Request(
        url,
        data=json.dumps(obj).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        resp.read()


def post_control(config_server_url: str, kind: str,
                 rank: Optional[int] = None, timeout: float = 2.0,
                 **attrs) -> bool:
    """Best-effort control-event push (elastic layer → aggregator).
    Never raises: the monitoring plane must not take a recovery path
    down with it.  Returns delivery success for tests."""
    if not config_server_url:
        return False
    try:
        _post_json(server_base(config_server_url) + "/push",
                   control_event(kind, rank=rank, **attrs), timeout)
        return True
    except (OSError, http.client.HTTPException) as e:
        _log.debug("control event %r not delivered: %s", kind, e)
        return False


# -- aggregator (config-server side) ---------------------------------------
class ClusterAggregator:
    """Rolling cluster view over pushed rank snapshots + control events.

    Thread-safe; mounted into the ConfigServer's HTTP handler (`/push`,
    `/cluster`, `/metrics`).  Per-rank event windows are bounded: skew
    is an *online* signal over the recent past, not an archive — the
    archive is the flight-recorder dump."""

    def __init__(self, stale_after: Optional[float] = None,
                 max_events_per_rank: int = 4096,
                 max_controls: int = 64,
                 time_fn: Callable[[], float] = time.time):
        self.stale_after = (stale_after if stale_after is not None
                            else stale_after_from_env())
        self._lock = threading.Lock()
        self._time = time_fn
        self._ranks: Dict[int, dict] = {}        # rank -> last snapshot
        self._seen: Dict[int, float] = {}        # rank -> arrival time
        self._events: Dict[int, deque] = {}      # rank -> recent events
        self._max_events = max_events_per_rank
        self._controls: deque = deque(maxlen=max_controls)
        #: the attached kf-sentinel (None: off, and every view is what it
        #: was before the sentinel existed)
        self._sentinel = None

    def attach_sentinel(self, sentinel) -> None:
        """Attach the kf-sentinel judging plane (duck-typed: this module
        must not import :mod:`~kungfu_tpu_torch.monitor.sentinel`, which
        imports it).  The sentinel samples after ingests and contributes
        the ``alerts`` section of ``/cluster``."""
        self._sentinel = sentinel

    def _notify_sentinel(self) -> None:
        """Post-ingest sentinel hook, outside the aggregator lock (the
        sentinel calls back into ``cluster_view``) and guarded: the
        judging plane must never take the ingest path down."""
        s = self._sentinel
        if s is None:
            return
        try:
            s.on_ingest(self)
        except Exception as e:  # noqa: BLE001 - monitoring must not raise
            _log.debug("sentinel sample failed: %s", e)

    # -- ingest ----------------------------------------------------------
    def ingest(self, obj: dict) -> None:
        """One pushed JSON object: a rank snapshot or a control event."""
        if not isinstance(obj, dict):
            raise ValueError("push payload must be a JSON object")
        if obj.get("kfmon_control"):
            dead = []
            if obj.get("kind") == "shrink":
                dead = [r for r in (obj.get("attrs") or {}).get("dead", [])
                        if isinstance(r, int)]
            with self._lock:
                self._controls.append(dict(obj))
                # a shrink evicts the dead ranks' state: their last spans
                # would otherwise feed the skew verdict forever (no new
                # pushes rotate a dead rank's window), leaving /cluster
                # naming a rank that no longer exists
                for r in dead:
                    self._events.pop(r, None)
                    self._ranks.pop(r, None)
                    self._seen.pop(r, None)
            REGISTRY.counter("kf_cluster_control_events_total",
                             what=str(obj.get("kind"))).inc()
            self._notify_sentinel()
            return
        if not obj.get("kfmon"):
            raise ValueError("push payload is neither snapshot nor control")
        unknown = set(obj) - SNAPSHOT_FIELDS
        if unknown:
            raise ValueError(f"unknown snapshot field(s) {sorted(unknown)}")
        rank = obj.get("rank")
        if not isinstance(rank, int):
            raise ValueError("snapshot carries no integer rank")
        events = obj.get("events") or []
        with self._lock:
            self._ranks[rank] = obj
            self._seen[rank] = self._time()
            win = self._events.get(rank)
            if win is None:
                win = self._events[rank] = deque(maxlen=self._max_events)
            for ev in events:
                # the skew math keys on the emitting rank; a reporter
                # forwarding ring events recorded before Peer.start
                # installed the default stamps them itself
                if ev.get("rank") is None:
                    ev = dict(ev, rank=rank)
                win.append(ev)
        self._notify_sentinel()

    # -- views -----------------------------------------------------------
    @staticmethod
    def _serving_summary(rows: List[dict]) -> Optional[dict]:
        """Cluster-wide serving rollup from per-rank rows (the kf-serve
        gauges/counters/histogram-deltas every snapshot already
        carries); ``None`` when no rank serves, so a training-only
        deployment renders no serving section."""

        def gauge_sum(name: str) -> float:
            return sum(sum_metric(row.get("gauges"), name) for row in rows)

        def counter_sum(name: str, what: str) -> int:
            sel = f'{name}{{what="{what}"}}'
            return sum((row.get("counters") or {}).get(sel, 0)
                       for row in rows)

        def window_ms(hist: str) -> Optional[float]:
            count = total = 0.0
            for row in rows:
                for k, d in (row.get("latency") or {}).items():
                    if k == hist or k.startswith(hist + "{"):
                        count += d.get("count", 0)
                        total += d.get("sum", 0.0)
            return (total / count * 1e3) if count else None

        serving = any(
            k.startswith(("kf_serve_", "kf_kv_cache_bytes"))
            for row in rows
            for k in list(row.get("gauges") or {})
            + list(row.get("counters") or {}))
        if not serving:
            return None
        return {
            "active": int(gauge_sum("kf_serve_active_requests")),
            "queued": int(gauge_sum("kf_serve_queue_depth")),
            "kv_bytes": int(gauge_sum("kf_kv_cache_bytes")),
            "completed": counter_sum("kf_serve_requests_total", "complete"),
            "rejected": counter_sum("kf_serve_requests_total", "reject"),
            "replayed": counter_sum("kf_serve_requests_total", "replay"),
            "ttft_ms": window_ms("kf_serve_ttft_seconds"),
            "e2e_ms": window_ms("kf_serve_e2e_seconds"),
        }

    @staticmethod
    def _pulse_summary(rows: List[dict]) -> Optional[dict]:
        """Cluster-wide gradient-signal rollup (kf-pulse): means of the
        per-rank ``kf_gns`` / ``kf_grad_variance`` gauges (every rank
        publishes the SAME collective estimate, so the mean passes
        identical values through) plus the per-group
        ``kf_grad_norm{group=}`` rollup.  ``None`` when no rank exports
        pulse gauges, so an uninstrumented deployment renders no PULSE
        section."""
        gns: List[float] = []
        gvar: List[float] = []
        groups: Dict[str, List[float]] = {}
        prefix = 'kf_grad_norm{group="'
        for row in rows:
            gauges = row.get("gauges") or {}
            v = gauges.get("kf_gns")
            if v is not None:
                gns.append(float(v))
            v = gauges.get("kf_grad_variance")
            if v is not None:
                gvar.append(float(v))
            for key, val in gauges.items():
                if key.startswith(prefix) and key.endswith('"}'):
                    groups.setdefault(key[len(prefix):-2],
                                      []).append(float(val))
        if not gns and not gvar and not groups:
            return None
        return {
            "gns": (sum(gns) / len(gns)) if gns else None,
            "grad_variance": (sum(gvar) / len(gvar)) if gvar else None,
            "groups": {g: sum(vs) / len(vs)
                       for g, vs in sorted(groups.items())},
        }

    @staticmethod
    def _xray_summary(rows: List[dict],
                      events: List[dict]) -> Optional[dict]:
        """The ``/cluster`` ``xray`` section: step-time attribution +
        verdict from the pushed event windows (:func:`kungfu_tpu_torch.monitor.
        xray.online_view` — the same implementation ``kftrace
        --critical-path`` runs offline, so the two cannot disagree) plus
        the MFU / model-FLOPs / per-phase-gauge / trace-loss rollup from
        the per-rank snapshots.  ``None`` when nothing is attributable
        and no rank exports xray gauges."""
        body = xraylib.online_view(events)
        mfu: Dict[int, float] = {}
        flops_s = 0.0
        phase_sums: Dict[str, List[float]] = {}
        dropped: Dict[int, int] = {}
        for row in rows:
            gauges = row.get("gauges") or {}
            m = gauges.get("kf_mfu")
            if m is not None:
                mfu[row["rank"]] = float(m)
            flops_s += sum_metric(gauges, "kf_model_flops_s")
            prefix = 'kf_step_phase_seconds{phase="'
            for key, val in gauges.items():
                if key.startswith(prefix) and key.endswith('"}'):
                    phase = key[len(prefix):-2]
                    phase_sums.setdefault(phase, []).append(float(val))
            drops = sum_metric(row.get("counters"),
                               "kf_timeline_dropped_total")
            if drops:
                dropped[row["rank"]] = int(drops)
        # MEAN over the ranks exporting each phase, never the rank-sum:
        # kftop renders this under a per-step label, and an N-rank sum
        # would read as an N-fold-inflated step (FLOP/s sums honestly —
        # rates add across ranks; per-step seconds do not)
        phase_seconds = {ph: sum(vs) / len(vs)
                         for ph, vs in phase_sums.items()}
        # a lossy ring alone still warrants the section: the TRACE LOSS
        # signal must not vanish just because the surviving window holds
        # nothing attributable (that is exactly when drops matter most)
        if (body is None and not mfu and not flops_s and not phase_seconds
                and not dropped):
            return None
        out = dict(body or {"verdict": None, "steps": []})
        out["mfu"] = mfu or None
        out["model_flops_s"] = flops_s or None
        out["phase_seconds"] = phase_seconds or None
        out["dropped_events"] = dropped or None
        return out

    def _all_events(self) -> List[dict]:
        with self._lock:
            return [e for win in self._events.values() for e in win]

    def stale_ranks(self) -> List[int]:
        now = self._time()
        with self._lock:
            return sorted(r for r, t in self._seen.items()
                          if now - t > self.stale_after)

    def cluster_view(self, cluster_info: Optional[dict] = None,
                     top: int = 20) -> dict:
        """The ``/cluster`` JSON: cluster health + per-rank freshness +
        online skew.  ``cluster_info`` is the co-hosted config server's
        ``{version, size, workers}`` (None when it holds no cluster)."""
        now = self._time()
        with self._lock:
            ranks = dict(self._ranks)
            seen = dict(self._seen)
            controls = list(self._controls)
        events = self._all_events()
        rows = []
        stale = []
        for rank in sorted(ranks):
            snap = ranks[rank]
            age = now - seen[rank]
            is_stale = age > self.stale_after
            if is_stale:
                stale.append(rank)
            rows.append({
                "rank": rank,
                "slice": snap.get("slice"),
                "pid": snap.get("pid"),
                "step": snap.get("step"),
                "step_time_s": snap.get("step_time_s"),
                "age_s": age,
                "stale": is_stale,
                "counters": snap.get("counters") or {},
                "gauges": snap.get("gauges") or {},
                "latency": snap.get("latency") or {},
                "net": snap.get("net") or {},
                "strategy": snap.get("strategy") or "",
            })
        # slice grouping (multislice jobs): a WHOLE-stale slice is a
        # different animal than a stale rank — it is the slice-loss
        # signature (DCN partition / power), the event the slice-shrink
        # protocol exists for, so /cluster and kftop flag it distinctly
        by_slice: Dict[int, dict] = {}
        for row in rows:
            s = row["slice"]
            if s is None:
                continue
            g = by_slice.setdefault(
                int(s), {"slice": int(s), "ranks": [], "stale": []})
            g["ranks"].append(row["rank"])
            if row["stale"]:
                g["stale"].append(row["rank"])
        slice_groups = []
        stale_slices = []
        for s in sorted(by_slice):
            g = by_slice[s]
            g["all_stale"] = bool(g["ranks"]) and g["stale"] == g["ranks"]
            if g["all_stale"]:
                stale_slices.append(s)
            slice_groups.append(g)
        health = dict(cluster_info or {})
        size = health.get("size")
        if isinstance(size, int) and size > 0:
            # deaths survivable before strict majority is lost: the
            # shrink path needs 2*survivors > size
            health["quorum_margin"] = size - (size // 2 + 1)
        if controls:
            health["last_control"] = controls[-1]
        view = {
            "kfmon": WIRE_VERSION,
            "wall": now,
            "stale_after_s": self.stale_after,
            "cluster": health,
            "ranks": rows,
            "stale": stale,
            "slices": slice_groups,
            "stale_slices": stale_slices,
            "serving": self._serving_summary(rows),
            "pulse": self._pulse_summary(rows),
            "xray": self._xray_summary(rows, events),
            "skew": skewlib.skew_rows(events)[:top],
            "slowest_per_step": skewlib.slowest_rank_per_step(events)[-top:],
            "straggler": skewlib.straggler_verdict(events),
            "controls": controls[-top:],
        }
        # the alerts section exists only with a sentinel attached: with
        # the plane off, /cluster is what it was before the sentinel
        s = self._sentinel
        if s is not None:
            view["alerts"] = s.alerts_view()
        return view

    def render_prometheus(self, cluster_info: Optional[dict] = None,
                          top: int = 20) -> str:
        """Cluster-plane series merged into the config server's
        ``/metrics`` so one stock-Prometheus scrape of the control
        process covers the whole job."""
        view = self.cluster_view(cluster_info, top=top)
        lines = [
            "# HELP kf_cluster_ranks ranks that have pushed a snapshot",
            "# TYPE kf_cluster_ranks gauge",
            f"kf_cluster_ranks {len(view['ranks'])}",
            "# HELP kf_cluster_stale_ranks ranks past the staleness threshold",
            "# TYPE kf_cluster_stale_ranks gauge",
            f"kf_cluster_stale_ranks {len(view['stale'])}",
        ]
        if view["slices"]:
            lines += [
                "# HELP kf_cluster_stale_slices slices whose EVERY rank "
                "is stale (slice-loss signature)",
                "# TYPE kf_cluster_stale_slices gauge",
                f"kf_cluster_stale_slices {len(view['stale_slices'])}",
            ]
        if view["serving"]:
            srv = view["serving"]
            lines += [
                "# HELP kf_cluster_serve_active decode slots occupied "
                "across the serving deployment",
                "# TYPE kf_cluster_serve_active gauge",
                f"kf_cluster_serve_active {srv['active']}",
                "# HELP kf_cluster_serve_queued accepted-but-unfinished "
                "requests across routers",
                "# TYPE kf_cluster_serve_queued gauge",
                f"kf_cluster_serve_queued {srv['queued']}",
                "# HELP kf_cluster_kv_cache_bytes paged KV-cache "
                "footprint summed over serving ranks",
                "# TYPE kf_cluster_kv_cache_bytes gauge",
                f"kf_cluster_kv_cache_bytes {srv['kv_bytes']}",
            ]
        if view["pulse"]:
            pl = view["pulse"]
            if pl.get("gns") is not None:
                lines += [
                    "# HELP kf_cluster_gns gradient noise scale, mean "
                    "over reporting ranks (kf-pulse)",
                    "# TYPE kf_cluster_gns gauge",
                    f"kf_cluster_gns {pl['gns']:.6g}",
                ]
            if pl.get("grad_variance") is not None:
                lines += [
                    "# HELP kf_cluster_grad_variance cross-peer gradient "
                    "variance, mean over reporting ranks (kf-pulse)",
                    "# TYPE kf_cluster_grad_variance gauge",
                    f"kf_cluster_grad_variance {pl['grad_variance']:.6g}",
                ]
        if view["xray"]:
            xr = view["xray"]
            if xr.get("mfu"):
                lines += [
                    "# HELP kf_cluster_mfu model-FLOPs utilization per "
                    "rank (analytic FLOPs / detected chip peak)",
                    "# TYPE kf_cluster_mfu gauge",
                ]
                for r in sorted(xr["mfu"]):
                    lines.append(
                        f'kf_cluster_mfu{{rank="{r}"}} {xr["mfu"][r]:.6g}')
            if xr.get("model_flops_s"):
                lines += [
                    "# HELP kf_cluster_model_flops_s analytic model "
                    "FLOP/s summed over reporting ranks",
                    "# TYPE kf_cluster_model_flops_s gauge",
                    f"kf_cluster_model_flops_s {xr['model_flops_s']:.6g}",
                ]
            if xr.get("phase_seconds"):
                lines += [
                    "# HELP kf_cluster_step_phase_seconds per-phase step-"
                    "time decomposition, mean over reporting ranks "
                    "(kf-xray taxonomy)",
                    "# TYPE kf_cluster_step_phase_seconds gauge",
                ]
                for ph in sorted(xr["phase_seconds"]):
                    lines.append(
                        f'kf_cluster_step_phase_seconds'
                        f'{{phase="{_esc_label(ph)}"}} '
                        f'{xr["phase_seconds"][ph]:.6g}')
        if view.get("alerts"):
            lines += [
                "# HELP kf_cluster_alerts_active kf-sentinel rules "
                "currently firing",
                "# TYPE kf_cluster_alerts_active gauge",
                f"kf_cluster_alerts_active "
                f"{len(view['alerts']['active'])}",
            ]
        version = (view["cluster"] or {}).get("version")
        if version is not None:
            lines += [
                "# HELP kf_cluster_config_version current cluster config version",
                "# TYPE kf_cluster_config_version gauge",
                f"kf_cluster_config_version {version}",
            ]
        if view["ranks"]:
            lines += [
                "# HELP kf_cluster_rank_age_seconds seconds since a rank's last snapshot",
                "# TYPE kf_cluster_rank_age_seconds gauge",
            ]
            for row in view["ranks"]:
                lines.append(
                    f'kf_cluster_rank_age_seconds{{rank="{row["rank"]}"}} '
                    f'{row["age_s"]:.6g}')
            lines += [
                "# HELP kf_cluster_rank_step a rank's last reported training step",
                "# TYPE kf_cluster_rank_step gauge",
            ]
            for row in view["ranks"]:
                if row["step"] is not None:
                    lines.append(
                        f'kf_cluster_rank_step{{rank="{row["rank"]}"}} '
                        f'{row["step"]}')
            st_rows = [r for r in view["ranks"]
                       if r["step_time_s"] is not None]
            if st_rows:
                lines += [
                    "# HELP kf_cluster_rank_step_time_seconds EMA step time per rank",
                    "# TYPE kf_cluster_rank_step_time_seconds gauge",
                ]
                for row in st_rows:
                    lines.append(
                        f'kf_cluster_rank_step_time_seconds'
                        f'{{rank="{row["rank"]}"}} {row["step_time_s"]:.6g}')
        if view["skew"]:
            lines += [
                "# HELP kf_cluster_skew_seconds cross-rank duration skew per collective tag",
                "# TYPE kf_cluster_skew_seconds gauge",
            ]
            for row in view["skew"]:
                # op/tag are user-supplied collective names — escape per
                # the exposition format or one odd name (quote, newline)
                # invalidates the entire cluster-plane scrape
                lines.append(
                    f'kf_cluster_skew_seconds{{op="{_esc_label(row["op"])}",'
                    f'tag="{_esc_label(row["tag"])}"}} {row["skew_s"]:.6g}')
        return "\n".join(lines) + "\n"


# -- reporter (rank side) --------------------------------------------------
#: event kinds a snapshot forwards to the aggregator: the skew feedstock
#: plus the fault kinds (so `/cluster` can correlate them online)
REPORT_KINDS = (frozenset(skewlib.COLLECTIVE_KINDS)
                | frozenset(skewlib.FAULT_KINDS)
                # kf-adapt swap events ride the same push so kftop's
                # control/event surfaces see lockstep strategy changes
                | frozenset({"swap"})
                # kf-xray attribution feedstock: REPORT_KINDS must stay
                # a superset of xray.XRAY_KINDS (asserted in tests) or
                # the online verdict would compute from fewer kinds than
                # the offline report and the two could disagree
                | xraylib.XRAY_KINDS | frozenset({"xray"}))

#: EMA weight for the step-time estimate (~5-push memory)
_STEP_EMA_ALPHA = 0.2

#: gauges that one rank owns where several ranks share this process's
#: registry (co-resident peers, ``peer.start_local_cluster``): name ->
#: {rank: fn}.  While a name has owners, each reporter sends its own
#: rank's ``fn()`` under it, or nothing, never the process's value, so a
#: rollup counts each owner once.  A process of one rank (the
#: reference's deployment) sends the value it would send without them
_RANK_GAUGES: Dict[str, Dict[int, Callable[[], float]]] = {}
_RANK_GAUGES_LOCK = threading.Lock()


def own_gauge(name: str, rank: int, fn: Callable[[], float]) -> None:
    """Report gauge ``name`` for ``rank`` from ``fn()`` from now on."""
    with _RANK_GAUGES_LOCK:
        _RANK_GAUGES.setdefault(name, {})[rank] = fn


def disown_gauge(name: str, rank: int, fn: Callable[[], float]) -> None:
    """Undo :func:`own_gauge` (a no-op unless ``fn`` still owns it)."""
    with _RANK_GAUGES_LOCK:
        owners = _RANK_GAUGES.get(name, {})
        if owners.get(rank) is fn:
            del owners[rank]
            if not owners:
                del _RANK_GAUGES[name]


def _owned_gauges(rank: int, gauges: Dict[str, float]) -> None:
    """Replace the process's values of the owned gauges in ``gauges``
    with ``rank``'s own, or drop them where ``rank`` owns none."""
    with _RANK_GAUGES_LOCK:
        mine = {name: owners.get(rank)
                for name, owners in _RANK_GAUGES.items()}
    for name, fn in mine.items():
        gauges.pop(name, None)
        if fn is not None:
            try:
                gauges[name] = float(fn())
            except Exception as e:  # noqa: BLE001 - monitoring must not raise
                _log.debug("owned gauge %s unavailable: %s", name, e)


#: RankReporter slice_id default: "derive from the MEGASCALE env" —
#: distinct from an explicit None ("no slice", authoritative)
_SLICE_FROM_ENV = object()


class RankReporter:
    """Per-rank snapshot pusher: one daemon thread, one HTTP POST per
    ``KF_CONFIG_MONITOR_PUSH_PERIOD``.  Delivery failures are swallowed
    (a dead aggregator must not take training down); the aggregator's
    staleness clock is the receiving side of the same contract."""

    def __init__(self, rank: int, server_url: str,
                 period: Optional[float] = None,
                 strategy_fn: Optional[Callable[[], str]] = None,
                 net_totals_fn: Optional[Callable[[], Dict[str, int]]] = None,
                 events_fn: Optional[Callable[[], List[dict]]] = None,
                 slice_id=_SLICE_FROM_ENV,
                 pre_snapshot_fn: Optional[Callable[[], None]] = None):
        self.rank = rank
        # slice identity is the stable bootstrap value, like the rank.  An
        # explicit slice_id (int or None) is authoritative: a Peer that
        # fell back to flat passes None.  The default (standalone
        # reporters) reads the launcher's MEGASCALE_* env directly;
        # malformed values mean no slice.
        if slice_id is _SLICE_FROM_ENV:
            sid = (os.environ.get("MEGASCALE_SLICE_ID", "") or "").strip()
            num = (os.environ.get("MEGASCALE_NUM_SLICES", "") or "").strip()
            slice_id = None
            if sid and num:
                try:
                    slice_id = int(sid) if int(num) > 1 else None
                except ValueError:
                    slice_id = None
        self.slice_id = slice_id
        self.period = max(MIN_PUSH_PERIOD_S,
                          push_period_from_env() if period is None else period)
        self._push_url = server_base(server_url) + "/push"
        self._strategy_fn = strategy_fn
        self._net_totals_fn = net_totals_fn
        self._events_fn = events_fn
        # refresh hook run before each snapshot build: gauges whose
        # source is a query, not an instrumented code path (device
        # memory stats, ...) get one cheap poll per push
        self._pre_snapshot_fn = pre_snapshot_fn
        self._cursor = 0           # timeline.events_tail cursor
        self._hist_prev: Dict[str, tuple] = {}
        # a failed push must not eat its window: the cursor and delta
        # baselines advance at COLLECTION time, so the undelivered
        # events/deltas are carried here and merged into the next
        # snapshot — otherwise a config-server blip during the very
        # incident being diagnosed would hole the online skew window and
        # break the online==offline agreement.  Bounded like the
        # aggregator's own windows (a long outage keeps the newest).
        self._pending_events: List[dict] = []
        self._pending_latency: Dict[str, dict] = {}
        self._max_pending = 4096
        self._last_step: Optional[int] = None
        self._last_step_wall = 0.0
        self._step_ema: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes pushes: stop()'s final push can otherwise run while
        # the loop thread is still blocked inside a slow HTTP POST (the
        # join below times out) — two threads advancing the cursor and
        # pending buffers concurrently would duplicate or drop events
        self._push_lock = threading.Lock()

    # -- snapshot assembly ----------------------------------------------
    def _collect_events(self) -> List[dict]:
        if self._events_fn is not None:
            return list(self._events_fn())
        from kungfu_tpu_torch.monitor import timeline

        self._cursor, events = timeline.events_tail(
            self._cursor, kinds=REPORT_KINDS)
        return events

    def _split_registry(self):
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        latency: Dict[str, dict] = {}
        for key, val in REGISTRY.snapshot().items():
            if isinstance(val, dict):  # histogram summary
                prev_count, prev_sum = self._hist_prev.get(key, (0, 0.0))
                self._hist_prev[key] = (val["count"], val["sum"])
                if val["count"] > prev_count:
                    latency[key] = {
                        "count": val["count"] - prev_count,
                        "sum": val["sum"] - prev_sum,
                    }
            elif isinstance(val, bool):
                continue
            elif isinstance(val, int):
                counters[key] = val
            else:
                gauges[key] = float(val)
        return counters, gauges, latency

    def _step_time(self, step: int, now: float) -> Optional[float]:
        if step is None or step < 0:
            return self._step_ema
        if self._last_step is None or step < self._last_step:
            # first sight — or the step went BACKWARD (shrink replay from
            # the leader-agreed boundary): rebase the rate baseline so
            # the first post-replay advance cannot smear the whole
            # stall+replay wall time over a few steps as one bogus sample
            self._last_step, self._last_step_wall = step, now
            return self._step_ema
        if step > self._last_step:
            x = (now - self._last_step_wall) / (step - self._last_step)
            self._step_ema = (
                x if self._step_ema is None
                else (1 - _STEP_EMA_ALPHA) * self._step_ema
                + _STEP_EMA_ALPHA * x
            )
            self._last_step, self._last_step_wall = step, now
        return self._step_ema

    def snapshot_once(self) -> dict:
        """Build (but do not send) one snapshot — also the test surface."""
        from kungfu_tpu_torch.monitor import timeline

        if self._pre_snapshot_fn is not None:
            # guarded like the other user callbacks: a raising gauge
            # poll must not cost this window its events/deltas
            try:
                self._pre_snapshot_fn()
            except Exception as e:  # noqa: BLE001 - monitoring must not raise
                _log.debug("pre-snapshot hook failed: %s", e)
        now = time.time()
        step = timeline.current_step()
        counters, gauges, latency = self._split_registry()
        _owned_gauges(self.rank, gauges)
        net = {"egress_bytes": 0, "ingress_bytes": 0}
        if self._net_totals_fn is not None:
            try:
                net.update(self._net_totals_fn())
            except Exception as e:  # noqa: BLE001 - monitoring must not raise
                _log.debug("net totals unavailable: %s", e)
        else:
            net["egress_bytes"] = int(gauges.get("kf_net_egress_bytes", 0))
            net["ingress_bytes"] = int(gauges.get("kf_net_ingress_bytes", 0))
        for key, delta in self._pending_latency.items():
            cur = latency.get(key)
            if cur is None:
                latency[key] = delta
            else:
                latency[key] = {"count": cur["count"] + delta["count"],
                                "sum": cur["sum"] + delta["sum"]}
        events = self._pending_events + self._collect_events()
        strategy = ""
        if self._strategy_fn is not None:
            # guarded like net_totals_fn: a raising user callback after
            # the cursor/delta baselines advanced would otherwise drop
            # this window's events on the push_once build-failure path
            try:
                strategy = self._strategy_fn()
            except Exception as e:  # noqa: BLE001 - monitoring must not raise
                _log.debug("strategy_fn unavailable: %s", e)
        return make_snapshot(
            rank=self.rank,
            slice=self.slice_id,
            pid=os.getpid(),
            wall=now,
            step=step,
            step_time_s=self._step_time(step, now),
            counters=counters,
            gauges=gauges,
            latency=latency,
            events=events[-self._max_pending:],
            net=net,
            strategy=strategy,
        )

    # -- lifecycle -------------------------------------------------------
    def push_once(self) -> bool:
        with self._push_lock:
            try:
                snap = self.snapshot_once()
            except Exception as e:  # noqa: BLE001 - monitoring must not raise
                _log.warning("snapshot build failed: %s", e)
                return False
            try:
                _post_json(self._push_url, snap,
                           timeout=max(1.0, min(self.period, 5.0)))
                self._pending_events = []
                self._pending_latency = {}
                return True
            except (OSError, http.client.HTTPException) as e:
                # the snapshot already merged any earlier pending window,
                # so carrying IT forward carries everything undelivered
                self._pending_events = (snap.get("events")
                                        or [])[-self._max_pending:]
                self._pending_latency = dict(snap.get("latency") or {})
                _log.debug("snapshot push failed: %s", e)
                return False

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            self.push_once()

    def start(self) -> "RankReporter":
        self._thread = threading.Thread(
            target=self._loop, name=f"kfmon-r{self.rank}", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_push: bool = False) -> None:
        """Stop the loop; ``final_push`` sends one last snapshot so a
        clean shutdown leaves fresh numbers rather than a stale flag."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.period + 1.0)
            self._thread = None
        if final_push:
            self.push_once()


def post_control_if_enabled(peer, kind: str, **attrs) -> bool:
    """The elastic layer's one-line control post: applies the shared
    gate (plane enabled + config server known) and stamps the peer's
    stable chaos-rank identity.  Callers keep only their own leader
    check — which rank announces differs per protocol.  Imports lazily,
    so that this module stays stdlib only at import."""
    from kungfu_tpu_torch.utils import envs

    if not envs.parse_bool_env(envs.ENABLE_CLUSTER_MONITOR):
        return False
    if not peer.config.config_server:
        return False
    return post_control(peer.config.config_server, kind,
                        rank=peer.chaos_rank(), **attrs)


def publish_stat(name: str, value: float) -> None:
    """Publish a training statistic (GNS, gradient variance, ...) into
    the unified registry so the next snapshot carries it to ``kftop``:
    ``publish_stat("gns", v)`` → gauge ``kf_stat_gns``."""
    REGISTRY.gauge(f"kf_stat_{name}").set(float(value))
