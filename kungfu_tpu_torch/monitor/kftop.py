"""``kftop``: terminal view of the cluster observability plane (port of
``kungfu_tpu/monitor/kftop.py``, stdlib only).

Fetches the config server's ``/cluster`` JSON (the view the
:class:`~kungfu_tpu_torch.monitor.aggregator.ClusterAggregator` keeps
from the ranks' pushed snapshots) and renders it: per-rank freshness,
step, step time and fault counters, slices, the serving rollup, the
kf-pulse gauges, the decision ledger, the sentinel's alerts and the
kf-xray attribution.  :func:`render_view` gives the reference's text for
the same view.

Modes::

    python -m kungfu_tpu_torch.monitor.kftop                  # live, every 2 s
    python -m kungfu_tpu_torch.monitor.kftop --server http://h:9100
    python -m kungfu_tpu_torch.monitor.kftop --once           # one frame
    python -m kungfu_tpu_torch.monitor.kftop --json           # raw /cluster
    python -m kungfu_tpu_torch.monitor.kftop --self-check     # canned payload
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import List, Optional, Sequence

from kungfu_tpu_torch.monitor.aggregator import (
    ClusterAggregator,
    VIEW_FIELDS,
    control_event,
    field,
    make_snapshot,
    server_base,
    sum_metric,
)

DEFAULT_SERVER = "http://127.0.0.1:9100"


def fetch_view(server: str, timeout: float = 5.0) -> dict:
    url = server_base(server) + "/cluster"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


# -- rendering -------------------------------------------------------------
def _fmt_s(v: Optional[float], unit: str = "s") -> str:
    if v is None:
        return "-"
    if unit == "ms":
        return f"{v * 1e3:.1f}ms"
    return f"{v:.1f}s"


def _fmt_bytes(n) -> str:
    try:
        n = int(n)
    except (TypeError, ValueError):
        return "-"
    for suffix, scale in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= scale:
            return f"{n / scale:.1f}{suffix}"
    return f"{n}B"


def _counter(row: dict, name: str) -> int:
    """Sum of a pushed counter over its label variants (the shared
    aggregator ``sum_metric`` match — one implementation)."""
    return int(sum_metric(field(row, "counters"), name))


def _window_latency_s(row: dict) -> Optional[float]:
    """Mean collective latency over the rank's last push window, from
    the histogram count/sum deltas the snapshot carries."""
    lat = field(row, "latency") or {}
    count = sum(d.get("count", 0) for d in lat.values())
    total = sum(d.get("sum", 0.0) for d in lat.values())
    return (total / count) if count else None


def _gauge(row: dict, name: str) -> float:
    """Sum of a pushed gauge over its label variants (like _counter)."""
    return sum_metric(field(row, "gauges"), name)


def _serving_lines(view: dict) -> List[str]:
    """The serving section (kf-serve deployments): the cluster rollup
    the aggregator computes plus per-rank serve columns from the same
    gauges/counters every snapshot carries (docs/serving.md)."""
    srv = field(view, "serving")
    if not srv:
        return []
    ttft = field(srv, "ttft_ms")
    e2e = field(srv, "e2e_ms")
    lines = [
        "",
        "== serving (continuous batching; docs/serving.md)",
        f"  active {field(srv, 'active')} | queued {field(srv, 'queued')} | "
        f"kv-cache {_fmt_bytes(field(srv, 'kv_bytes'))} | "
        f"completed {field(srv, 'completed')} | "
        f"rejected {field(srv, 'rejected')} | "
        f"replayed {field(srv, 'replayed')} | "
        f"window ttft {_fmt_s(ttft / 1e3, 'ms') if ttft is not None else '-'}"
        f" e2e {_fmt_s(e2e / 1e3, 'ms') if e2e is not None else '-'}",
        f"  {'rank':>4} {'active':>7} {'kv-cache':>9} {'done':>6} "
        f"{'replay':>7} {'reuse-tok':>10}",
    ]
    done_key = 'kf_serve_requests_total{what="complete"}'
    replay_key = 'kf_serve_requests_total{what="replay"}'
    reuse_key = 'kf_serve_prefill_tokens_total{what="reused"}'
    for row in field(view, "ranks") or []:
        if not (_gauge(row, "kf_serve_active_requests")
                or _gauge(row, "kf_kv_cache_bytes")
                or _counter(row, "kf_serve_requests_total")
                or _counter(row, "kf_serve_prefill_tokens_total")):
            continue
        counters = field(row, "counters") or {}
        lines.append(
            f"  {field(row, 'rank'):>4} "
            f"{int(_gauge(row, 'kf_serve_active_requests')):>7} "
            f"{_fmt_bytes(int(_gauge(row, 'kf_kv_cache_bytes'))):>9} "
            f"{counters.get(done_key, 0):>6} "
            f"{counters.get(replay_key, 0):>7} "
            f"{counters.get(reuse_key, 0):>10}")
    return lines


def _device_mem(row: dict):
    """A rank's ``(in_use, limit)`` device-memory bytes from the labeled
    gauge pair (direct key reads — ``sum_metric`` would add the two
    variants together, which is exactly wrong here)."""
    gauges = field(row, "gauges") or {}
    return (gauges.get('kf_device_memory_bytes{kind="in_use"}', 0.0),
            gauges.get('kf_device_memory_bytes{kind="limit"}', 0.0))


def _pulse_lines(view: dict) -> List[str]:
    """The PULSE section (kf-pulse gradient-signal monitoring; present
    only when some rank exports the pulse gauges — docs/pulse.md):
    cluster GNS/variance means plus per-rank and per-group gradient
    norms from the same pushed gauges."""
    pl = field(view, "pulse")
    if not pl:
        return []
    gns = field(pl, "gns")
    gvar = field(pl, "grad_variance")
    lines = ["", "== PULSE (gradient noise scale / variance; "
                 "docs/pulse.md)"]
    head = (f"  gns {gns:.4g}" if gns is not None else "  gns -")
    head += (f" | grad-var {gvar:.4g}" if gvar is not None
             else " | grad-var -")
    groups = field(pl, "groups") or {}
    if groups:
        head += " | " + " ".join(
            f"|g|[{g}] {v:.4g}" for g, v in sorted(groups.items()))
    lines.append(head)
    per_rank = []
    for row in field(view, "ranks") or []:
        gauges = field(row, "gauges") or {}
        v = gauges.get("kf_gns")
        if v is not None:
            per_rank.append(f"r{field(row, 'rank')}:{float(v):.4g}")
    if per_rank:
        lines.append("  per-rank gns: " + " ".join(per_rank))
    return lines


def _decision_lines(view: dict) -> List[str]:
    """The DECISIONS tail of the ALERTS section (kf-ledger): how many
    adaptive-actor decisions the run has made, how they measured out,
    and the newest effect verdict (docs/pulse.md)."""
    al = field(view, "alerts")
    if not al:
        return []
    dec = field(al, "decisions")
    if not dec or not dec.get("total"):
        return []
    by_verdict = dec.get("by_verdict") or {}
    line = (f"  decisions: {dec.get('total')} made, "
            f"{dec.get('judged')} judged, {dec.get('pending')} pending")
    if by_verdict:
        line += " (" + " ".join(
            f"{k}:{v}" for k, v in sorted(by_verdict.items())) + ")"
    lines = [line]
    last = dec.get("last")
    if last:
        lines.append(
            f"  last effect: {last.get('actor')}/{last.get('knob')} "
            f"-> {last.get('verdict')} "
            f"({last.get('series')} {last.get('before_median')} -> "
            f"{last.get('after_median')}, score {last.get('score')})")
    return lines


def _alert_lines(view: dict) -> List[str]:
    """The ALERTS section (kf-sentinel; present only when a Sentinel is
    attached to the aggregator — docs/sentinel.md)."""
    al = field(view, "alerts")
    if not al:
        return []
    active = field(al, "active") or []
    fired = field(al, "alerts") or []
    lines = ["", "== ALERTS (kf-sentinel online detectors; "
                 "docs/sentinel.md)"]
    if active:
        lines.append("  !! ACTIVE: " + " | ".join(active))
    else:
        lines.append("  (no rule firing)")
    for a in fired[-5:]:
        inc = field(a, "incident")
        lines.append(
            f"  fired: {field(a, 'rule')}"
            + (f" -> {inc}" if inc else ""))
    return lines


def _fmt_flops(v) -> str:
    if not v:
        return "-"
    for suffix, scale in (("PFLOP/s", 1e15), ("TFLOP/s", 1e12),
                          ("GFLOP/s", 1e9), ("MFLOP/s", 1e6)):
        if v >= scale:
            return f"{v / scale:.2f}{suffix}"
    return f"{v:.0f}FLOP/s"


def _xray_lines(view: dict) -> List[str]:
    """The XRAY section: continuous step-time decomposition + MFU /
    model-FLOPs rate + the causal verdict (culprit rank and edge) the
    aggregator computes with the SAME monitor/xray.py implementation as
    the offline ``kftrace --critical-path`` report (docs/xray.md)."""
    xr = field(view, "xray")
    if not xr:
        return []
    lines = ["", "== XRAY (step-time decomposition; same math as "
                 "`kftrace --critical-path`)"]
    phases = field(xr, "phase_seconds")
    v = field(xr, "verdict")
    label = "phases/step"
    if not phases and v:
        # no rank exports the per-step gauges (no MFUMeter in the loop):
        # fall back to the verdict's WINDOW TOTALS, divided back to a
        # per-step mean — rendering a 32-step total under a per-step
        # label would read as a 32x-inflated step
        steps_seen = max(1, field(v, "steps_seen") or 1)
        totals = field(v, "phases") or {}
        phases = {ph: sec / steps_seen for ph, sec in totals.items()}
        label = "phases/step (window mean)"
    if phases:
        lines.append(f"  {label}: " + " | ".join(
            f"{ph} {_fmt_s(sec, 'ms')}" for ph, sec in sorted(
                phases.items(), key=lambda kv: -kv[1])))
    mfu = field(xr, "mfu")
    flops = field(xr, "model_flops_s")
    if mfu or flops:
        mfu_txt = ("-" if not mfu else " ".join(
            f"r{r}:{m:.3f}" for r, m in sorted(mfu.items())))
        lines.append(f"  mfu {mfu_txt} | model rate {_fmt_flops(flops)}")
    if v:
        verdict_bits = []
        if field(v, "straggler") is not None:
            verdict_bits.append(f"straggler rank {field(v, 'straggler')}")
        if field(v, "dominant") is not None:
            verdict_bits.append(f"dominant {field(v, 'dominant')}")
        c = field(v, "culprit")
        if c:
            verdict_bits.append(
                f"culprit {field(c, 'op')}/{field(c, 'tag')} "
                f"rank {field(c, 'slowest_rank')} -> "
                f"rank {field(c, 'fastest_rank')} "
                f"(skew {_fmt_s(field(c, 'skew_s'), 'ms')})")
        if verdict_bits:
            lines.append("  verdict: " + " | ".join(verdict_bits))
        lines.append(f"  window: {field(v, 'steps_seen')} step(s)")
    return lines


def render_view(view: dict, top: int = 10) -> str:
    lines: List[str] = []
    wall = field(view, "wall")
    clock = time.strftime("%H:%M:%S", time.localtime(wall)) if wall else "?"
    rows = field(view, "ranks") or []
    stale = field(view, "stale") or []
    straggler = field(view, "straggler")
    cluster = field(view, "cluster") or {}
    head = (f"kfmon @ {clock} — {len(rows)} rank(s), {len(stale)} stale "
            f"(threshold {_fmt_s(field(view, 'stale_after_s'))})")
    version = field(cluster, "version")
    if version is not None:
        head += (f" | cluster v{version} n={field(cluster, 'size')}"
                 f" quorum-margin {field(cluster, 'quorum_margin')}")
    if straggler is not None:
        head += f" | straggler: rank {straggler}"
    lines.append(head)
    slices = field(view, "slices") or []
    if slices:
        # a WHOLE-stale slice is the slice-loss signature (DCN/power),
        # not a straggling rank — render it as its own alarm line
        stale_slices = field(view, "stale_slices") or []
        parts = []
        for g in slices:
            n_ranks = len(field(g, "ranks") or [])
            n_stale = len(field(g, "stale") or [])
            mark = ("LOST" if field(g, "all_stale")
                    else f"{n_stale}/{n_ranks} stale" if n_stale else "ok")
            parts.append(f"slice {field(g, 'slice')}: {mark}")
        lines.append("slices: " + " | ".join(parts))
        if stale_slices:
            lines.append(
                f"!! SLICE LOSS: slice(s) {stale_slices} fully stale — "
                "expect slice-shrink (docs/multislice.md)")
    last = field(cluster, "last_control")
    if last:
        age = (wall or time.time()) - (field(last, "wall") or 0)
        lines.append(
            f"last control: {field(last, 'kind')} "
            f"({_fmt_s(age)} ago, rank {field(last, 'rank')}) "
            f"{field(last, 'attrs') or ''}")
    lines.append("")
    show_slice = any(field(r, "slice") is not None for r in rows)
    show_mem = any(_device_mem(r)[0] for r in rows)
    hdr = (f"{'rank':>4} " + (f"{'slice':>5} " if show_slice else "")
           + f"{'state':<6} {'age':>7} {'step':>7} "
           f"{'step-time':>10} {'coll-lat':>9} {'retries':>8} "
           f"{'faults':>7} {'chaos':>6} "
           + (f"{'dev-mem':>15} " if show_mem else "")
           + f"{'egress':>9} {'ingress':>9}  strategy")
    lines.append(hdr)
    for row in rows:
        state = "STALE" if field(row, "stale") else "ok"
        net = field(row, "net") or {}
        faults = (_counter(row, "kf_peer_faults_total")
                  + _counter(row, "kf_detector_down_total"))
        lat = _window_latency_s(row)
        sl = field(row, "slice")
        mem_txt = ""
        if show_mem:
            in_use, limit = _device_mem(row)
            cell = (f"{_fmt_bytes(int(in_use))}/{_fmt_bytes(int(limit))}"
                    if in_use else "-")
            mem_txt = f"{cell:>15} "
        lines.append(
            f"{field(row, 'rank'):>4} "
            + (f"{sl if sl is not None else '-':>5} " if show_slice else "")
            + f"{state:<6} "
            f"{_fmt_s(field(row, 'age_s')):>7} "
            f"{field(row, 'step') if field(row, 'step') is not None else '-':>7} "
            f"{_fmt_s(field(row, 'step_time_s')):>10} "
            f"{_fmt_s(lat, 'ms') if lat is not None else '-':>9} "
            f"{_counter(row, 'kf_engine_retries_total'):>8} "
            f"{faults:>7} "
            f"{_counter(row, 'kf_chaos_injections_total'):>6} "
            + mem_txt
            + f"{_fmt_bytes(net.get('egress_bytes')):>9} "
            f"{_fmt_bytes(net.get('ingress_bytes')):>9}  "
            f"{field(row, 'strategy') or '-'}")
    if not rows:
        lines.append("  (no snapshots yet — workers push once per "
                     "KF_CONFIG_MONITOR_PUSH_PERIOD)")
    lines.append("")
    lines.append("== cross-rank skew (widest first; online, same math as "
                 "`kftrace report`)")
    skew = field(view, "skew") or []
    for r in skew[:top]:
        lines.append(
            f"  {field(r, 'op')}/{field(r, 'tag')}: "
            f"skew {_fmt_s(field(r, 'skew_s'), 'ms')} — "
            f"rank {field(r, 'slowest_rank')} "
            f"{_fmt_s(field(r, 'slowest_s'), 'ms')} vs "
            f"rank {field(r, 'fastest_rank')} "
            f"{_fmt_s(field(r, 'fastest_s'), 'ms')}")
    if not skew:
        lines.append("  (no cross-rank collective spans in the window — "
                     "is KF_CONFIG_ENABLE_TRACE on?)")
    lines.extend(_xray_lines(view))
    # a silently-lossy flight recorder must not look complete: the
    # aggregator's ONE per-rank drop rollup (xray.dropped_events, from
    # kf_timeline_dropped_total) becomes an explicit alarm line
    lossy = field(field(view, "xray") or {}, "dropped_events") or {}
    if lossy:
        lines.append("")
        lines.append(
            "!! TRACE LOSS: flight-recorder ring evicted events — "
            + ", ".join(f"rank {r}: {n}" for r, n in sorted(lossy.items()))
            + " (raise KF_CONFIG_TIMELINE_CAP; skew/xray windows are "
              "incomplete)")
    # kf-persist: a rank whose manifest age exceeds 3 persist periods
    # has a wedged/starved durable plane — a preemption now would lose
    # that much progress (docs/persistence.md)
    ckpt_stale = []
    for row in rows:
        period = _gauge(row, "kf_ckpt_period_seconds")
        age = _gauge(row, "kf_ckpt_age_seconds")
        if period > 0 and age > 3 * period:
            ckpt_stale.append(
                f"rank {field(row, 'rank')}: {_fmt_s(age)} "
                f"(period {_fmt_s(period)})")
    if ckpt_stale:
        lines.append("")
        lines.append(
            "!! CKPT STALE: manifest age > 3x persist period — "
            + ", ".join(ckpt_stale)
            + " (durable plane wedged? a preemption now replays all of "
              "that; docs/persistence.md)")
    lines.extend(_pulse_lines(view))
    lines.extend(_serving_lines(view))
    lines.extend(_alert_lines(view))
    lines.extend(_decision_lines(view))
    return "\n".join(lines) + "\n"


# -- self-check ------------------------------------------------------------
def self_check() -> int:
    """Schema round-trip on a canned payload: build snapshots through
    :func:`make_snapshot`, ingest them into a live aggregator, serialize
    the view through JSON, and re-render — proving the push wire format,
    the view schema, and the renderer agree."""
    import tempfile

    from kungfu_tpu_torch.monitor.sentinel import Sentinel

    clock = [1000.0]
    agg = ClusterAggregator(stale_after=1.0, time_fn=lambda: clock[0])
    # a sentinel with a step-time ceiling the canned 0.25 s step busts:
    # proves ingest -> sample -> alert -> /cluster alerts section ->
    # ALERTS rendering, end to end on the same canned payload
    tmp = tempfile.TemporaryDirectory(prefix="kftop-selfcheck-")
    agg.attach_sentinel(Sentinel(tmp.name, period_s=0.0,
                                 step_ceiling_s=0.1))

    def span(rank, dur, tag):
        return {"ts": 999.0, "rank": rank, "step": 3, "kind": "collective",
                "name": "engine.all_reduce", "dur": dur,
                "attrs": {"op": "all_reduce", "tag": tag}}

    for rank in range(3):
        dur = 0.10 if rank == 2 else 0.01
        counters = {"kf_engine_retries_total": rank}
        gauges = {"kf_stat_gns": 1.5,
                  # kf-pulse gauges on every rank (the collective
                  # estimate is identical across peers by construction)
                  "kf_gns": 1.5,
                  "kf_grad_variance": 0.25,
                  'kf_grad_norm{group="flat"}': 2.0}
        latency = {"kf_collective_latency_seconds": {"count": 2, "sum": dur}}
        if rank == 0:  # one rank exporting the kf-xray gauges
            gauges["kf_mfu"] = 0.41
            gauges["kf_model_flops_s"] = 1.2e12
            gauges['kf_step_phase_seconds{phase="compute"}'] = 0.2
            gauges['kf_step_phase_seconds{phase="comm_exposed"}'] = 0.05
        if rank == 2:  # one lossy ring proves the TRACE LOSS alarm
            counters["kf_timeline_dropped_total"] = 5
        if rank == 2:  # and a wedged persist plane proves CKPT STALE
            gauges["kf_ckpt_last_step"] = 1.0
            gauges["kf_ckpt_age_seconds"] = 95.0
            gauges["kf_ckpt_period_seconds"] = 30.0
            gauges["kf_ckpt_bytes_total"] = 2048.0
        if rank == 1:  # device-memory gauges prove the dev-mem column
            gauges['kf_device_memory_bytes{kind="in_use"}'] = float(2 << 30)
            gauges['kf_device_memory_bytes{kind="limit"}'] = float(8 << 30)
        if rank == 1:  # one serving rank proves the serving rollup
            counters['kf_serve_requests_total{what="complete"}'] = 7
            counters['kf_serve_requests_total{what="replay"}'] = 2
            counters['kf_serve_prefill_tokens_total{what="reused"}'] = 64
            gauges["kf_serve_active_requests"] = 3.0
            gauges["kf_kv_cache_bytes"] = float(1 << 20)
            latency["kf_serve_e2e_seconds"] = {"count": 4, "sum": 2.0}
        agg.ingest(make_snapshot(
            rank=rank, pid=100 + rank, wall=999.5, step=3,
            step_time_s=0.25,
            slice=rank // 2,  # 2-rank slice 0 + 1-rank slice 1
            counters=counters,
            gauges=gauges,
            latency=latency,
            events=[span(rank, dur, "grad3")],
            net={"egress_bytes": 1 << 20, "ingress_bytes": 1 << 20},
            strategy="RING",
        ))
    agg.ingest(control_event("shrink", rank=0, dead=[4], version=2))
    clock[0] += 2.0  # every rank now past the 1 s staleness threshold
    view = json.loads(json.dumps(agg.cluster_view(
        {"version": 2, "size": 3, "workers": ["h:1", "h:2", "h:3"]})))
    bad = set(view) - VIEW_FIELDS
    ok = (
        not bad
        and field(view, "straggler") == 2
        and [field(r, "rank") for r in field(view, "ranks")] == [0, 1, 2]
        and field(view, "stale") == [0, 1, 2]
        and field(view, "skew")
        and abs(field(field(view, "skew")[0], "skew_s") - 0.09) < 1e-9
        and field(field(view, "cluster"), "quorum_margin") == 1
        and field(field(field(view, "cluster"), "last_control"), "kind")
        == "shrink"
    )
    ok = ok and bool(field(field(view, "ranks")[0], "latency"))
    # slice grouping: every rank is stale, so both canned slices must be
    # flagged as whole-stale (the slice-loss signature)
    ok = (ok
          and [field(g, "slice") for g in field(view, "slices")] == [0, 1]
          and field(field(view, "slices")[0], "all_stale")
          and field(view, "stale_slices") == [0, 1])
    # serving rollup: the one serving rank's gauges/counters/deltas must
    # surface as the cluster serving summary (docs/serving.md)
    srv = field(view, "serving")
    ok = (ok and srv is not None
          and field(srv, "active") == 3
          and field(srv, "kv_bytes") == (1 << 20)
          and field(srv, "completed") == 7
          and field(srv, "replayed") == 2
          and abs(field(srv, "e2e_ms") - 500.0) < 1e-9)
    # kf-xray section: the canned spans must attribute, the verdict must
    # name the slow rank's edge (same monitor/xray.py math as the
    # offline report), and the pushed gauges must roll up
    xr = field(view, "xray")
    xv = field(xr, "verdict") if xr else None
    ok = (ok and xr is not None and xv is not None
          and field(xv, "straggler") == 2
          and field(field(xv, "culprit"), "slowest_rank") == 2
          and abs(field(field(xv, "culprit"), "skew_s") - 0.09) < 1e-9
          and field(xv, "steps_seen") == 1
          and field(xr, "mfu") == {"0": 0.41}
          and abs(field(xr, "model_flops_s") - 1.2e12) < 1.0
          and field(xr, "phase_seconds") == {"compute": 0.2,
                                             "comm_exposed": 0.05}
          and field(xr, "dropped_events") == {"2": 5})
    # kf-pulse: the per-rank gauges must roll up to the cluster means
    # and the per-group norm table
    pl = field(view, "pulse")
    ok = (ok and pl is not None
          and abs(field(pl, "gns") - 1.5) < 1e-9
          and abs(field(pl, "grad_variance") - 0.25) < 1e-9
          and field(pl, "groups") == {"flat": 2.0})
    # kf-sentinel: the busted step-time ceiling must be an active alert
    # in the view, and the fired alert must carry its incident path —
    # and the alerts section must carry the kf-ledger decision summary
    al = field(view, "alerts")
    ok = (ok and al is not None
          and "watermark:step_time" in (field(al, "active") or [])
          and (field(al, "alerts") or [])
          and field(field(al, "alerts")[0], "incident")
          and isinstance(field(al, "decisions"), dict))
    text = render_view(view)
    ok = (ok and "STALE" in text and "all_reduce/grad3" in text
          and "coll-lat" in text and "SLICE LOSS" in text
          and "== serving" in text and "replay" in text
          and "== XRAY" in text and "TRACE LOSS" in text
          and "rank 2: 5" in text and "CKPT STALE" in text
          and "== ALERTS" in text and "watermark:step_time" in text
          and "== PULSE" in text and "gns 1.5" in text
          and "dev-mem" in text and "2.0GiB/8.0GiB" in text)
    tmp.cleanup()
    if not ok:
        print("kftop: self-check FAILED (view schema/round-trip mismatch)",
              file=sys.stderr)
        return 1
    print("kftop: self-check ok (canned /cluster round-trip)")
    return 0


# -- CLI -------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" in argv:
        return self_check()
    p = argparse.ArgumentParser(
        prog="kftop",
        description="live kungfu-tpu cluster view (config server /cluster)",
    )
    p.add_argument("-s", "--server", default=DEFAULT_SERVER,
                   help=f"config server URL (default {DEFAULT_SERVER})")
    p.add_argument("-n", "--interval", type=float, default=2.0,
                   help="refresh period seconds (default 2)")
    p.add_argument("--top", type=int, default=10,
                   help="skew rows shown (default 10)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    p.add_argument("--json", action="store_true",
                   help="print the raw /cluster JSON once and exit")
    args = p.parse_args(argv)
    if args.json or args.once:
        try:
            view = fetch_view(args.server)
        except (OSError, ValueError) as e:
            print(f"kftop: {args.server}: {e}", file=sys.stderr)
            return 1
        if args.json:
            json.dump(view, sys.stdout, indent=2)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(render_view(view, top=args.top))
        return 0
    try:
        while True:
            try:
                frame = render_view(fetch_view(args.server), top=args.top)
            except (OSError, ValueError) as e:
                frame = f"kftop: {args.server}: {e} (retrying)\n"
            # clear + home, then the frame — a live refreshing view
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
