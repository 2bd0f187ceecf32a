"""kf-xray: step-time attribution and the critical path (port of
``kungfu_tpu/monitor/xray.py``, stdlib only).

It answers where a step's wall clock went and which rank or edge put it
there, over flight-recorder events, reusing
:mod:`~kungfu_tpu_torch.monitor.skew` for every cross-rank comparison.
The cluster aggregator's ``/cluster`` ``xray`` section is
:func:`online_view` over the event windows ranks push
(:mod:`~kungfu_tpu_torch.monitor.aggregator`); the offline report
(:func:`render_report`) reads the same events from a dump.

Attribution taxonomy (:data:`PHASES`, per step, of the critical rank's
wall): ``compute`` (wall covered by no recorded span), ``comm_exposed``
(synchronous collective spans less the straggler excess),
``comm_hidden`` (time covered only by async collective spans),
``input_stall`` (``input`` spans), ``pp_bubble`` (pipeline ``bubble``
spans, which own their wall time) and ``straggler_wait`` (the
cross-rank skew excess, clamped into the critical rank's comm time; the
culprit edge is the widest skew group).  Every selection inherits the
tie-breaks of :mod:`~kungfu_tpu_torch.monitor.skew`, and all analysis is
restricted to :data:`XRAY_KINDS`.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from kungfu_tpu_torch.monitor import skew as skewlib

#: the attribution taxonomy, in render order.  ``pp_bubble`` is the
#: pipeline-parallel fill/drain wait (kf-pipeline "bubble" spans): time
#: a stage spent blocked on a cross-DCN activation/gradient dependency
#: — distinct from comm_exposed (the wire itself) because a prefetched
#: hop's wire can be fully hidden while the stage STILL idles waiting
#: for work (the schedule's bubble, not the network's).  Bubble time is
#: EXCLUSIVE: comm intervals inside a bubble span are charged to the
#: bubble (the wait), not double-counted as exposed wire — the phases
#: keep tiling the step wall
PHASES = ("compute", "comm_exposed", "comm_hidden", "input_stall",
          "pp_bubble", "straggler_wait")

#: event kinds the attribution consumes.  Restricting BOTH consumers to
#: this set is what makes "offline == online" assertable: a dump also
#: carries send/recv/chaos marks the live plane never forwards, and wall
#: windows computed over different kind sets would disagree.
XRAY_KINDS = frozenset(skewlib.COLLECTIVE_KINDS) | frozenset(
    {"input", "overlap", "pp"})

#: online attribution window (steps); utils/envs.py registers the token
WINDOW_ENV = "KF_XRAY_WINDOW_STEPS"
DEFAULT_WINDOW_STEPS = 32


def window_steps_from_env() -> int:
    try:
        v = int(os.environ.get(WINDOW_ENV, "") or DEFAULT_WINDOW_STEPS)
    except ValueError:
        v = DEFAULT_WINDOW_STEPS
    return max(1, v)


# -- interval math ----------------------------------------------------------
def _union_len(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals —
    concurrent spans (async pool threads) must count wall time once."""
    if not intervals:
        return 0.0
    total = 0.0
    lo = hi = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if hi is None or s > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = s, e
        elif e > hi:
            hi = e
    if hi is not None:
        total += hi - lo
    return total


def _xray_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("kind") in XRAY_KINDS]


def _async_tags(events: List[dict]) -> set:
    """Tags issued through the kf-overlap async window (their collective
    spans ran on the pool, concurrently with the issuer)."""
    return {
        (e.get("attrs") or {}).get("tag")
        for e in events
        if e.get("kind") == "overlap" and e.get("name") == "issue"
    } - {None}


def rank_phase_split(events: List[dict],
                     async_tags: Optional[set] = None) -> Dict[str, float]:
    """Single-rank wall decomposition over one window of events (all
    :data:`XRAY_KINDS`; cross-rank ``straggler_wait`` is 0 here — that
    phase only exists against other ranks).  ``wall_s`` spans the first
    event start to the last event end."""
    events = _xray_events(events)
    if async_tags is None:
        async_tags = _async_tags(events)
    spans = [e for e in events if e.get("dur", 0) > 0]
    marks = [e for e in events if not e.get("dur", 0)]
    if not spans and not marks:
        return {"wall_s": 0.0, **{p: 0.0 for p in PHASES}}
    t_lo = min(e["ts"] for e in spans + marks)
    t_hi = max(e["ts"] + e.get("dur", 0.0) for e in spans + marks)
    wall = max(0.0, t_hi - t_lo)
    sync_comm, async_comm, inputs, bubbles = [], [], [], []
    for e in spans:
        iv = (e["ts"], e["ts"] + e["dur"])
        if e["kind"] in skewlib.COLLECTIVE_KINDS:
            tag = (e.get("attrs") or {}).get("tag") or e["name"]
            (async_comm if tag in async_tags else sync_comm).append(iv)
        elif e["kind"] == "input":
            inputs.append(iv)
        elif e["kind"] == "pp" and e.get("name") == "bubble":
            # the dependency wait itself; pp "fwd"/"bwd" spans are
            # stage COMPUTE and deliberately fall through (subtracting
            # them would hollow the compute phase out)
            bubbles.append(iv)
    # bubble owns its wall time: a blocking pipeline recv records BOTH
    # a bubble span (the owner-thread wait) and a sync collective span
    # (the wire) over the same interval — counting that interval in
    # comm_exposed too would make the phases sum past the wall.  The
    # comm phases therefore measure comm time OUTSIDE bubbles; with no
    # bubble spans in the window every value below is byte-identical to
    # the pre-pp math.
    pp_bubble = _union_len(bubbles)
    comm_exposed = max(0.0, _union_len(sync_comm + bubbles) - pp_bubble)
    comm_hidden = max(0.0, _union_len(sync_comm + async_comm + bubbles)
                      - _union_len(sync_comm + bubbles))
    input_stall = _union_len(inputs)
    spanned = _union_len(sync_comm + async_comm + inputs + bubbles)
    compute = max(0.0, wall - spanned)
    return {
        "wall_s": wall,
        "compute": compute,
        "comm_exposed": comm_exposed,
        "comm_hidden": comm_hidden,
        "input_stall": input_stall,
        "pp_bubble": pp_bubble,
        "straggler_wait": 0.0,
    }


# -- per-step cluster attribution ------------------------------------------
def _by_step(events: List[dict]) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = defaultdict(list)
    for e in _xray_events(events):
        step = e.get("step")
        if isinstance(step, int):
            out[step].append(e)
    return out


def _culprit(rows: List[dict]) -> Optional[dict]:
    """The widest skew row, reduced to the edge fields — the dependency
    edge ``slowest_rank → fastest_rank`` of collective ``op/tag`` is
    where the straggler excess enters the critical path."""
    if not rows:
        return None
    r = rows[0]
    return {k: r[k] for k in ("op", "tag", "slowest_rank", "slowest_s",
                              "fastest_rank", "fastest_s", "skew_s")}


def step_attribution(events: List[dict]) -> List[dict]:
    """Per-step cluster attribution rows, step-ordered.  Each row
    decomposes the step wall of the *critical rank* (largest per-rank
    wall window; duration ties → lowest rank, the skew.py contract) into
    :data:`PHASES`, and names the culprit edge from the step's widest
    cross-rank skew group."""
    rows: List[dict] = []
    async_tags = _async_tags(events)
    stepped = _by_step(events)
    for step in sorted(stepped):
        evs = stepped[step]
        by_rank: Dict[int, List[dict]] = defaultdict(list)
        for e in evs:
            r = e.get("rank")
            if isinstance(r, int):
                by_rank[r].append(e)
        if not by_rank:
            continue
        splits = {r: rank_phase_split(res, async_tags)
                  for r, res in by_rank.items()}
        crit = max(sorted(splits), key=lambda r: splits[r]["wall_s"])
        phases = dict(splits[crit])
        wall = phases.pop("wall_s")
        skew_rows = skewlib.skew_rows(evs)
        # the straggler excess cannot exceed the critical rank's comm
        # time — it is the skew PORTION of those very spans
        excess = min(sum(r["skew_s"] for r in skew_rows),
                     phases["comm_exposed"])
        phases["comm_exposed"] -= excess
        phases["straggler_wait"] = excess
        rows.append({
            "step": step,
            "wall_s": wall,
            "critical_rank": crit,
            "ranks": len(by_rank),
            "phases": phases,
            "culprit": _culprit(skew_rows),
        })
    return rows


def verdict(events: List[dict], rows: Optional[List[dict]] = None) -> dict:
    """THE shared offline/online verdict: straggler rank (skew.py's
    vote), culprit edge (widest skew group over the whole window),
    dominant phase, and the phase totals.  ``kftrace --critical-path``
    prints exactly this object; the aggregator serves exactly this
    object under ``/cluster → xray → verdict`` — asserted identical in
    the chaos tests.  ``rows`` passes precomputed
    :func:`step_attribution` output for the same events (the live
    ``/cluster`` path computes it once per scrape, not twice)."""
    events = _xray_events(events)
    if rows is None:
        rows = step_attribution(events)
    totals = {p: sum(r["phases"][p] for r in rows) for p in PHASES}
    dominant = max(PHASES, key=lambda p: totals[p]) if rows else None
    crit_votes: Dict[int, int] = defaultdict(int)
    for r in rows:
        crit_votes[r["critical_rank"]] += 1
    # ONE whole-window skew pass: the culprit edge is the widest row and
    # the straggler vote is derived from the same rows (identical math
    # to skewlib.straggler_verdict, which would re-group internally)
    sk = skewlib.skew_rows(events)
    votes: Dict[int, int] = defaultdict(int)
    for row in sk:
        votes[row["slowest_rank"]] += 1
    return {
        "straggler": (max(sorted(votes), key=votes.get)
                      if votes else None),
        "culprit": _culprit(sk),
        "dominant": dominant,
        "phases": totals,
        "steps_seen": len(rows),
        "critical_rank": (max(sorted(crit_votes), key=crit_votes.get)
                          if crit_votes else None),
    }


# -- critical path ----------------------------------------------------------
def critical_path(events: List[dict],
                  step: Optional[int] = None) -> List[dict]:
    """The longest dependency chain through one step's causal graph.

    Nodes are collective groups (same ``(op, tag)`` — and, when stamped,
    the same derived ``trace`` id — on every rank); each group is a
    barrier that completes with its slowest participant.  The chain
    walks groups in completion order; between barriers it follows the
    NEXT group's slowest rank, whose gap (compute/input on that rank) is
    what the step actually waited on.  Returns hops::

        {"kind": "collective", "rank", "op", "tag", "trace",
         "dur_s", "skew_s"}          # the barrier, at its slowest rank
        {"kind": "gap", "rank", "dur_s"}   # inter-barrier time on the
                                           # rank owning the next hop
    """
    evs = _xray_events(events)
    if step is not None:
        evs = [e for e in evs if e.get("step") == step]
    groups: Dict[Tuple[str, str], Dict[int, dict]] = defaultdict(dict)
    for e in evs:
        if e["kind"] not in skewlib.COLLECTIVE_KINDS or e.get("dur", 0) <= 0:
            continue
        attrs = e.get("attrs") or {}
        op = attrs.get("op") or e["name"]
        tag = attrs.get("tag") or e["name"]
        r = e.get("rank")
        cur = groups[(op, tag)].get(r)
        if cur is None or e["dur"] > cur["dur"]:
            groups[(op, tag)][r] = e
    if not groups:
        return []
    nodes = []
    for (op, tag), per_rank in groups.items():
        ranks = sorted(per_rank)
        slowest = max(ranks, key=lambda r: per_rank[r]["dur"])
        fastest = min(ranks, key=lambda r: per_rank[r]["dur"])
        ev = per_rank[slowest]
        nodes.append({
            "op": op, "tag": tag, "rank": slowest,
            "trace": (ev.get("attrs") or {}).get("trace"),
            "ts": ev["ts"], "end": ev["ts"] + ev["dur"],
            "dur_s": ev["dur"],
            "skew_s": per_rank[slowest]["dur"] - per_rank[fastest]["dur"],
        })
    nodes.sort(key=lambda n: (n["end"], n["op"], n["tag"]))
    hops: List[dict] = []
    prev_end = None
    for n in nodes:
        if prev_end is not None and n["ts"] > prev_end:
            hops.append({"kind": "gap", "rank": n["rank"],
                         "dur_s": n["ts"] - prev_end})
        hops.append({"kind": "collective", "rank": n["rank"], "op": n["op"],
                     "tag": n["tag"], "trace": n["trace"],
                     "dur_s": n["dur_s"], "skew_s": n["skew_s"]})
        prev_end = max(prev_end, n["end"]) if prev_end is not None else n["end"]
    return hops


# -- online view (aggregator glue) -----------------------------------------
def online_view(events: List[dict],
                window_steps: Optional[int] = None) -> Optional[dict]:
    """The ``/cluster`` ``xray`` section body: the verdict plus the last
    ``window_steps`` attribution rows.  ``None`` when the window holds
    nothing attributable — a job without collective spans renders no
    XRAY section rather than a table of zeros."""
    window = window_steps if window_steps is not None else window_steps_from_env()
    rows = step_attribution(events)
    if not rows:
        return None
    rows = rows[-window:]
    keep = {r["step"] for r in rows}
    win_events = [e for e in _xray_events(events) if e.get("step") in keep]
    # the sliced rows ARE step_attribution(win_events) (per-step rows
    # depend only on their own step's events; async tags come from the
    # full window on both the offline and online paths) — pass them so
    # a /cluster scrape attributes once, not twice
    return {"verdict": verdict(win_events, rows=rows), "steps": rows}


# -- rendering (kftrace --critical-path) -----------------------------------
def _fmt_ms(v: float) -> str:
    return f"{v * 1e3:.1f}ms"


def render_report(events: List[dict], top: int = 10) -> str:
    """The offline ``kftrace --critical-path`` text: verdict, per-step
    attribution, and the longest chain of the widest step."""
    evs = _xray_events(events)
    v = verdict(evs)
    rows = step_attribution(evs)
    lines = [f"kf-xray: {len(evs)} attributable event(s), "
             f"{v['steps_seen']} step(s)"]
    if v["straggler"] is not None:
        lines.append(f"straggler verdict: rank {v['straggler']}")
    c = v["culprit"]
    if c is not None:
        lines.append(
            f"culprit edge: {c['op']}/{c['tag']} "
            f"rank {c['slowest_rank']} ({_fmt_ms(c['slowest_s'])}) -> "
            f"rank {c['fastest_rank']} ({_fmt_ms(c['fastest_s'])}), "
            f"skew {_fmt_ms(c['skew_s'])}")
    if v["dominant"] is not None:
        total = sum(v["phases"].values()) or 1.0
        lines.append(
            f"dominant phase: {v['dominant']} "
            f"({v['phases'][v['dominant']] / total:.0%} of attributed time)")
    lines.append("")
    lines.append("== per-step attribution "
                 "(compute / comm_exposed / comm_hidden / input_stall / "
                 "straggler_wait)")
    if not rows:
        lines.append("  (no stepped collective spans)")
    for r in rows[-top:]:
        ph = r["phases"]
        cu = r["culprit"]
        lines.append(
            f"  step {r['step']}: wall {_fmt_ms(r['wall_s'])} = "
            + " + ".join(f"{p}:{_fmt_ms(ph[p])}" for p in PHASES)
            + f" | critical rank {r['critical_rank']}"
            + (f" | culprit {cu['op']}/{cu['tag']}@rank{cu['slowest_rank']}"
               if cu else ""))
    lines.append("")
    widest = None
    for r in rows:
        if r["culprit"] and (widest is None
                             or r["culprit"]["skew_s"]
                             > widest["culprit"]["skew_s"]):
            widest = r
    if widest is not None:
        step = widest["step"]
        lines.append(f"== critical path (step {step}, longest chain)")
        for hop in critical_path(evs, step)[:top * 2]:
            if hop["kind"] == "gap":
                lines.append(f"  rank {hop['rank']}: "
                             f"[compute/input {_fmt_ms(hop['dur_s'])}]")
            else:
                lines.append(
                    f"  rank {hop['rank']}: {hop['op']}/{hop['tag']} "
                    f"{_fmt_ms(hop['dur_s'])}"
                    + (f" (skew {_fmt_ms(hop['skew_s'])})"
                       if hop["skew_s"] > 0 else ""))
    return "\n".join(lines) + "\n"
