"""Cross-rank straggler math: per-collective skew, the slowest rank per
step, latency spikes that overlap faults, and the straggler verdict.

Copy of ``kungfu_tpu/monitor/skew.py``.  Every function takes the
timeline's event dicts (``{ts, rank, step, kind, name, dur, attrs}``)
and compares durations of the same rendezvous tag across ranks, never
timestamps across hosts.  Every selection is deterministic under ties
(equal durations pick the lowest rank; equal skews order by
``(op, tag)``), so the order in which events arrive cannot change a
verdict.  The bandit drivers (:mod:`kungfu_tpu_torch.monitor.
adapt_device`) read it for their straggler vote.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: event kinds that count as faults for the overlap analysis
FAULT_KINDS = ("chaos", "deadline", "down", "retry")

#: event kinds whose spans are collective work (host + device planes)
COLLECTIVE_KINDS = ("collective", "device")

#: how far above the per-collective median a duration must sit to be
#: called a spike in the fault-overlap section
SPIKE_FACTOR = 3.0

#: how far BEFORE a spiking span's start a fault still counts as
#: overlapping: a peer that dies an instant before the survivors enter
#: the collective is the cause of their stall, not a coincidence
FAULT_SLACK_S = 1.0


def collective_groups(events: List[dict]) -> Dict[Tuple[str, str], Dict[int, float]]:
    """``{(op, tag): {rank: duration}}`` over collective/device spans;
    a rank reporting the same tag more than once keeps its max (chunked
    collectives re-enter per chunk — the slowest chunk IS the stall)."""
    groups: Dict[Tuple[str, str], Dict[int, float]] = defaultdict(dict)
    for e in events:
        if e["kind"] not in COLLECTIVE_KINDS or e["dur"] <= 0:
            continue
        attrs = e["attrs"]
        op = attrs.get("op") or e["name"]
        tag = attrs.get("tag") or e["name"]
        cur = groups[(op, tag)].get(e["rank"])
        if cur is None or e["dur"] > cur:
            groups[(op, tag)][e["rank"]] = e["dur"]
    return groups


def skew_rows(events: List[dict]) -> List[dict]:
    """Per-collective cross-rank skew, widest first.  Only tags seen on
    ≥2 ranks qualify (a single-rank duration has no skew to measure)."""
    rows = []
    for (op, tag), per_rank in collective_groups(events).items():
        if len(per_rank) < 2:
            continue
        # iterate ranks sorted so duration ties resolve to the LOWEST
        # rank on both sides, independent of event arrival order
        ranks = sorted(per_rank)
        slowest = max(ranks, key=per_rank.get)
        fastest = min(ranks, key=per_rank.get)
        rows.append({
            "op": op, "tag": tag,
            "slowest_rank": slowest, "slowest_s": per_rank[slowest],
            "fastest_rank": fastest, "fastest_s": per_rank[fastest],
            "skew_s": per_rank[slowest] - per_rank[fastest],
            "ranks": len(per_rank),
        })
    rows.sort(key=lambda r: (-r["skew_s"], r["op"], r["tag"]))
    return rows


def slowest_rank_per_step(events: List[dict]) -> List[dict]:
    """Per step window: the rank with the largest total collective time."""
    by_step: Dict[int, Dict[int, float]] = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e["kind"] in COLLECTIVE_KINDS and e["dur"] > 0:
            by_step[e["step"]][e["rank"]] += e["dur"]
    out = []
    for step in sorted(by_step):
        per_rank = by_step[step]
        slowest = max(sorted(per_rank), key=per_rank.get)  # tie → lowest rank
        out.append({"step": step, "slowest_rank": slowest,
                    "total_s": per_rank[slowest],
                    "ranks": len(per_rank)})
    return out


def fault_overlaps(events: List[dict]) -> List[dict]:
    """Latency spikes (span > SPIKE_FACTOR x its group median, groups of
    ≥2) paired with the fault events that fall inside their window —
    any rank's fault counts: an injected delay on rank 1 stalls rank 0's
    recv just as surely as its own send."""
    faults = [e for e in events if e["kind"] in FAULT_KINDS]
    # the spike baseline is the median over ALL spans of an op (every
    # tag, every rank): a per-tag median would be the stall itself when
    # the majority of ranks block on one dead peer
    by_op: Dict[str, List[dict]] = defaultdict(list)
    for e in events:
        if e["kind"] in COLLECTIVE_KINDS and e["dur"] > 0:
            by_op[e["attrs"].get("op") or e["name"]].append(e)
    out = []
    for op, spans in by_op.items():
        if len(spans) < 2:
            continue
        med = statistics.median(s["dur"] for s in spans)
        if med <= 0:
            continue
        for s in spans:
            if s["dur"] < SPIKE_FACTOR * med:
                continue
            lo, hi = s["ts"] - FAULT_SLACK_S, s["ts"] + s["dur"]
            inside = [
                f for f in faults
                if lo <= f["ts"] <= hi
            ]
            if inside:
                out.append({
                    "op": op,
                    "tag": s["attrs"].get("tag") or s["name"],
                    "rank": s["rank"],
                    "step": s["step"], "dur_s": s["dur"],
                    "x_median": s["dur"] / med,
                    "faults": [
                        {"kind": f["kind"], "name": f["name"],
                         "rank": f["rank"], "attrs": f["attrs"]}
                        for f in inside
                    ],
                })
    out.sort(key=lambda r: r["dur_s"], reverse=True)
    return out


def straggler_verdict(events: List[dict]) -> Optional[int]:
    """The rank most often slowest across the skew groups, or None when
    no group spans ≥2 ranks."""
    votes: Dict[int, int] = defaultdict(int)
    for row in skew_rows(events):
        votes[row["slowest_rank"]] += 1
    if not votes:
        return None
    return max(sorted(votes), key=votes.get)  # vote tie → lowest rank
