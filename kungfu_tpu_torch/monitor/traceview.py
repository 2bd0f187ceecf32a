"""``kftrace``: merge per-rank flight-recorder dumps, find stragglers
(port of ``kungfu_tpu/monitor/traceview.py``, stdlib only).

Reads the JSONL dumps :mod:`kungfu_tpu_torch.monitor.timeline` writes
(one a rank or process; the reference's format, so dumps of either
package load here) and gives:

* ``merge -o trace.json DUMPS...``: one Chrome-trace JSON, each rank a
  track, spans complete events and marks instants;
* ``report DUMPS...``: the straggler report over
  :mod:`~kungfu_tpu_torch.monitor.skew` (the math the live aggregator
  uses): per-collective cross-rank skew, the slowest rank per step, and
  the fault events that overlap latency spikes;
* ``--critical-path DUMPS...``: the kf-xray report
  (:mod:`~kungfu_tpu_torch.monitor.xray`): per-step attribution, the
  culprit rank and edge, the longest dependency chain;
* ``--self-check [DUMPS...]``: dump schema validation (with no dumps, a
  synthetic round trip through the live timeline module).

Run as ``python -m kungfu_tpu_torch.monitor.traceview``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

# the straggler math lives in monitor/skew.py, shared with the live
# cluster aggregator; the re-exports keep the reference's surface
from kungfu_tpu_torch.monitor.skew import (  # noqa: F401  (re-exported API)
    FAULT_KINDS,
    FAULT_SLACK_S,
    SPIKE_FACTOR,
    fault_overlaps,
    skew_rows,
    slowest_rank_per_step,
    straggler_verdict,
)

#: required keys of one event line (see timeline.snapshot())
EVENT_KEYS = ("ts", "rank", "step", "kind", "name", "dur", "attrs")


class DumpError(ValueError):
    """A dump file failed schema validation."""


def _check_event(obj: dict, lineno: int, kinds: Optional[frozenset]) -> None:
    missing = [k for k in EVENT_KEYS if k not in obj]
    if missing:
        raise DumpError(f"line {lineno}: missing key(s) {missing}")
    if not isinstance(obj["kind"], str) or not isinstance(obj["name"], str):
        raise DumpError(f"line {lineno}: kind/name must be strings")
    if kinds is not None and obj["kind"] not in kinds:
        raise DumpError(
            f"line {lineno}: unknown event kind {obj['kind']!r}")
    for k in ("ts", "dur"):
        if not isinstance(obj[k], (int, float)):
            raise DumpError(f"line {lineno}: {k} must be a number")
    if obj["rank"] is not None and not isinstance(obj["rank"], int):
        raise DumpError(f"line {lineno}: rank must be int or null")
    if not isinstance(obj["attrs"], dict):
        raise DumpError(f"line {lineno}: attrs must be an object")


def load_dump(path: str,
              kinds: Optional[frozenset] = None
              ) -> Tuple[Optional[dict], List[dict]]:
    """``(header, events)`` from one JSONL dump, schema-validated.
    ``kinds`` (default: the live vocabulary when importable) restricts
    event kinds; pass ``None``-able explicitly to skip that check."""
    if kinds is None:
        try:
            from kungfu_tpu_torch.monitor.timeline import EVENT_KINDS

            kinds = EVENT_KINDS
        except ImportError:
            kinds = None
    header: Optional[dict] = None
    events: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise DumpError(f"line {lineno}: not JSON ({e})") from None
            if lineno == 1 and "kftrace" in obj:
                header = obj
                continue
            _check_event(obj, lineno, kinds)
            events.append(obj)
    return header, events


def _event_rank(ev: dict, header: Optional[dict]) -> int:
    r = ev.get("rank")
    if r is None and header is not None:
        r = header.get("rank")
    return -1 if r is None else int(r)


def load_all(paths: Sequence[str]) -> List[dict]:
    """All events from all dumps, rank-resolved (header rank filled in
    where the event carries none), time-sorted."""
    out: List[dict] = []
    for p in paths:
        header, events = load_dump(p)
        for ev in events:
            ev = dict(ev)
            ev["rank"] = _event_rank(ev, header)
            out.append(ev)
    out.sort(key=lambda e: e["ts"])
    return out


# -- Chrome trace ----------------------------------------------------------
def chrome_trace(events: List[dict]) -> dict:
    """Chrome-trace JSON object: one process track per rank, spans as
    complete events, marks as instants, all timestamps rebased to the
    earliest event (µs)."""
    if events:
        t0 = min(e["ts"] for e in events)
    else:
        t0 = 0.0
    ranks = sorted({e["rank"] for e in events})
    trace_events: List[dict] = []
    for r in ranks:
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": r, "tid": 0,
            "args": {"name": f"rank {r}" if r >= 0 else "rankless"},
        })
    for e in events:
        base = {
            "name": e["name"],
            "cat": e["kind"],
            "pid": e["rank"],
            "tid": 0,
            "ts": (e["ts"] - t0) * 1e6,
            "args": dict(e["attrs"], step=e["step"]),
        }
        if e["dur"] > 0:
            base["ph"] = "X"
            base["dur"] = e["dur"] * 1e6
        else:
            base["ph"] = "i"
            base["s"] = "p"
        trace_events.append(base)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


# -- straggler report (analysis itself: monitor/skew.py) -------------------
def render_report(events: List[dict], top: int = 10) -> str:
    lines: List[str] = []
    rows = skew_rows(events)
    verdict = straggler_verdict(events)
    n_faults = sum(1 for e in events if e["kind"] in FAULT_KINDS)
    lines.append(f"kftrace: {len(events)} event(s), "
                 f"{len(rows)} cross-rank collective group(s), "
                 f"{n_faults} fault event(s)")
    if verdict is not None:
        lines.append(f"straggler verdict: rank {verdict} "
                     f"(slowest in {sum(1 for r in rows if r['slowest_rank'] == verdict)}"
                     f"/{len(rows)} groups)")
    lines.append("")
    lines.append("== per-collective cross-rank skew (widest first)")
    if not rows:
        lines.append("  (no collective seen on more than one rank)")
    for r in rows[:top]:
        lines.append(
            f"  {r['op']}/{r['tag']}: skew {r['skew_s'] * 1e3:.1f}ms — "
            f"rank {r['slowest_rank']} {r['slowest_s'] * 1e3:.1f}ms vs "
            f"rank {r['fastest_rank']} {r['fastest_s'] * 1e3:.1f}ms "
            f"({r['ranks']} ranks)"
        )
    lines.append("")
    lines.append("== slowest rank per step window")
    steps = slowest_rank_per_step(events)
    if not steps:
        lines.append("  (no stepped collective spans)")
    for s in steps[:top]:
        lines.append(
            f"  step {s['step']}: rank {s['slowest_rank']} "
            f"({s['total_s'] * 1e3:.1f}ms total collective time, "
            f"{s['ranks']} ranks)"
        )
    lines.append("")
    lines.append("== fault overlap with latency spikes "
                 f"(> {SPIKE_FACTOR:g}x group median)")
    overlaps = fault_overlaps(events)
    if not overlaps:
        lines.append("  (none)")
    for o in overlaps[:top]:
        faults = ", ".join(
            f"{f['kind']}:{f['name']}@rank{f['rank']}" for f in o["faults"]
        )
        lines.append(
            f"  {o['op']}/{o['tag']} rank {o['rank']} step {o['step']}: "
            f"{o['dur_s'] * 1e3:.1f}ms ({o['x_median']:.1f}x median) "
            f"overlaps [{faults}]"
        )
    return "\n".join(lines) + "\n"


# -- self-check ------------------------------------------------------------
def self_check(paths: Sequence[str]) -> int:
    """Validate dump schemas; with no paths, synthesize a dump via the
    live timeline module and round-trip it (proves recorder and reader
    agree byte-for-byte on the schema)."""
    if not paths:
        import os
        import tempfile

        from kungfu_tpu_torch.monitor import timeline

        timeline.reset(cap=64)
        with timeline.span("collective", "engine.all_reduce[64B]",
                           rank=0, force=True, op="all_reduce",
                           tag="selfcheck", nbytes=64):
            pass
        timeline.event("chaos", "delay", rank=0, force=True, ms=1)
        timeline.event("mark", "selfcheck", rank=0, force=True)
        # serving-plane kinds must round-trip too —
        # with the explicit trace context a served request carries, so
        # the recorder/reader agreement covers the causal triple
        with timeline.trace_ctx("srv.selfcheck", "s0.router"):
            with timeline.span("serve", "prefill", rank=0, force=True,
                               tokens=4, reused=0):
                pass
            timeline.event("request", "accept", rank=0, force=True,
                           rid="selfcheck")
        with timeline.span("input", "prefetch.next", rank=0, force=True):
            pass
        fd, tmp = tempfile.mkstemp(suffix=".jsonl", prefix="kftrace-")
        os.close(fd)
        try:
            timeline.dump(tmp)
            header, events = load_dump(tmp)
        finally:
            os.unlink(tmp)
            timeline.reset()
        srv = [e for e in events if e["kind"] in ("serve", "request")]
        ok = (header is not None and len(events) == 6
              and len(srv) == 2
              and all(e["attrs"].get("trace") == "srv.selfcheck"
                      for e in srv))
        if not ok:
            print("kftrace: self-check FAILED (round-trip mismatch)",
                  file=sys.stderr)
            return 1
        print("kftrace: self-check ok (synthetic round-trip incl. "
              "serve/request kinds + trace context)")
        return 0
    rc = 0
    for p in paths:
        try:
            header, events = load_dump(p)
        except (OSError, DumpError) as e:
            print(f"kftrace: {p}: INVALID — {e}", file=sys.stderr)
            rc = 1
            continue
        dropped = (header or {}).get("dropped", 0)
        print(f"kftrace: {p}: ok ({len(events)} event(s), "
              f"{dropped} dropped)")
    return rc


# -- CLI -------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" in argv:
        argv.remove("--self-check")
        return self_check(argv)
    if "--critical-path" in argv:
        # the kf-xray offline report: same implementation as the live
        # /cluster xray section (monitor/xray.py), fed from merged dumps
        from kungfu_tpu_torch.monitor import xray as xraylib

        argv.remove("--critical-path")
        if not argv:
            print("kftrace: --critical-path needs at least one dump",
                  file=sys.stderr)
            return 2
        try:
            events = load_all(argv)
        except (OSError, DumpError) as e:
            print(f"kftrace: {e}", file=sys.stderr)
            return 1
        sys.stdout.write(xraylib.render_report(events))
        return 0
    p = argparse.ArgumentParser(
        prog="kftrace",
        description="merge kungfu-tpu flight-recorder dumps; find stragglers",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("merge", help="merge dumps into a Chrome-trace JSON")
    pm.add_argument("-o", "--out", required=True, help="output trace.json")
    pm.add_argument("dumps", nargs="+", help="per-rank JSONL dumps")
    pr = sub.add_parser("report", help="print the straggler report")
    pr.add_argument("--top", type=int, default=10,
                    help="rows per section (default 10)")
    pr.add_argument("dumps", nargs="+", help="per-rank JSONL dumps")
    args = p.parse_args(argv)
    try:
        events = load_all(args.dumps)
    except (OSError, DumpError) as e:
        print(f"kftrace: {e}", file=sys.stderr)
        return 1
    if args.cmd == "merge":
        trace = chrome_trace(events)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        ranks = sorted({e['rank'] for e in events})
        print(f"kftrace: wrote {len(trace['traceEvents'])} trace event(s) "
              f"from {len(args.dumps)} dump(s) (ranks {ranks}) to {args.out}")
        return 0
    sys.stdout.write(render_report(events, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
