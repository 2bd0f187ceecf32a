"""``kfhist``: offline reader for the kf-sentinel durable history (port
of ``kungfu_tpu/monitor/kfhist.py``, stdlib only).

``--verdict`` replays the durable ``cluster`` stream through the same
:mod:`~kungfu_tpu_torch.monitor.detect` math the online
:class:`~kungfu_tpu_torch.monitor.sentinel.Sentinel` runs, with the same
env-default knobs, so the offline verdict equals the live alert's.
``--upto N`` selects the record prefix an incident bundle was judged over
(its ``history_n``).  ``--decisions`` recomputes each kf-ledger effect
offline (:func:`~kungfu_tpu_torch.monitor.ledger.replay_effects`) and
checks it against the online record byte for byte.  The streams are the
reference's, so this reads a directory either package wrote.

Modes::

    python -m kungfu_tpu_torch.monitor.kfhist --dir RUNDIR --list
    python -m kungfu_tpu_torch.monitor.kfhist --dir RUNDIR
    python -m kungfu_tpu_torch.monitor.kfhist --dir RUNDIR --series step_time_s
    python -m kungfu_tpu_torch.monitor.kfhist --dir RUNDIR --verdict [--upto N]
    python -m kungfu_tpu_torch.monitor.kfhist --dir RUNDIR --decisions
    python -m kungfu_tpu_torch.monitor.kfhist --json ...
    python -m kungfu_tpu_torch.monitor.kfhist --self-check
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

from kungfu_tpu_torch.monitor import detect, history
from kungfu_tpu_torch.monitor import ledger as ledgerlib
from kungfu_tpu_torch.monitor import sentinel as sentinellib
from kungfu_tpu_torch.utils import envs


def _summary(series: Dict[str, List[float]]) -> Dict[str, dict]:
    out = {}
    for name in sorted(series):
        xs = series[name]
        out[name] = {
            "n": len(xs),
            "min": round(min(xs), 9),
            "median": round(detect.median(xs), 9),
            "max": round(max(xs), 9),
            "latest": round(xs[-1], 9),
        }
    return out


def verdict_from_dir(root: str, stream: str = sentinellib.CLUSTER_STREAM,
                     upto: Optional[int] = None,
                     window: Optional[int] = None,
                     threshold: Optional[float] = None) -> dict:
    """The offline detector replay: durable records -> series ->
    :func:`~kungfu_tpu_torch.monitor.detect.window_verdicts`.  Defaults come
    from the SAME env knobs the online sentinel reads, so with no flags
    this is exactly what the live plane computed."""
    knobs = envs.sentinel_knobs()
    if window is None:
        window = knobs["window"]
    if threshold is None:
        threshold = knobs["threshold"]
    records, skipped = history.scan_stream(root, stream)
    if upto is not None and upto >= 0:
        records = records[:upto]
    series = history.series_from_records(records)
    return {
        "kfhist": 1,
        "stream": stream,
        "records": len(records),
        "skipped": skipped,
        "window": window,
        "threshold": threshold,
        "verdicts": detect.window_verdicts(series, window=window,
                                           threshold=threshold),
    }


def _print_verdict(out: dict) -> None:
    print(f"kfhist: {out['records']} record(s), {out['skipped']} skipped, "
          f"window {out['window']}, threshold {out['threshold']}")
    verdicts = out["verdicts"]
    if not verdicts:
        print("  (not enough samples for any verdict — need two windows)")
        return
    for name, v in verdicts.items():
        mark = (f"SHIFTED {v['direction']}" if v["shifted"] else "flat")
        print(f"  {name}: {mark} — baseline {v['base_median']} "
              f"recent {v['recent_median']} score {v['score']} "
              f"(threshold {v['threshold']})")


def decisions_from_dir(root: str) -> dict:
    """The offline kf-ledger replay, with a ``match`` flag per decision:
    ``True`` iff the recomputed effect record equals the stream's online
    one byte for byte (``json.dumps(..., sort_keys=True)``)."""
    out = ledgerlib.replay_effects(root)
    for row in out["decisions"]:
        online, replayed = row["online"], row["replayed"]
        if online is None and replayed is None:
            row["match"] = None          # still pending on both sides
        else:
            row["match"] = (
                json.dumps(online, sort_keys=True)
                == json.dumps(replayed, sort_keys=True))
    return out


def _print_decisions(out: dict) -> None:
    rows = out["decisions"]
    print(f"kfhist: {out['records']} ledger record(s), "
          f"{out['skipped']} skipped, {len(rows)} decision(s)")
    if not rows:
        print("  (no decisions recorded — actors write via "
              "kungfu_tpu_torch.monitor.ledger.record_decision)")
        return
    lf = ledgerlib.lfield
    for row in rows:
        d = row["decision"]
        head = (f"  #{lf(d, 'seq')} {lf(d, 'actor')}/{lf(d, 'knob')}: "
                f"{lf(d, 'old')!r} -> {lf(d, 'new')!r}"
                f" (step {lf(d, 'step')}, consensus "
                f"{lf(d, 'consensus_seq')})")
        print(head)
        e = row["replayed"]
        if e is None:
            if row["match"] is None:
                print("    effect: pending (after window not filled)")
            else:
                print("    effect: replay produced none but the stream "
                      "has an online record — replay MISMATCH")
            continue
        if lf(e, "verdict") == "insufficient":
            print(f"    effect: insufficient baseline "
                  f"({lf(e, 'series')})")
        else:
            print(f"    effect: {lf(e, 'verdict').upper()} — "
                  f"{lf(e, 'series')} {lf(e, 'before_median')} -> "
                  f"{lf(e, 'after_median')} "
                  f"(shift {lf(e, 'shift')}, score {lf(e, 'score')}, "
                  f"threshold {lf(e, 'threshold')})")
        mark = {True: "replay MATCH", False: "replay MISMATCH",
                None: "replay n/a"}[row["match"]]
        print(f"    {mark}")


# -- self-check --------------------------------------------------------------
def self_check() -> int:
    """Ring + reader + detector round trip in a temp dir: segmentation
    and GC behave, a torn line is skipped not fatal, a planted shift is
    detected and a clean series is not."""
    import os

    ok = True
    with tempfile.TemporaryDirectory(prefix="kfhist-selfcheck-") as d:
        ring = history.HistoryRing(d, "cluster", keep_bytes=1 << 20,
                                   segment_records=8)
        # 24 clean + 8 shifted step-time samples: the last window is the
        # planted regression, the baseline is clean
        for i in range(32):
            st = 0.1 if i < 24 else 0.25
            ring.append({"kfhist": 1, "wall": 1000.0 + i,
                         "series": {"step_time_s": st, "mfu": 0.4}})
        segs = history._segments(d, "cluster")
        # 32 appends at 8/segment = 4 sealed segments (the next open
        # segment has no file until its first append)
        ok = ok and len(segs) == 4
        # a torn trailing line in a sealed segment is skipped, not fatal
        with open(segs[0][1], "ab") as f:
            f.write(b'{"torn": ')
        records, skipped = history.scan_stream(d, "cluster")
        ok = ok and len(records) == 32 and skipped == 1
        out = verdict_from_dir(d)
        v = out["verdicts"].get("step_time_s")
        ok = (ok and v is not None and v["shifted"]
              and v["direction"] == "up")
        # the untouched series must stay flat — no false positive
        m = out["verdicts"].get("mfu")
        ok = ok and m is not None and not m["shifted"]
        # --upto replays a prefix: before the shift landed, no verdict
        # may call step_time_s shifted
        pre = verdict_from_dir(d, upto=24)
        pv = pre["verdicts"].get("step_time_s")
        ok = ok and (pv is None or not pv["shifted"])
        # GC: a tiny budget drops sealed segments but never the open one
        # (14 appends at 4/segment: 3 sealed + an open segment of 2)
        ring2 = history.HistoryRing(d, "gc", keep_bytes=256,
                                    segment_records=4)
        for i in range(14):
            ring2.append({"kfhist": 1, "wall": float(i),
                          "series": {"x": float(i)}})
        remaining = [s for s, _ in history._segments(d, "gc")]
        ok = ok and remaining and remaining[-1] == ring2._seq
        sealed_size = sum(os.path.getsize(p)
                          for seq, p in history._segments(d, "gc")
                          if seq != ring2._seq)
        ok = ok and sealed_size <= 256
        # kf-ledger round trip (own subdir — the cluster stream above
        # would shift the sample positions): a decision judged online
        # over the live feed must replay byte-identically offline
        ld = os.path.join(d, "ledger")
        lg = ledgerlib.DecisionLedger(ld, window=4, threshold=4.0)
        cluster_ring = history.HistoryRing(ld, "cluster",
                                           keep_bytes=1 << 20)
        for i, st in enumerate([0.2] * 6 + [0.1] * 4):
            if i == 6:
                lg.decide("selfcheck", "knob", "a", "b", wall=0.0,
                          trace_id="t0", step=i)
            rec = {"kfhist": 1, "wall": 2000.0 + i,
                   "series": {"step_time_s": st}}
            cluster_ring.append(rec)
            lg.on_sample(rec)
        rep = decisions_from_dir(ld)
        ok = (ok and len(rep["decisions"]) == 1
              and rep["decisions"][0]["match"] is True
              and ledgerlib.lfield(rep["decisions"][0]["replayed"],
                                   "verdict") == "improved")
    if not ok:
        print("kfhist: self-check FAILED (ring/detector round-trip "
              "mismatch)", file=sys.stderr)
        return 1
    print("kfhist: self-check ok (ring + detector round-trip)")
    return 0


# -- CLI ---------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" in argv:
        return self_check()
    p = argparse.ArgumentParser(
        prog="kfhist",
        description="offline reader for the kf-sentinel durable metrics "
                    "history (KF_SENTINEL_DIR rings)",
    )
    p.add_argument("--dir", required=True,
                   help="history root (the run's KF_SENTINEL_DIR)")
    p.add_argument("--stream", default=sentinellib.CLUSTER_STREAM,
                   help="stream name (default: cluster; rank-N for ranks)")
    p.add_argument("--list", action="store_true",
                   help="list streams with record counts")
    p.add_argument("--series", default=None,
                   help="print one series' samples")
    p.add_argument("--last", type=int, default=None,
                   help="only the newest N records")
    p.add_argument("--upto", type=int, default=None,
                   help="only the first N records (an incident's "
                        "history_n — replays exactly what it was "
                        "judged over)")
    p.add_argument("--verdict", action="store_true",
                   help="replay the online detector over the stream")
    p.add_argument("--decisions", action="store_true",
                   help="replay the kf-ledger decision effects offline "
                        "and check them against the online records")
    p.add_argument("--window", type=int, default=None,
                   help="changepoint window (default: KF_SENTINEL_WINDOW)")
    p.add_argument("--threshold", type=float, default=None,
                   help="shift threshold (default: KF_SENTINEL_THRESHOLD)")
    p.add_argument("--json", action="store_true",
                   help="machine output")
    args = p.parse_args(argv)

    if args.list:
        out = {}
        for stream in history.streams(args.dir):
            records, skipped = history.scan_stream(args.dir, stream)
            out[stream] = {"records": len(records), "skipped": skipped}
        if args.json:
            json.dump(out, sys.stdout, indent=2, sort_keys=True)
            sys.stdout.write("\n")
        else:
            if not out:
                print(f"kfhist: no streams under {args.dir}")
            for stream, info in sorted(out.items()):
                print(f"  {stream}: {info['records']} record(s)"
                      + (f", {info['skipped']} skipped"
                         if info["skipped"] else ""))
        return 0

    if args.verdict:
        out = verdict_from_dir(args.dir, stream=args.stream,
                               upto=args.upto, window=args.window,
                               threshold=args.threshold)
        if args.json:
            json.dump(out, sys.stdout, indent=2, sort_keys=True)
            sys.stdout.write("\n")
        else:
            _print_verdict(out)
        return 0

    if args.decisions:
        out = decisions_from_dir(args.dir)
        if args.json:
            json.dump(out, sys.stdout, indent=2, sort_keys=True)
            sys.stdout.write("\n")
        else:
            _print_decisions(out)
        return 1 if any(row["match"] is False
                        for row in out["decisions"]) else 0

    records, skipped = history.scan_stream(args.dir, args.stream)
    if args.upto is not None and args.upto >= 0:
        records = records[:args.upto]
    if args.last is not None and args.last >= 0:
        records = records[-args.last:]
    series = history.series_from_records(records)
    if args.series:
        xs = series.get(args.series, [])
        if args.json:
            json.dump({"series": args.series, "samples": xs}, sys.stdout)
            sys.stdout.write("\n")
        else:
            print(f"kfhist: {args.series}: {len(xs)} sample(s)")
            for v in xs:
                print(f"  {v}")
        return 0
    out = {
        "kfhist": 1,
        "stream": args.stream,
        "records": len(records),
        "skipped": skipped,
        "series": _summary(series),
    }
    if args.json:
        json.dump(out, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(f"kfhist: stream {args.stream}: {len(records)} record(s)"
              + (f", {skipped} skipped" if skipped else ""))
        for name, s in out["series"].items():
            print(f"  {name}: n={s['n']} min={s['min']} "
                  f"median={s['median']} max={s['max']} "
                  f"latest={s['latest']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
