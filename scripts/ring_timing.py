#!/usr/bin/env python3
"""Time the ring reduce-scatter and all-gather kernels of a checkout of
the PyTorch/CUDA port on one GPU.

    python3 scripts/ring_timing.py [--root DIR] [--label NAME]

Imports ``kungfu_tpu_torch`` from ``DIR`` (default: the checkout holding
this script), so two checkouts, e.g. a ``git archive`` of a parent
commit unpacked into an ignored directory, can be timed in turns
(parent, change, change, parent) in one call on one card.  At the two
main-path shapes of four co-resident ranks, f32: one ZeRO bucket
(chunk 262,144, ``[4, 1,048,576]`` in) and the fused gradient of
``gpt_small(max_seq=2048)`` (chunk 33,601,152), it prints the device ms
per launch of ``reduce_scatter`` and ``all_gather``
(``kungfu_tpu_torch.ops.cuda.collectives``): the median over CUDA-event
windows of back-to-back launches (11 of 50 for the bucket, 7 of 5 for
the fused shape), warm L2, the stream held by a sleep kernel while the
host enqueues; the same for ``x.view(k, k, chunk).sum(0)`` and
``expand(k, -1).contiguous()``, the one PyTorch call of each function;
the host µs per launch of each wrapper (host clock over calls enqueued
behind a sleep kernel); whether each kernel's result is bitwise equal
to its plain version; and the card's name and power limit.  The last
line is one JSON object with all of it.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RANKS = 4
SHAPES = {"bucket": 262_144, "fused": 134_404_608 // RANKS}


def device_ms(torch, fn, iters: int, windows: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(torch, fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from kungfu_tpu_torch.ops import collectives as rc
    from kungfu_tpu_torch.ops.cuda import collectives as ringk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = RANKS
    rows = []
    for label, chunk in SHAPES.items():
        x = torch.randn((k, k * chunk), generator=gen, device="cuda")
        rs = ringk.reduce_scatter(x)
        ag = ringk.all_gather(rs)
        torch.cuda.synchronize()
        rs_ok = torch.equal(rs, rc.ring_reduce_scatter_reference(x))
        ag_ok = torch.equal(ag, rc.ring_all_gather_reference(rs))
        del ag
        big = label == "fused"
        it, win, calls = (5, 7, 20) if big else (50, 11, 200)
        row = {
            "shape": label, "k": k, "chunk": chunk,
            "rs_ms": device_ms(torch, lambda: ringk.reduce_scatter(x), it,
                               win),
            "ag_ms": device_ms(torch, lambda: ringk.all_gather(rs), it, win),
            "rs_library_ms": device_ms(
                torch, lambda: x.view(k, k, chunk).sum(0), it, win),
            "ag_library_ms": device_ms(
                torch, lambda: rs.reshape(1, -1).expand(k, -1).contiguous(),
                it, win),
            "rs_host_us": host_us(torch, lambda: ringk.reduce_scatter(x),
                                  calls),
            "ag_host_us": host_us(torch, lambda: ringk.all_gather(rs),
                                  calls),
            "rs_bitwise": rs_ok, "ag_bitwise": ag_ok}
        print(f"{args.label} {label} k={k} chunk={chunk} f32: reduce-scatter "
              f"{row['rs_ms']:.4f} ms ({row['rs_host_us']:.1f} us host; "
              f"view(k, k, chunk).sum(0) {row['rs_library_ms']:.4f}), "
              f"all-gather {row['ag_ms']:.4f} ms ({row['ag_host_us']:.1f} us "
              f"host; expand().contiguous() {row['ag_library_ms']:.4f}); "
              f"bitwise {rs_ok}, {ag_ok}")
        rows.append(row)
        del x, rs
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0), "smi": smi,
                      "rows": rows}))
    return 0 if all(r["rs_bitwise"] and r["ag_bitwise"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
