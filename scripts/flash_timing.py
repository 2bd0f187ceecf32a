#!/usr/bin/env python3
"""Time the bf16 flash-attention forward, dQ and dK/dV kernels of a
checkout of the PyTorch/CUDA port on one GPU.

    python3 scripts/flash_timing.py [--root DIR] [--label NAME]
        [--head-dim D] [--pad-to DP]

Imports ``kungfu_tpu_torch`` from ``DIR`` (default: the checkout holding
this script), so two checkouts, e.g. a ``git archive`` of a parent
commit unpacked into an ignored directory, can be timed in turns in one
call on one card.  For each main-path shape, ``[BH, S, D]`` bf16
causal: ``[48, 256, D]`` (the serving forward), ``[48, 2048, D]`` (the
one-rank training step) and ``[12, 2048, D]`` (one of four co-resident
ranks), D = 64 by default.  A D that is not a compiled width runs as the
wrapper runs it: zero-padded to ``DP`` (by default the checkout's
``attention.kernel_head_dim(D)``, or D where the checkout has none) with
the scale ``1/sqrt(D)`` of the unpadded width; ``--head-dim 80
--pad-to 96`` times Pythia-2.8B's heads, ``--head-dim 256``
Pythia-1B's.  It prints the device ms per launch of the forward kernel
(``attention._launch``), the dQ kernel (``attention._launch_bwd_dq``)
and the dK/dV kernel (``attention._launch_bwd_dkv``): the median over 11
CUDA-event windows
of 20 back-to-back launches, warm L2, the stream held by a sleep kernel
while the host enqueues.  It also prints the host µs per launch of each
wrapper (host clock over 200 calls enqueued behind a sleep kernel, so
the queue never blocks), and the card's name and power limit.  It also
counts, in each bf16 wgmma kernel of the checkout's built libraries
(``cuobjdump --dump-sass``), the instructions in all and the
convergence barriers (BSSY), branches (BRA), wgmma (HGMMA) and TMA
loads (UTMALDG) among them.  The last line is one JSON object with all
of it.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time

SHAPES = ((48, 256), (48, 2048), (12, 2048))


def device_ms(torch, fn, iters: int = 20, windows: int = 11) -> float:
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


def host_us(torch, fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def sass_counts(path, tool: str) -> dict:
    """{kernel name: opcode counts} of the wgmma kernels in a library."""
    out = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_bf16_wgmma_kernel)"
                             r"ILi(\d+)E", m.group(1))
            cur = f"{name.group(1)}<{name.group(2)}>" if name else None
            if cur:
                counts[cur] = collections.Counter()
        elif cur:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                          line)
            if m:
                counts[cur]["all"] += 1
                counts[cur][m.group(1)] += 1
    return {k: {op: c[op] for op in ("all", "BSSY", "BRA", "HGMMA", "UTMALDG")}
            for k, c in counts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--head-dim", type=int, default=64,
                    help="the head width D of every shape (default 64)")
    ap.add_argument("--pad-to", type=int, default=None,
                    help="the compiled width the kernels run D at (default: "
                    "the checkout's kernel_head_dim(D), else D)")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from kungfu_tpu_torch.ops.cuda import _build, attention

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = args.head_dim
    dp = args.pad_to or (attention.kernel_head_dim(d)[0]
                         if hasattr(attention, "kernel_head_dim") else d)
    # the unpadded width's scale, passed only to a padded launch (a
    # checkout from before the scale argument runs a compiled D as it is)
    kw = {"scale": 1.0 / d ** 0.5} if dp != d else {}
    rows = []
    for bh, s in SHAPES:
        q, k, v, do = (F.pad(torch.randn(
            (bh, s, d), generator=gen, device="cuda").to(torch.bfloat16),
            (0, dp - d)).contiguous() for _ in range(4))
        out, lse = attention._launch(q, k, v, True, **kw)
        delta = (do.float() * out.float()).sum(-1)

        def fwd():
            attention._launch(q, k, v, True, **kw)

        def dq():
            attention._launch_bwd_dq(q, k, v, do, lse, delta, True, **kw)

        def dkv():
            attention._launch_bwd_dkv(q, k, v, do, lse, delta, True, **kw)

        row = {"shape": [bh, s, d], "head_dim_run": dp,
               "fwd_ms": device_ms(torch, fwd),
               "dq_ms": device_ms(torch, dq),
               "dkv_ms": device_ms(torch, dkv),
               "fwd_host_us": host_us(torch, fwd),
               "dq_host_us": host_us(torch, dq),
               "dkv_host_us": host_us(torch, dkv)}
        print(f"{args.label} [{bh}, {s}, {d}->{dp}]: forward "
              f"{row['fwd_ms']:.4f} ms "
              f"({row['fwd_host_us']:.1f} us host), dQ {row['dq_ms']:.4f} ms "
              f"({row['dq_host_us']:.1f} us host), dK/dV "
              f"{row['dkv_ms']:.4f} ms ({row['dkv_host_us']:.1f} us host)")
        rows.append(row)
        del q, k, v, do, out, lse, delta
    sass = {}
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    for built in (attention.load(), attention.load_bwd()):
        sass.update(sass_counts(built.path, tool))
    for name, c in sorted(sass.items()):
        print(f"{args.label} SASS {name}: " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
    print(smi)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0), "smi": smi,
                      "rows": rows, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
