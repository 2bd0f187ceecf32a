#!/usr/bin/env python3
"""Time the fused LM-head kernels of a checkout of the PyTorch/CUDA port
on one GPU.

    python3 scripts/lm_head_timing.py [--root DIR] [--label NAME]

Imports ``kungfu_tpu_torch`` from ``DIR`` (default: the checkout holding
this script), so two checkouts, e.g. a ``git archive`` of a parent
commit unpacked into an ignored directory, can be timed in turns
(parent, change, change, parent) in one call on one card.  At the
flagship's shape, h ``[8192, 768]`` bf16 and W ``[768, 32128]`` f32 (the
fused-head training step of ``gpt_small(max_seq=2048)`` at ids
``[4, 2048]``), it prints the device ms per launch of the forward
(``lm_head._launch_fwd``), dh (``_launch_dh``) and dW (``_launch_dw``;
for bf16 h each includes the split of W where the checkout's kernel
takes one, timed alone beside them): the median over 5 CUDA-event
windows of one launch (two for the forward), warm L2, the stream held by
a sleep kernel while the host enqueues; the host µs per launch of each
wrapper (host clock over 10 calls enqueued behind a sleep kernel); the
largest error of loss, lse, dh and dW against the plain versions as a
share of chip_smoke.py's tolerances; the wgmma and TMA-load instruction
counts (HGMMA, UTMALDG) of every wgmma kernel in the checkout's built
library (``cuobjdump --dump-sass``); and the card's name and power
limit.  The last line is one JSON object with
all of it.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

N, D, V = 8192, 768, 32128
#: chip_smoke.py's tolerances: loss and lse; f32 dW (rtol plus a share
#: of max|dW|); bf16 dh (two bf16 ulps plus the same share)
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-6
DW_RTOL, ATOL_SHARE = 1e-4, 1e-5
DH_RTOL_BF16 = 2 ** -6


def tol_share(got, ref, rtol: float, atol: float) -> float:
    """max |got - ref| / (atol + rtol |ref|); <= 1 passes."""
    ref = ref.float()
    return ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def device_ms(torch, fn, iters: int, windows: int = 5) -> float:
    for _ in range(2):
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


def host_us(torch, fn, calls: int = 10) -> float:
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
    """{kernel name: HGMMA and UTMALDG counts} of the library's wgmma
    kernels."""
    out = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if "wgmma" in m.group(1) else None
            if cur:
                counts[cur] = {"HGMMA": 0, "UTMALDG": 0}
        elif cur:
            for op in counts[cur]:
                counts[cur][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


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
    from kungfu_tpu_torch.ops.cuda import _build
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((D, V), generator=gen, device="cuda") * 0.05
    t = torch.randint(0, V, (N,), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.randn((N,), generator=gen, device="cuda")
    loss, lse = lmk._launch_fwd(h, w, t)[:2]
    dh = lmk._launch_dh(h, w, t, lse, g)
    dw = lmk._launch_dw(h, w, t, lse, g)
    ref_loss, ref_lse = lmk.lm_head_forward_reference(h, w, t)
    ref_dh, ref_dw = lmk.lm_head_backward_reference(h, w, t, ref_lse, g)
    shares = {
        "loss": tol_share(loss, ref_loss, LOSS_RTOL, LOSS_ATOL),
        "lse": tol_share(lse, ref_lse, LOSS_RTOL, LOSS_ATOL),
        "dh": tol_share(dh, ref_dh, DH_RTOL_BF16,
                        ATOL_SHARE * ref_dh.float().abs().max().item()),
        "dw": tol_share(dw, ref_dw, DW_RTOL,
                        ATOL_SHARE * ref_dw.abs().max().item())}
    del dh, dw, ref_dh, ref_dw

    def fwd():
        lmk._launch_fwd(h, w, t)

    def dh():
        lmk._launch_dh(h, w, t, lse, g)

    def dwk():
        lmk._launch_dw(h, w, t, lse, g)

    row = {"fwd_ms": device_ms(torch, fwd, 2), "dh_ms": device_ms(torch, dh, 1),
           "dw_ms": device_ms(torch, dwk, 1),
           "split_ms": (device_ms(torch, lambda: lmk.split_w(w), 5)
                        if hasattr(lmk, "split_w") else None),
           "fwd_host_us": host_us(torch, fwd), "dh_host_us": host_us(torch, dh),
           "dw_host_us": host_us(torch, dwk),
           **{f"{k}_tol_share": r for k, r in shares.items()}}
    split = "" if row["split_ms"] is None else \
        f" (its split of W {row['split_ms']:.4f} ms)"
    print(f"{args.label} h [{N}, {D}] bf16, W [{D}, {V}] f32: forward "
          f"{row['fwd_ms']:.4f} ms ({row['fwd_host_us']:.1f} us host), dh "
          f"{row['dh_ms']:.4f} ms ({row['dh_host_us']:.1f} us host), dW "
          f"{row['dw_ms']:.4f} ms{split} ({row['dw_host_us']:.1f} us host); "
          f"share of tolerance used: " + ", ".join(
              f"{k} {r:.3f}" for k, r in shares.items()))
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = sass_counts(lmk.load().path, tool)
    for name, c in sorted(sass.items()):
        print(f"{args.label} SASS {name}: HGMMA {c['HGMMA']}, UTMALDG "
              f"{c['UTMALDG']}")
    print(smi)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0), "smi": smi,
                      "row": row, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
