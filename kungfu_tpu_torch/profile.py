"""Where the time goes on the card: the flagship forward and a full-batch
decode step of the serving engine, traced with ``torch.profiler``.

    python -m kungfu_tpu_torch.profile [--steps N] [--out FILE]

For each phase it prints (and writes as JSON to ``--out``): host wall
time per call, device busy time per call (the sum of the CUDA kernel
durations the profiler recorded), the device's idle share of the wall
time, and the device time by kernel family (the hand-written flash
kernel, matrix products, everything else) with the top kernels by name.
Random weights from seed 0 at the flagship's full width; needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


def _family(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd (hand-written)"
    if any(t in low for t in ("gemm", "cutlass", "xmma", "cublas", "matmul")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies, gathers)"


def _profile(torch, fn, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    launches = collections.Counter()
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dur = evt.time_range.elapsed_us()
            by_name[evt.name] += dur
            launches[evt.name] += 1
    busy_us = sum(by_name.values())
    families = collections.Counter()
    for name, us in by_name.items():
        families[_family(name)] += us
    return {
        "wall_ms_per_call": wall_us / steps / 1e3,
        "device_busy_ms_per_call": busy_us / steps / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
        "kernels_per_call": sum(launches.values()) / steps,
        "device_ms_by_family": {k: v / steps / 1e3
                                for k, v in families.most_common()},
        "top_kernels_ms": [(n[:90], us / steps / 1e3, launches[n] // steps)
                           for n, us in by_name.most_common(8)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from kungfu_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    from kungfu_tpu_torch.serve.engine import InferenceEngine

    cfg = TransformerConfig(vocab_size=32128, d_model=768, n_layers=12,
                            n_heads=12, d_ff=3072, max_seq=512, causal=True,
                            pos="rope", dtype="bfloat16")
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 256))).cuda()
    out = {"device": torch.cuda.get_device_name(0)}
    out["forward_4x256"] = _profile(torch, lambda: model.apply(params, ids),
                                    args.steps)

    engine = InferenceEngine(model, params, max_batch=8, max_seq=512)
    for i in range(8):
        engine.submit(f"r{i}", rng.integers(0, cfg.vocab_size, size=128).tolist(),
                      256)
    while engine.pending_count:
        engine.step()  # admit all eight (one prefill per step)
    out["decode_step_batch8"] = _profile(torch, engine.step, args.steps)

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
