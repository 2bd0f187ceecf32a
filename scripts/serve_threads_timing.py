#!/usr/bin/env python3
"""Steps per second of the flagship serving engine on the card, eager
against its captured CUDA graphs (decode and prefill), with 1, 2 and 6
engines stepping in threads of one interpreter (the in-process serving
deployment of ``chip_smoke.py`` phase 16).

    python3 scripts/serve_threads_timing.py [--seconds 4] [--out FILE]

Each engine (``max_batch=4``, ``max_seq=512``, 16-token pages) keeps
four 72-token requests of 24 new tokens in flight, refilled as they
finish; a thread loops ``engine.step()``.  Prints, per mode and thread
count, each thread's steps/s and the total, beside the card's
``nvidia-smi`` name and power limit, and the launches one eager decode
step issues (``torch.profiler``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(vocab_size=32128, d_model=768, n_layers=12, n_heads=12,
                d_ff=3072, max_seq=512, causal=True, pos="rope",
                dtype="bfloat16")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--threads", default="1,2,6")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.serve.engine import InferenceEngine
    from kungfu_tpu_torch.serve.kvcache import KVCachePool, PageSpec

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    model = tr.Transformer(tr.TransformerConfig(**FLAGSHIP))
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(0)

    def engine(graph: bool):
        pool = KVCachePool(PageSpec.for_model(model.cfg, page_tokens=16), 256)
        e = InferenceEngine(model, params, pool=pool, max_batch=4,
                            max_seq=512)
        e.warmup(prompt_lens=(96,))
        if not graph:  # drop the captured graphs: every step eager
            e._decode_graph = None
            e._prefill_graphs = {}
        return e

    def fill(e, tag):
        for i in range(4):
            e.submit(f"{tag}{i}-{time.perf_counter_ns()}",
                     rng.integers(0, vocab, size=72).tolist(), 24)

    e = engine(False)
    fill(e, "p")
    e.step()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            e.step()
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                 "cudaGraphLaunch"))
    e.drain()
    del e
    out = {"card": card, "eager_launches_per_step": launches / 10,
           "rows": []}
    print(f"{card}; one eager decode step: {launches / 10:.0f} launches")
    for mode in ("eager", "graph"):
        for n in [int(x) for x in args.threads.split(",")]:
            engines = [engine(mode == "graph") for _ in range(n)]
            counts = [0] * n
            stop = threading.Event()

            def run(i):
                eng = engines[i]
                while not stop.is_set():
                    if not (eng.pending_count or eng.active_count):
                        fill(eng, f"w{i}")
                    eng.step()
                    counts[i] += 1

            ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
            for t in ths:
                t.start()
            time.sleep(1.0)
            c0 = list(counts)
            t0 = time.perf_counter()
            time.sleep(args.seconds)
            c1 = list(counts)
            dt = time.perf_counter() - t0
            stop.set()
            for t in ths:
                t.join()
            rates = [(b - a) / dt for a, b in zip(c0, c1)]
            row = {"mode": mode, "threads": n, "steps_s": rates,
                   "total_steps_s": sum(rates)}
            out["rows"].append(row)
            print(f"{mode} x{n}: steps/s each "
                  f"{[round(r, 2) for r in rates]}, total {sum(rates):.2f}")
            del engines
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
