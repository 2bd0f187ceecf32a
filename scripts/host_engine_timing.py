#!/usr/bin/env python3
"""Time the port's host collective engine on this machine's CPU.

Four ranks (one thread each) of ``kungfu_tpu_torch.comm.engine.
CollectiveEngine`` over loopback ``NativeHostChannel``s mean-allreduce an
f32 buffer in place, as ``chip_smoke.py`` phase 12 does with BERT-base's
gradient, under each combination of the knobs that shape the C++
executor: executor threads a rank (``KF_CONFIG_ENGINE_THREADS``), chunk
bytes (``KF_CONFIG_CHUNK_SIZE``), unix sockets or TCP
(``KF_TPU_USE_UNIXSOCK``), pinned or pageable buffers; and once the
Python path (``KF_NATIVE_ENGINE=0``).  Each cell prints the median wall
ms of ``--reps`` allreduces and the buffer GB/s, and checks every rank's
result bitwise equal to rank 0's.  No GPU is used (``--pinned`` needs
one).

    python3 scripts/host_engine_timing.py --mib 128 --out chiprun_out/host_engine.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", type=int, default=128, help="buffer MiB a rank")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--chunks-kib", default="256,1024,4096")
    ap.add_argument("--pinned", action="store_true",
                    help="page-locked buffers (needs CUDA)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    from kungfu_tpu_torch.comm import engine as E
    from kungfu_tpu_torch.comm.host import NativeHostChannel
    from kungfu_tpu_torch.plan import PeerID, PeerList

    n = args.ranks
    elems = args.mib * (1 << 20) // 4
    gen = torch.Generator().manual_seed(0)
    src = [torch.randn(elems, generator=gen) for _ in range(n)]
    bufs = [torch.empty(elems, pin_memory=args.pinned) for _ in range(n)]
    sock_dir = tempfile.mkdtemp(prefix="kfsock")
    os.environ["KF_SOCK_DIR"] = sock_dir
    rows = []

    def cell(threads, chunk_kib, unix, native):
        os.environ["KF_CONFIG_ENGINE_THREADS"] = str(threads)
        os.environ["KF_CONFIG_CHUNK_SIZE"] = str(chunk_kib << 10)
        os.environ["KF_TPU_USE_UNIXSOCK"] = "1" if unix else "0"
        os.environ["KF_NATIVE_ENGINE"] = "1" if native else "0"
        chans = [NativeHostChannel(PeerID("127.0.0.1", 0),
                                   bind_host="127.0.0.1") for _ in range(n)]
        try:
            peers = PeerList.of(*(c.self_id for c in chans))
            engines = [E.CollectiveEngine(c, peers) for c in chans]
            times = []
            with ThreadPoolExecutor(max_workers=n) as pool:
                for rep in range(args.reps):
                    for b, s in zip(bufs, src):
                        b.copy_(s)
                    t0 = time.perf_counter()
                    futs = [pool.submit(e.all_reduce, b, op="mean",
                                        inplace=True, name=f"t{rep}")
                            for e, b in zip(engines, bufs)]
                    for f in futs:
                        f.result(timeout=600)
                    times.append((time.perf_counter() - t0) * 1e3)
            same = all(torch.equal(b, bufs[0]) for b in bufs)
            ran = [e.native_runs for e in engines]
            for e in engines:
                e.close()
        finally:
            for c in chans:
                c.close()
        ms = statistics.median(times)
        row = {"threads": threads, "chunk_kib": chunk_kib,
               "transport": "unix" if unix else "tcp",
               "path": "cxx" if native else "python", "ms": ms,
               "ms_all": times, "gb_s": elems * 4 / (ms / 1e3) / 1e9,
               "bitwise": same, "native_runs": ran}
        print(json.dumps(row), flush=True)
        if not same or (native and ran[0] != args.reps):
            raise SystemExit(f"bad cell {row}")
        rows.append(row)

    try:
        for threads, chunk, unix in itertools.product(
                [int(x) for x in args.threads.split(",")],
                [int(x) for x in args.chunks_kib.split(",")], (True, False)):
            cell(threads, chunk, unix, True)
        cell(8, 256, True, False)
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    best = min(rows, key=lambda r: r["ms"])
    print(f"host engine, {n} ranks x {args.mib} MiB f32, cpu count "
          f"{os.cpu_count()}: best {best}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"ranks": n, "mib": args.mib, "pinned": args.pinned,
                       "cpu_count": os.cpu_count(), "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
