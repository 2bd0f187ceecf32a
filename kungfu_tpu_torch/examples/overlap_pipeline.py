"""kf-overlap demo: bucketed communication/computation overlap, measured
(port of ``examples/overlap_pipeline.py``).

A 3-rank host-plane cluster in this process runs the ZeRO-2 bucket loop
twice under chaos-injected wire latency (``delay`` on every send): once
as the serial loop (issue, wait, compute, repeat) and once as the
depth-k software pipeline
(:func:`kungfu_tpu_torch.parallel.zero.host_bucket_pipeline`: bucket
i+k's reduce-scatter is issued on the engine's async window while bucket
i's optimizer math runs).  The script asserts:

* measured overlap > 0: the pipelined step beats the serial one, and
  the ``kf_overlap_efficiency`` histogram saw hidden wire time;
* the final parameters are bitwise identical between the two runs (the
  pipeline moves wall clock only);
* the ``kf_overlap_inflight`` gauge is back at 0 (no leaked handles).

Run: ``python -m kungfu_tpu_torch.examples.overlap_pipeline``
(``--base-port`` 0, the default, binds ports the OS assigns).
"""

from __future__ import annotations

import argparse
import sys
import time

WIRE_MS = 25
#: the demo's environment, set for ``main``'s run only: chaos rides the
#: engine's Python path
ENV = {"KF_NATIVE_ENGINE": "0",
       "KF_CHAOS_SPEC": f"delay:ms={WIRE_MS},on=send"}
ENV_DEFAULT = {"KF_CONFIG_LOG_LEVEL": "WARNING"}
N_RANKS, CHUNK, N_BUCKETS = 3, 24_000, 4


def run_mode(pipelined: bool, base_port: int, tag: str, steps: int):
    """``steps`` ZeRO-2 bucket steps on ``N_RANKS`` engines, serial or
    pipelined: ``(median step seconds, rank 0's final params)``."""
    import numpy as np

    from kungfu_tpu_torch.comm.engine import CollectiveEngine
    from kungfu_tpu_torch.comm.host import HostChannel
    from kungfu_tpu_torch.examples._local import run_world
    from kungfu_tpu_torch.parallel.zero import (host_bucket_all_gather,
                                                host_bucket_pipeline,
                                                host_bucket_spans)
    from kungfu_tpu_torch.plan import PeerID, PeerList, Strategy

    n, chunk = N_RANKS, CHUNK
    widths = [chunk // N_BUCKETS] * N_BUCKETS
    spans = host_bucket_spans(chunk, widths)
    total = n * chunk
    lr, mu = np.float32(0.125), np.float32(0.5)

    chans = [HostChannel(PeerID("127.0.0.1", base_port + i if base_port
                                else 0), bind_host="127.0.0.1")
             for i in range(n)]
    try:
        peers = PeerList.of(*(c.self_id for c in chans))
        engines = [CollectiveEngine(c, peers, Strategy.STAR) for c in chans]

        def one(i):
            params = (np.arange(total, dtype=np.float32) % 64) / 64
            mom = np.zeros(chunk, np.float32)
            eng = engines[i]
            times = []
            for k in range(steps):
                t0 = time.perf_counter()
                g = params * np.float32(0.5) + np.float32(2.0 ** -(k + 2))
                own = params[i * chunk:(i + 1) * chunk].copy()

                def compute(b, red):
                    off, w = spans[b]
                    m = mom[off:off + w] * mu + red
                    mom[off:off + w] = m
                    own[off:off + w] -= lr * m

                host_bucket_pipeline(eng, g, widths, compute,
                                     pipelined=pipelined, name=f"{tag}r{k}")
                params = host_bucket_all_gather(
                    eng, own, widths, pipelined=pipelined,
                    name=f"{tag}g{k}")
                times.append(time.perf_counter() - t0)
            assert eng.inflight() == 0, "leaked handles"
            return times, params

        outs = run_world([lambda i=i: one(i) for i in range(n)])
        step_s = float(np.median(
            [max(outs[i][0][k] for i in range(n)) for k in range(1, steps)]))
        return step_s, outs[0][1]
    finally:
        for c in chans:
            c.close()


def main(argv=None, report=None) -> int:
    """``report``, a dict when given, receives both runs' step seconds
    and final params."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--base-port", type=int, default=0,
                    help="rank r on base-port + r (+ 10 for the second "
                         "run); 0 binds ports the OS assigns")
    ns = ap.parse_args(argv)

    from kungfu_tpu_torch.examples._local import scoped_env
    from kungfu_tpu_torch.monitor.registry import REGISTRY

    with scoped_env(ENV, ENV_DEFAULT):
        eff0 = REGISTRY.snapshot().get("kf_overlap_efficiency",
                                       {"count": 0})["count"]
        serial_s, final_serial = run_mode(False, ns.base_port, "s", ns.steps)
        pipe_s, final_pipe = run_mode(True, ns.base_port and ns.base_port + 10,
                                      "p", ns.steps)

    assert final_serial.tobytes() == final_pipe.tobytes(), (
        "pipelined run diverged from serial: the geometry invariant broke")
    overlap_pct = (1.0 - pipe_s / serial_s) * 100.0
    assert overlap_pct > 0, (
        f"no measured overlap (serial {serial_s * 1e3:.1f} ms, "
        f"pipelined {pipe_s * 1e3:.1f} ms)")
    snap = REGISTRY.snapshot()
    eff = snap.get("kf_overlap_efficiency", {"count": 0})
    assert eff["count"] > eff0, "efficiency histogram never observed"
    assert snap.get("kf_overlap_inflight", 0.0) == 0.0, "gauge not at 0"
    print(
        f"overlap-demo: overlap {overlap_pct:.0f}% measured "
        f"(serial {serial_s * 1e3:.1f} ms -> pipelined {pipe_s * 1e3:.1f} ms "
        f"under {WIRE_MS} ms injected wire latency; bitwise-identical "
        f"params; inflight gauge 0)"
    )
    if report is not None:
        report.update(serial_s=serial_s, pipelined_s=pipe_s,
                      final_serial=final_serial, final_pipelined=final_pipe)
    return 0


if __name__ == "__main__":
    sys.exit(main())
