"""kf-adapt demo: scripted interference, asserting the swap fires (port
of ``examples/adapt_interference.py``).

A 3-rank host-plane cluster in this process starts on STAR while the
chaos layer (``delay`` clauses) throttles the 0<->1 link on both the
data path and the latency probe.  The UCB bandit
(:class:`kungfu_tpu_torch.monitor.adapt_device.HostBanditDriver`) reads
its measured windows, majority-votes and performs the consensus-fenced
lockstep swap onto the measured-latency MST, after which the step time
recovers.  The script asserts:

* a swap fired, away from the degraded starting strategy;
* the flight recorder holds the ``swap`` event on every rank with one
  agreed sequence number (the fence contract);
* the post-swap steady step time beats the degraded phase.

Run: ``python -m kungfu_tpu_torch.examples.adapt_interference``
(``--base-port`` 0, the default, takes ports found free).
"""

from __future__ import annotations

import argparse
import sys
import time

WIRE_MS = 25
#: the demo's environment, set for ``main``'s run only: chaos rides the
#: engine's Python path, and the trace gate records the swap events
ENV = {"KF_NATIVE_ENGINE": "0", "KF_CONFIG_ENABLE_TRACE": "1",
       "KF_CHAOS_SPEC": ";".join(
           f"delay:ms={WIRE_MS},rank={a},peer={b},on={on}"
           for a, b in ((0, 1), (1, 0)) for on in ("send", "ping"))}
ENV_DEFAULT = {"KF_CONFIG_LOG_LEVEL": "WARNING"}


def drill(peers, steps: int) -> dict:
    """``steps`` lockstep allreduces under the bandit on started
    ``peers``; asserts the swap and prints the summary."""
    import numpy as np

    from kungfu_tpu_torch.examples._local import run_world
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.monitor.adapt_device import HostBanditDriver

    drivers = [HostBanditDriver(p, check_every=2, min_pulls=1,
                                min_swap_collectives=1) for p in peers]
    data = np.ones(50_000, np.float32)
    times, swap_at = [], None
    # the swap events of this drill only: a cursor past the recorder's
    # earlier appends
    seen, _ = timeline.events_tail(0, frozenset({"swap"}))

    def one(p, d):
        t0 = time.perf_counter()
        out = p.engine().all_reduce(data, op="sum")
        dt = time.perf_counter() - t0
        assert float(out[0]) == 3.0, out[:4]
        return dt, d.step(dt)

    for i in range(steps):
        outs = run_world([lambda p=p, d=d: one(p, d)
                          for p, d in zip(peers, drivers)], timeout=60)
        flags = {s for _, s in outs}
        assert len(flags) == 1, f"non-lockstep swap at step {i}: {flags}"
        times.append(max(dt for dt, _ in outs))
        if flags.pop() and swap_at is None:
            swap_at = i
    assert swap_at is not None, "the bandit never swapped"
    actives = {d.active for d in drivers}
    assert actives != {"STAR"}, "degraded strategy was not abandoned"
    _, swaps = timeline.events_tail(seen, frozenset({"swap"}))
    seqs: dict = {}
    for e in swaps:
        seqs.setdefault(e["attrs"]["seq"], set()).add(e["rank"])
    assert any(len(ranks) == 3 for ranks in seqs.values()), (
        f"swap event not on every rank: {seqs}")
    degraded = float(np.median(times[:swap_at + 1]))
    steady = float(np.median(times[-5:]))
    assert steady < degraded, (degraded, steady)
    arm = actives.pop()
    print(
        f"adapt-demo: swap fired at step {swap_at} "
        f"(arm={arm}, ranks={sorted(max(seqs.values(), key=len))}); "
        f"steady {steady * 1e3:.1f} ms vs degraded {degraded * 1e3:.1f} ms"
    )
    return {"swap_at": swap_at, "arm": arm, "steady_s": steady,
            "degraded_s": degraded}


def main(argv=None, report=None) -> int:
    """``report``, a dict when given, receives :func:`drill`'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--base-port", type=int, default=0,
                    help="worker r on base-port + r; 0 finds free ports")
    ns = ap.parse_args(argv)

    from kungfu_tpu_torch.examples._local import (close_all, local_peers,
                                                  scoped_env)

    with scoped_env(ENV, ENV_DEFAULT):
        peers = local_peers(3, ns.base_port,
                            env={"KF_ALLREDUCE_STRATEGY": "STAR"})
        try:
            out = drill(peers, ns.steps)
        finally:
            close_all(peers)
    if report is not None:
        report.update(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
