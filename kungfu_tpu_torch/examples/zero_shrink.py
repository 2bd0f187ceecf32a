"""ZeRO-2 over the host plane through a live shrink: the elastic
re-carve end to end (port of ``examples/zero_shrink.py``).

Each of N workers trains a toy model with the weight-update-sharded
step: ``engine.reduce_scatter`` hands every rank the 1/n gradient chunk
it owns, the momentum update runs on that chunk only (optimizer state is
1/n a rank, the ZeRO memory claim), and ``engine.all_gather``
re-assembles the parameters.  Every step commits two boundaries:

* the replicated parameters into a :class:`StepSnapshot` (the shrink
  leader can broadcast those whole), and
* the sharded momentum into a :class:`ZeroBoundary` plus a ring-buddy
  mirror (``replicate_ring``): no rank holds more than its own chunk
  and one buddy's.

Chaos kills a rank at step 3 and another at step 5: a live 4 -> 2 shrink
in two stages (the exclusion consensus needs a strict majority of the
current world, so a simultaneous double death is the case it must
refuse).  Each time the survivors catch the typed ``PeerFailureError``,
shrink to themselves, replay params from the snapshot and re-carve the
momentum leaderlessly from the committed boundary, the dead rank's chunk
served from its ring-buddy mirror.  Training continues at the new size
with state bit-identical to a job that had run at that size all along
(the per-rank gradients are identical by construction, so the final
params equal a plain numpy momentum-SGD replay).

Run (rank 3 dies at step 3, rank 1 at step 5, of 8)::

    python -m kungfu_tpu_torch -np 4 -tolerate-failures \\
        -chaos 'die:step=3,rank=3;die:step=5,rank=1' \\
        python3 -m kungfu_tpu_torch.examples.zero_shrink --n-steps 8
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

TOTAL = 32  # parameter count; not divisible by 4 x 3: padding stays live
LR, MOMENTUM = 0.125, 0.5  # exact binary fractions: bitwise-replayable
#: demo-sized failure detection
ENV_DEFAULT = {"KF_CONFIG_PEER_DEADLINE": "5"}


def grad_at(params: np.ndarray, step: int) -> np.ndarray:
    """Deterministic per-rank gradient, identical on every rank: the mean
    over ranks is then world-size-invariant, so an elastic run is
    directly comparable to a fixed-size numpy replay."""
    target = np.full(TOTAL, step * 0.125, np.float32)
    return (params - target).astype(np.float32)


def zero2_step(engine, params, m_chunk, step: int, n: int, rank: int):
    """One ZeRO-2 step over the host engine: ``(params, m_chunk)``."""
    chunk = math.ceil(TOTAL / n)
    g_chunk = engine.reduce_scatter(grad_at(params, step), op="mean",
                                    name=f"g{step}")
    m_chunk = MOMENTUM * m_chunk + g_chunk
    padded = np.zeros(chunk * n, np.float32)
    padded[:TOTAL] = params
    p_chunk = padded[rank * chunk:(rank + 1) * chunk] - LR * m_chunk
    full = engine.all_gather(p_chunk, name=f"p{step}")
    return full.reshape(-1)[:TOTAL].copy(), m_chunk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-steps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.faults import PeerFailureError, QuorumLostError
    from kungfu_tpu_torch.elastic.reshard import ZeroBoundary
    from kungfu_tpu_torch.examples._local import scoped_env

    with scoped_env(default=ENV_DEFAULT):
        peer = kf.init()
        n, rank = kf.cluster_size(), peer.rank()
        print(f"zero2 worker {rank}/{n} up", flush=True)

        params = (np.arange(TOTAL, dtype=np.float32) / TOTAL)
        m_chunk = np.zeros(math.ceil(TOTAL / n), np.float32)  # 1/n a rank
        snap = StepSnapshot()
        boundary = ZeroBoundary()
        step = 0
        while step < args.n_steps:
            chaos.note_step(peer.chaos_rank(), step)
            try:
                params, m_chunk = zero2_step(peer.engine(), params, m_chunk,
                                             step, n, rank)
            except PeerFailureError as err:
                print(f"rank {peer.rank()}: peer failure ({err})", flush=True)
                try:
                    shrunk, replay = peer.recover_from_failure(
                        err, snapshot=snap, zero_boundary=boundary)
                except QuorumLostError:
                    print("quorum lost; deferring to the detector restart",
                          flush=True)
                    raise
                if shrunk and replay is not None:
                    step, tree, _ = replay
                    # the replay holds host tensors: take a copy of our own
                    params = np.array(tree["params"], np.float32)
                    n, rank = kf.cluster_size(), peer.rank()
                    # the momentum was re-carved leaderlessly for the new
                    # membership (dead chunks served from ring buddies)
                    bstep, vec, _ = boundary.chunks()
                    assert bstep == step, (bstep, step)
                    m_chunk = vec[0].numpy()
                    step += 1
                    print(f"shrunk to {n} workers; momentum re-carved, "
                          f"replaying from step {step}", flush=True)
                continue  # transient: retry; shrunk: replay
            # committed boundary: params whole, momentum sharded + mirrored
            snap.commit(step, {"params": params})
            boundary.commit_local(step, {"m": torch.from_numpy(m_chunk)},
                                  total=TOTAL, old_n=n, my_old=rank)
            if n > 1:
                boundary.replicate_ring(peer.channel, peer.cluster.workers,
                                        tag=f"s{step}")
            step += 1

        print(f"zero2 survived to step {step} on {kf.cluster_size()} "
              f"workers", flush=True)
        if peer.rank() == 0:
            print("FINAL " + json.dumps([float(x) for x in params]),
                  flush=True)
        kf.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
