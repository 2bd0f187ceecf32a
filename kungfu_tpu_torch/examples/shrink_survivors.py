"""Shrink to the survivors: a worker dies mid-job, the rest keep going
(port of ``examples/shrink_survivors.py``).

N workers allreduce a toy gradient every step; chaos kills one of them;
the survivors catch the typed ``PeerFailureError``, run the exclusion
consensus, shrink the cluster to themselves, replay from the last
committed step boundary held in memory and finish: no process relaunch,
no disk restore.

Run (rank 1 dies at step 3 of 8)::

    python -m kungfu_tpu_torch -np 3 -tolerate-failures \\
        -chaos 'die:step=3,rank=1' \\
        python3 -m kungfu_tpu_torch.examples.shrink_survivors --n-steps 8

The victim exits with the chaos status (43), which the launcher reports,
while the survivors print ``survived to step 8 on 2 workers`` and exit
0 without being relaunched.
"""

from __future__ import annotations

import argparse

#: demo-sized failure detection: a dead peer surfaces in seconds, not
#: the production-safe 60 s default
ENV_DEFAULT = {"KF_CONFIG_PEER_DEADLINE": "5"}


def train(peer, n_steps: int):
    """The toy S-SGD loop through any shrink: ``(step, params)``, the
    params a host f32 vector of 16."""
    import numpy as np

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.faults import PeerFailureError, QuorumLostError

    rng = np.random.RandomState(7 + kf.current_rank())
    params = np.zeros(16, np.float32)
    snap = StepSnapshot()
    step = 0
    while step < n_steps:
        chaos.note_step(peer.chaos_rank(), step)  # die:step=N fires here
        grad = rng.rand(16).astype(np.float32)
        try:
            engine = peer.engine()
            total = (
                engine.all_reduce(grad, op="mean", name=f"g{step}")
                if engine is not None else grad
            )
        except PeerFailureError as err:
            print(f"rank {peer.rank()}: peer failure ({err})", flush=True)
            try:
                shrunk, replay = peer.recover_from_failure(err, snapshot=snap)
            except QuorumLostError:
                print("quorum lost; deferring to the detector restart",
                      flush=True)
                raise
            if shrunk and replay is not None:
                step, tree, _ = replay
                # the replay holds host tensors: take a copy of our own
                params = np.array(tree["params"], np.float32)
                step += 1
                print(f"shrunk to {kf.cluster_size()} workers; replaying "
                      f"from step {step}", flush=True)
            continue  # retry (transient) or replay (shrunk) this step
        params -= 0.1 * total
        snap.commit(step, {"params": params})
        step += 1
    return step, params


def main(argv=None, report=None) -> int:
    """``report``, a dict when given, receives the final ``step`` and
    ``params``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-steps", type=int, default=8)
    args = ap.parse_args(argv)

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.examples._local import scoped_env

    with scoped_env(default=ENV_DEFAULT):
        peer = kf.init()
        print(f"worker {kf.current_rank()}/{kf.cluster_size()} up",
              flush=True)
        step, params = train(peer, args.n_steps)
        print(f"survived to step {step} on {kf.cluster_size()} workers",
              flush=True)
        kf.finalize()
    if report is not None:
        report.update(step=step, params=params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
