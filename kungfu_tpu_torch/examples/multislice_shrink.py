"""Slice loss as a survivable failure: the multislice recovery ladder
end to end (port of ``examples/multislice_shrink.py``).

An emulated 2-slice pod (the launcher's ``-num-slices 2``: 4 workers,
slice-major, ranks 0,1 slice 0 and ranks 2,3 slice 1) trains the host
ZeRO-2 toy step of :mod:`.zero_shrink`.  Two things are slice-aware:

* the buddy mirrors use ``stride = ranks_per_slice``, so every rank's
  momentum chunk is mirrored into the next slice: a whole slice dying at
  once leaves all of its chunks recoverable, where adjacent same-slice
  mirrors would die together;
* recovery runs the slice ladder: chaos (``die_slice:slice=1,step=3``)
  kills both ranks of slice 1 at one step boundary, the survivors get
  the typed ``PeerFailureError``, and ``recover_from_failure`` widens the
  ping-confirmed dead set to the whole slice, counts quorum in slices
  (1 of 2 surviving, with the lowest-slice tie-break), reaches exclusion
  consensus over the surviving slice leaders and re-carves the momentum
  from the cross-slice buddy mirrors.

Training then continues on the surviving slice with state bitwise equal
to a fixed-world run from the same committed step.

Run (slice 1, ranks 2 and 3, dies at step 3 of 8)::

    python -m kungfu_tpu_torch -np 4 -num-slices 2 \\
        -tolerate-failures -chaos 'die_slice:slice=1,step=3' \\
        python3 -m kungfu_tpu_torch.examples.multislice_shrink --n-steps 8
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

from kungfu_tpu_torch.examples.zero_shrink import (ENV_DEFAULT, TOTAL,
                                                   zero2_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-steps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.faults import (PeerFailureError,
                                              QuorumLostError,
                                              SliceExcludedError)
    from kungfu_tpu_torch.elastic.reshard import ZeroBoundary
    from kungfu_tpu_torch.examples._local import scoped_env

    with scoped_env(default=ENV_DEFAULT):
        peer = kf.init()
        n, rank = kf.cluster_size(), peer.rank()
        topo = peer.slice_topology()
        assert topo is not None, "run under the launcher's -num-slices"
        print(f"multislice worker {rank}/{n} up "
              f"(slice {peer.slice_id()}/{topo.num_slices})", flush=True)

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
                except SliceExcludedError as exc:
                    # alive, but the slice is not: stand down cleanly
                    print(f"excluded with degraded slice: {exc}", flush=True)
                    kf.finalize()
                    return 0
                except QuorumLostError:
                    print("slice quorum lost; deferring to the detector "
                          "restart", flush=True)
                    raise
                if shrunk and replay is not None:
                    step, tree, _ = replay
                    # the replay holds host tensors: take a copy of our own
                    params = np.array(tree["params"], np.float32)
                    n, rank = kf.cluster_size(), peer.rank()
                    topo = peer.slice_topology()
                    # the momentum was re-carved for the surviving slices,
                    # the dead slice's chunks served from cross-slice
                    # buddies
                    bstep, vec, _ = boundary.chunks()
                    assert bstep == step, (bstep, step)
                    m_chunk = vec[0].numpy()
                    step += 1
                    print(f"slice-shrunk to {n} workers "
                          f"({topo.num_slices} slice(s)); momentum "
                          f"re-carved, replaying from step {step}",
                          flush=True)
                continue  # transient: retry; shrunk: replay
            # committed boundary: params whole, momentum sharded + mirrored
            snap.commit(step, {"params": params})
            boundary.commit_local(step, {"m": torch.from_numpy(m_chunk)},
                                  total=TOTAL, old_n=n, my_old=rank)
            if n > 1:
                # cross-slice buddies: the mirror must survive its
                # owner's whole slice dying, so it lives ranks_per_slice
                # away; once one slice remains the failure grain is back
                # to ranks and the adjacent ring applies
                stride = (topo.ranks_per_slice if topo.num_slices > 1
                          else 1)
                boundary.replicate_ring(peer.channel, peer.cluster.workers,
                                        tag=f"s{step}", stride=stride)
            step += 1

        print(f"multislice survived to step {step} on {kf.cluster_size()} "
              f"workers ({peer.slice_topology().num_slices} slice(s))",
              flush=True)
        if peer.rank() == 0:
            print("FINAL " + json.dumps([float(x) for x in params]),
                  flush=True)
        kf.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
