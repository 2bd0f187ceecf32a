"""Decentralized gossip training under the launcher (port of
``examples/gossip_train.py``).

N worker processes train a least-squares model with PairAveraging:
each step pulls one peer's fused model over the host p2p plane,
averages 0.5/0.5, applies the local gradients and republishes.  No
collective anywhere: stragglers never block.  The model is small and
lives on the host, as the reference's does::

    python -m kungfu_tpu_torch -np 2 -H 127.0.0.1:2 \\
        python3 -m kungfu_tpu_torch.examples.gossip_train -- --steps 40

Prints one ``KFGOSSIP`` line a worker: the final local loss, the largest
weight error against the shared ground truth (small only if the replicas
mixed), the pull count and the average pull latency.
"""

from __future__ import annotations

import argparse
import sys


def problem(rank: int, dim: int):
    """The shared truth ``w_true`` ``[dim, 1]`` and worker ``rank``'s
    slice ``(X, Y)`` of it, 128 rows, f32 on the host."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    w_true = torch.from_numpy(rng.randn(dim, 1).astype(np.float32))
    local = np.random.RandomState(1000 + rank)
    X = torch.from_numpy(local.randn(128, dim).astype(np.float32))
    return w_true, X, X @ w_true


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", choices=["pair-avg", "async"],
                    default="pair-avg",
                    help="async = AsyncPairAveraging: background puller, "
                         "step averages with the last landed model")
    ns = ap.parse_args(argv)

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.optimizers.async_sgd import (
        AsyncPairAveragingOptimizer,
        PairAveragingOptimizer,
    )

    peer = kf.init()
    rank, size = kf.current_rank(), kf.cluster_size()

    # every worker sees a different slice of the same ground truth:
    # converging to w_true proves the models actually mixed
    w_true, X, Y = problem(rank, ns.dim)

    def loss_fn(p):
        return ((X @ p["w"] - Y) ** 2).mean()

    def grad(p):
        w = p["w"].detach().requires_grad_(True)
        return {"w": torch.autograd.grad(loss_fn({"w": w}), w)[0]}

    cls = (AsyncPairAveragingOptimizer if ns.optimizer == "async"
           else PairAveragingOptimizer)
    opt = cls(sgd(ns.lr), peer, name="gt", selector="roundrobin")
    params = {"w": torch.zeros((ns.dim, 1), dtype=torch.float32)}
    state = opt.init(params)
    for _ in range(ns.steps):
        params, state = opt.step(params, grad(params), state)
    if ns.optimizer == "async":
        opt.close()
    # the faster worker must not close its peer while a slower one is
    # still pulling from its store
    peer.barrier()

    with torch.no_grad():
        final = float(loss_fn(params))
        err = float((params["w"] - w_true).abs().max())
    n_pulls = opt.pull_bytes // (4 * ns.dim)
    pull_ms = (opt.pull_seconds / n_pulls * 1e3) if n_pulls else 0.0
    print(
        f"KFGOSSIP rank={rank} size={size} final_loss={final:.5f} "
        f"w_err={err:.4f} pulls={n_pulls} pull_ms_avg={pull_ms:.2f}",
        flush=True,
    )
    kf.finalize()
    # convergence bar: local loss near zero and weights near the shared
    # truth (impossible without mixing: each worker sees its slice only)
    return 0 if (final < 0.05 and err < 0.5) else 1


if __name__ == "__main__":
    sys.exit(main())
