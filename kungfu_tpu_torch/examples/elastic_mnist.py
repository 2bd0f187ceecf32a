"""Elastic MNIST training — the cluster resized mid-job (port of
``examples/elastic_mnist.py``).

Train under a step-based schedule like ``1:6,2:6``: the cluster grows or
shrinks at the scheduled steps without restarting the job; the weights
are re-broadcast after every membership change, and the watch-mode
runner spawns the joiners.

Run (watch mode and a builtin config server)::

    python -m kungfu_tpu_torch -w -builtin-config-port 9100 \\
        -np 1 -H 127.0.0.1:4 python3 -m \\
        kungfu_tpu_torch.examples.elastic_mnist --schedule 1:6,2:6,4:6
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default="1:6,2:6")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.2)
    args = ap.parse_args(argv)

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.elastic.hooks import ElasticState, elastic_step
    from kungfu_tpu_torch.elastic.schedule import total_steps
    from kungfu_tpu_torch.examples.mnist_slp import sgd_step, synthetic_mnist
    from kungfu_tpu_torch.initializer import broadcast_parameters
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.optimizers import sgd

    peer = kf.init()
    device = peer.device()
    rank = kf.current_rank()
    print(f"worker {rank}/{kf.cluster_size()} up (v{peer.cluster_version})",
          flush=True)

    model = mnist_slp()
    params = model.init(torch.Generator().manual_seed(7 + rank),
                        device=device)
    params = broadcast_parameters(params, peer)

    x, y = synthetic_mnist()
    opt = sgd(args.lr)
    opt_state = opt.init(params)

    state = ElasticState()
    n_steps = total_steps(args.schedule)
    sizes_seen = []
    while state.step < n_steps:
        size, rank = kf.cluster_size(), kf.current_rank()
        sizes_seen.append(size)
        # data parallel: worker `rank` takes slice `rank` of the step's
        # window
        lo = ((state.step * size + rank) * args.batch_size) \
            % (len(x) - args.batch_size)
        batch = (torch.from_numpy(x[lo:lo + args.batch_size]).to(device),
                 torch.from_numpy(y[lo:lo + args.batch_size]).long()
                 .to(device))
        params, opt_state, loss = sgd_step(model, opt, params, opt_state,
                                           batch, peer.engine())
        state, params, stop = elastic_step(peer, state, args.schedule, params)
        if stop:
            print(f"worker {rank}: detached at step {state.step}", flush=True)
            kf.finalize()
            return 0
        if rank == 0 and state.step % 3 == 0:
            print(f"step {state.step}: size {kf.cluster_size()} "
                  f"loss {float(loss):.4f}", flush=True)

    print(f"worker {kf.current_rank()}: done at step {state.step}, "
          f"sizes seen {sorted(set(sizes_seen))}, resizes survived "
          f"{state.resized}", flush=True)
    # rank 0's close sends "done" to every runner: hosts the schedule
    # shrank to no workers wait for a re-grow until they get it
    kf.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
