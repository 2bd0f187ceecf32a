"""CIFAR-10 + ElasticDataset + checkpoint + elastic resize in one job
(port of ``examples/cifar_elastic.py``).

Per step: the shard's batch from the :class:`ElasticDataset`, its
gradients, the host-plane gradient allreduce, the update, then
``elastic_step`` (schedule-driven resize, params re-broadcast, step
re-sync).  After every resize the dataset is re-sharded at the same
global sample offset, so the stream continues instead of restarting.
Rank 0 checkpoints params and the global consumed-samples offset every
``--ckpt-every`` steps; with ``--restart 1`` the job resumes both from
the checkpoint (the failure-recovery runner's contract).

The data is ``load_cifar10()``: the cached, hash-pinned archive, or the
deterministic synthetic set where there is none and none can be
fetched.

Run (2 provisioned slots, grow 1 -> 2 mid-job)::

    python -m kungfu_tpu_torch -w -builtin-config-port 9129 \\
        -np 1 -H 127.0.0.1:2 python3 -m kungfu_tpu_torch.examples.cifar_elastic \\
        -- --schedule 1:4,2:4
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default="1:4,2:4")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--restart", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=1024,
                    help="training subset size (keeps the CPU run fast)")
    args = ap.parse_args(argv)

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from kungfu_tpu_torch.datasets import ElasticDataset, load_cifar10
    from kungfu_tpu_torch.elastic import ElasticState, elastic_step
    from kungfu_tpu_torch.elastic.schedule import total_steps
    from kungfu_tpu_torch.examples.mnist_slp import sgd_step
    from kungfu_tpu_torch.initializer import broadcast_parameters
    from kungfu_tpu_torch.models.mlp import MLP
    from kungfu_tpu_torch.optimizers import sgd

    peer = kf.init()
    device = peer.device()
    rank, size = kf.current_rank(), kf.cluster_size()
    print(f"worker {rank}/{size} up (v{peer.cluster_version})", flush=True)

    (x, y), _ = load_cifar10()
    x, y = x[: args.n_train], y[: args.n_train]
    x = x.reshape(len(x), -1)  # MLP over flattened pixels: fast on a CPU

    model = MLP([128], num_classes=10, input_dim=x.shape[1])
    params = model.init(torch.Generator().manual_seed(3), device=device)

    ds = ElasticDataset([x, y], args.batch_size, rank=rank, size=size, seed=11)
    state = ElasticState()

    if args.restart and args.ckpt_dir:
        got = restore_checkpoint(args.ckpt_dir, params)
        if got is not None:
            params, step, meta = got
            state.step = int(step)
            ds.skip(int(meta.get("consumed", 0)))
            print(
                f"worker {rank}: resumed at step {state.step}, "
                f"consumed {ds.consumed}", flush=True,
            )
    params = broadcast_parameters(params, peer)
    # joiners/restarters adopt the survivors' global stream offset (at
    # the same engine-op sequence point as the resize branch's sync)
    ds.sync_consumed(peer)

    opt = sgd(args.lr, momentum=0.9)
    opt_state = opt.init(params)

    n_steps = total_steps(args.schedule)
    first_loss = last_loss = None
    while state.step < n_steps:
        xb, yb = ds.next_batch()
        batch = (torch.from_numpy(xb).to(device),
                 torch.from_numpy(yb).long().to(device))
        params, opt_state, loss = sgd_step(model, opt, params, opt_state,
                                           batch, peer.engine())
        if first_loss is None:
            first_loss = float(loss)
        last_loss = float(loss)

        prev_version = peer.cluster_version
        state, params, stop = elastic_step(peer, state, args.schedule, params)
        if stop:
            print(f"worker {rank}: detached at step {state.step}", flush=True)
            kf.finalize()
            return 0
        # keyed on the version, not size/rank: a same-size membership
        # change (a worker replaced) still needs the re-shard and sync
        if peer.cluster_version != prev_version:
            # re-shard the same stream under the new shape; the consumed
            # offset carries over so no sample window is replayed
            rank, size = kf.current_rank(), kf.cluster_size()
            ds.set_cluster(rank, size)
            ds.sync_consumed(peer)
            # the optimizer's momentum follows the re-broadcast params
            opt_state = opt.init(params)
            print(
                f"worker {rank}: resized to {size} at step {state.step}, "
                f"stream offset {ds.consumed}", flush=True,
            )
        if args.ckpt_dir and rank == 0 and state.step % args.ckpt_every == 0:
            save_checkpoint(
                args.ckpt_dir, state.step, params,
                meta={"consumed": int(ds.consumed)},
            )

    print(
        f"worker {rank}: done step={state.step} resizes={state.resized} "
        f"consumed={ds.consumed} loss {first_loss:.4f}->{last_loss:.4f} OK",
        flush=True,
    )
    kf.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
