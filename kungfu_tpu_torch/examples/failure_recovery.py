"""Failure detection and auto-recovery end to end (port of
``examples/failure_recovery.py``).

Workers send batch and epoch heartbeats; one worker deliberately dies
(``--die-at-epoch``) or stalls (``--hang-at-epoch``) in the middle of an
epoch on the first run; the monitored runner detects it, relaunches the
group with the remaining epochs and ``--restart 1``; the workers reload
the last epoch checkpoint and finish.  Every epoch runs the same batches
of the rank's shard, so a recovered run ends on the same params as an
uninterrupted one, bit for bit.

Run::

    python -m kungfu_tpu_torch -auto-recover 4s -np 2 python3 -m \\
        kungfu_tpu_torch.examples.failure_recovery --n-epochs 4 \\
        --die-at-epoch 1 --ckpt-dir /tmp/kf-ckpt
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-epochs", type=int, default=4)
    ap.add_argument("--die-at-epoch", type=int, default=-1)
    ap.add_argument("--hang-at-epoch", type=int, default=-1,
                    help="stall (begin without end) instead of crashing — "
                         "exercises the heartbeat-timeout detection path")
    ap.add_argument("--restart", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--ckpt-dir", default="/tmp/kf-tpu-ckpt")
    args = ap.parse_args(argv)

    import glob
    import time

    import numpy as np
    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from kungfu_tpu_torch.examples.mnist_slp import (batches, sgd_step,
                                                     synthetic_mnist)
    from kungfu_tpu_torch.initializer import broadcast_parameters
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.monitor.signals import (monitor_batch_begin,
                                                  monitor_batch_end,
                                                  monitor_epoch_end,
                                                  monitor_train_end)
    from kungfu_tpu_torch.optimizers import sgd

    peer = kf.init()
    device = peer.device()
    rank, size = kf.current_rank(), kf.cluster_size()
    engine = peer.engine()
    model = mnist_slp()
    params = model.init(torch.Generator().manual_seed(7), device=device)

    start_epoch = 0
    if not args.restart and rank == 0:
        # a fresh run drops the checkpoints of earlier invocations
        for f in glob.glob(os.path.join(args.ckpt_dir, "ckpt_*")):
            os.unlink(f)
    if args.restart:
        got = restore_checkpoint(args.ckpt_dir, params)
        if got is not None:
            params, _, meta = got
            start_epoch = int(meta.get("epochs_done", 0))
            print(f"worker {rank}: restarted from epoch {start_epoch}",
                  flush=True)
        elif rank == 0:
            # rank 0 owns the checkpoints: its restore failing on a
            # restart round is a fault, and retraining from scratch would
            # break the runner's epoch accounting
            listing = (sorted(os.listdir(args.ckpt_dir))
                       if os.path.isdir(args.ckpt_dir) else "missing")
            print(f"worker {rank}: RESTART WITHOUT CHECKPOINT in "
                  f"{args.ckpt_dir} (contents: {listing})", flush=True)
        # only rank 0 writes checkpoints and the directory need not be
        # shared: the resume epoch and the params come from rank 0
        if engine is not None:
            start_epoch = int(engine.broadcast(
                np.array([start_epoch], np.int64))[0])
    params = broadcast_parameters(params, peer)

    x, y = synthetic_mnist()
    shard = np.arange(len(x)) % size == rank
    x, y = x[shard], y[shard]
    opt = sgd(args.lr)
    opt_state = opt.init(params)

    steps = len(x) // args.batch_size
    loss = None
    for epoch in range(args.n_epochs):
        for i, batch in enumerate(batches(x, y, args.batch_size, device)):
            monitor_batch_begin(rank)
            params, opt_state, loss = sgd_step(model, opt, params, opt_state,
                                               batch, engine)
            monitor_batch_end(rank)
            first_round = not args.restart and rank == size - 1 \
                and i == steps // 2
            if first_round and epoch == args.die_at_epoch:
                print(f"worker {rank}: simulating crash at epoch {epoch}",
                      flush=True)
                os._exit(17)
            if first_round and epoch == args.hang_at_epoch:
                print(f"worker {rank}: simulating stall at epoch {epoch}",
                      flush=True)
                monitor_batch_begin(rank)  # a begin that never ends
                time.sleep(3600)
        global_epoch = start_epoch + epoch
        monitor_epoch_end(rank, global_epoch)
        if rank == 0:
            save_checkpoint(args.ckpt_dir, global_epoch, params,
                            meta={"epochs_done": global_epoch + 1})
            print(f"epoch {global_epoch}: loss {float(loss):.4f}", flush=True)

    monitor_train_end(rank)
    print(f"worker {rank}: trained epochs [{start_epoch}, "
          f"{start_epoch + args.n_epochs}) OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
