"""Live device-plane elastic worker over a provisioned world (port of
``examples/device_elastic.py``).

Every provisioned slot (``KF_WORLD_PEERS``) boots once into one process
world on the card; each elastic resize re-carves the communicator over
the *active* workers' processes.  Surviving workers keep training across
every epoch with no relaunch; dropped workers go *standby* (still
holding their world slot) and rejoin a later epoch without restarting.

Run under the launcher (a host-only test cluster, 4 provisioned slots, 2
initially active)::

    python -m kungfu_tpu_torch -np 2 -H 127.0.0.1:4 -w -device-world \\
        -backend cpu -builtin-config-port 9123 \\
        python3 -m kungfu_tpu_torch.examples.device_elastic \\
        -- --schedule 2,4,2

Every epoch each active worker runs a device-plane allreduce over the
active processes and prints one ``KFEPOCH`` line, in the reference's
format; the tests check that the psum spans exactly the active set and
that worker 0's pid never changes.  ``--train`` runs S-SGD (or ZeRO-1,
ZeRO-3 or per-replica SMA) steps of the MNIST SLP, whose params come
from :func:`slp_params` (numpy, seed 1) and whose batches from
``default_rng(1000)``, so that the reference's ``dp_train_step`` can be
fed the same numbers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def slp_params(seed: int = 1) -> dict:
    """The MNIST SLP's params as numpy (the same on every slot): a
    glorot-uniform ``784 x 10`` weight and a zero bias, drawn from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    limit = np.sqrt(6.0 / (784 + 10))
    return {"dense_0": {
        "w": rng.uniform(-limit, limit, (784, 10)).astype(np.float32),
        "b": np.zeros(10, np.float32)}}


def epoch_batches(size: int, steps: int):
    """The global batches of one epoch at ``size`` workers: ``steps`` of
    ``8 * size`` rows, from ``default_rng(1000)`` anew each epoch, so a
    loss that changes across epochs shows the weights carried over."""
    rng = np.random.default_rng(1000)
    gb = 8 * size
    out = []
    for _ in range(steps):
        x = rng.normal(size=(gb, 784)).astype(np.float32)
        y = rng.integers(0, 10, gb)
        out.append((x, y))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default="2,4,2",
                    help="active cluster size per epoch (config version e = "
                         "epoch e)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-wait timeout seconds")
    ap.add_argument("--train", action="store_true",
                    help="run S-SGD steps on each epoch over the re-carved "
                         "Communicator, carrying the model across resizes")
    ap.add_argument("--steps-per-epoch", type=int, default=2)
    ap.add_argument("--resync-root", type=int, default=0,
                    help="worker rank whose weights win the post-resize "
                         "re-sync (clamped to the epoch's membership)")
    ap.add_argument("--strategy", default="",
                    help="install an allreduce schedule on the first epoch; "
                         "later epochs inherit it")
    ap.add_argument("--autotune", action="store_true",
                    help="run autotune_strategy on the first epoch: every "
                         "process must install the same measured winner")
    ap.add_argument("--zero1", action="store_true",
                    help="with --train: ZeRO-1, the optimizer shards carried "
                         "across resizes by zero1_snapshot/zero1_reshard")
    ap.add_argument("--zero3", action="store_true",
                    help="with --train: ZeRO-3, the parameter shard and the "
                         "optimizer shards carried across resizes by "
                         "zero_snapshot/zero_reshard")
    ap.add_argument("--sma", action="store_true",
                    help="with --train: per-replica SMA (alpha 0.1), each "
                         "epoch re-stacked from the resync root's replica")
    ns = ap.parse_args(argv)
    if ns.steps_per_epoch < 1:
        ap.error("--steps-per-epoch must be >= 1")
    modes = [m for m in ("zero1", "zero3", "sma") if getattr(ns, m)]
    if modes and not ns.train:
        ap.error(f"--{modes[0]} requires --train")
    if len(modes) > 1:
        ap.error("--zero1, --zero3 and --sma exclude each other")
    schedule = [int(s) for s in ns.schedule.split(",")]
    shutdown_version = len(schedule)

    import torch

    from kungfu_tpu_torch.peer import Peer

    peer = Peer()
    peer.start()
    world = peer.config.world_peers
    if world is None:
        print("KFERROR: KF_WORLD_PEERS not set (run with -device-world)",
              flush=True)
        return 2
    my_world_rank = world.rank(peer.config.self_id)
    deadline = time.time() + ns.timeout * max(len(schedule), 1)
    device = peer.device()

    params = opt_state = opt = model = None
    if ns.train:
        from kungfu_tpu_torch.models import mnist_slp
        from kungfu_tpu_torch.optimizers import sgd
        from kungfu_tpu_torch.utils.tree import tree_map

        model = mnist_slp()
        params = tree_map(lambda a: torch.from_numpy(a).to(device),
                          slp_params())
        opt = sgd(0.1, momentum=0.9)
    z1_snap = None  # rank 0's host snapshot of the sharded state
    p_snap = None   # and of ZeRO-3's parameter shard
    p_shard = None

    def train_epoch(comm, v):
        """A few S-SGD (ZeRO-1, ZeRO-3 or SMA) steps over this epoch; the
        params and the optimizer state survive the transitions.  Epoch
        entry re-syncs them from the resync root over the new
        communicator, or re-carves the sharded state, so joiners take the
        survivors' trajectory."""
        from kungfu_tpu_torch.initializer import resync_parameters
        from kungfu_tpu_torch.optimizers import synchronous_sgd
        from kungfu_tpu_torch.parallel.train import dp_train_step

        nonlocal params, opt_state, z1_snap, p_snap, p_shard
        rroot = min(ns.resync_root, comm.size - 1)
        if ns.zero3:
            from kungfu_tpu_torch.parallel.zero import (zero_reshard,
                                                        zero_snapshot,
                                                        zero_train_step)

            z = zero_train_step(lambda p, b: model.loss(p, b), opt, comm,
                                stage=3)
            # params is the carve's structure only after epoch 0: the
            # shard and the state come from the pre-resize snapshots
            fresh_p, fresh = z.init_params(params), z.init_opt(params)
            if v == 0:
                p_shard, opt_state = fresh_p, fresh
            else:
                p_shard = zero_reshard(fresh_p, params, comm, peer,
                                       snapshot=p_snap)
                opt_state = zero_reshard(fresh, params, comm, peer,
                                         snapshot=z1_snap)
            loss = None
            for xb, yb in epoch_batches(comm.size, ns.steps_per_epoch):
                batch = (torch.from_numpy(xb).to(device),
                         torch.from_numpy(yb).to(device))
                p_shard, opt_state, loss = z.step(p_shard, opt_state, batch)
            z1_snap = zero_snapshot(opt_state, peer)
            p_snap = zero_snapshot(p_shard, peer)
            return float(loss)
        if ns.sma:
            from kungfu_tpu_torch.optimizers import synchronous_averaging
            from kungfu_tpu_torch.parallel.train import stack_for_replicas

            tx = synchronous_averaging(opt, comm.axis, alpha=0.1)
            step = dp_train_step(lambda p, b: model.loss(p, b), tx, comm,
                                 replicated_params=False)
            # the resync root's first replica wins: every process takes
            # its row 0 and re-stacks it for the ranks it now holds
            if opt_state is None:  # a process's first epoch
                one = (params, tx.init(params))
            else:
                one = tree_map(lambda a: a[0], (params, opt_state))
            one = resync_parameters(one, peer, comm=comm, root=rroot)
            params, opt_state = stack_for_replicas(one, comm.addressable_n)
            loss = None
            for xb, yb in epoch_batches(comm.size, ns.steps_per_epoch):
                batch = (torch.from_numpy(xb).to(device),
                         torch.from_numpy(yb).to(device))
                params, opt_state, loss = step(params, opt_state, batch)
            return float(loss)
        if ns.zero1:
            from kungfu_tpu_torch.parallel import (zero1_reshard,
                                                   zero1_snapshot,
                                                   zero1_train_step)

            params = resync_parameters(params, peer, comm=comm, root=rroot)
            step, init_opt = zero1_train_step(
                lambda p, b: model.loss(p, b), opt, comm)
            fresh = init_opt(params)
            # rank 0 passes the pre-resize snapshot, joiners None and
            # receive it over the host channel
            opt_state = (fresh if v == 0
                         else zero1_reshard(fresh, params, comm, peer,
                                            snapshot=z1_snap))
        else:
            tx = synchronous_sgd(opt, comm.axis)
            step = dp_train_step(lambda p, b: model.loss(p, b), tx, comm)
            # one re-sync for params and state: a joiner's fresh state is
            # structure, the root's weights and momentum win
            local_state = (opt_state if opt_state is not None
                           else tx.init(params))
            params, opt_state = resync_parameters(
                (params, local_state), peer, comm=comm, root=rroot)
        loss = None
        for xb, yb in epoch_batches(comm.size, ns.steps_per_epoch):
            batch = (torch.from_numpy(xb).to(device),
                     torch.from_numpy(yb).to(device))
            params, opt_state, loss = step(params, opt_state, batch)
        if ns.zero1:
            # over this epoch's membership, before the resize retires it
            z1_snap = zero1_snapshot(opt_state, peer)
        return float(loss)

    try:
        while time.time() < deadline:
            if peer.detached:
                break
            if peer.standby:
                try:
                    _, version = peer.observe_stage()
                except (OSError, ValueError, KeyError):
                    time.sleep(0.2)
                    continue
                if version >= shutdown_version:
                    break
                peer.await_rejoin(timeout=2.0)
                continue

            v = peer.cluster_version
            comm = peer.communicator()
            if ns.strategy and v == 0:
                # installed once; later epochs inherit it (Peer._retire_comm)
                comm.set_strategy(ns.strategy)
            if ns.autotune and v == 0:
                comm.autotune_strategy(nbytes=1 << 12, trials=1)
            # each worker contributes world_rank + 1, so the sum names
            # exactly the slots that took part
            x = torch.full((comm.addressable_n,), float(my_world_rank + 1),
                           dtype=torch.float32, device=device)
            got = float(comm.all_reduce(x)[0])
            expect = float(sum(world.rank(w) + 1
                               for w in peer.cluster.workers))
            ok = got == expect
            loss = train_epoch(comm, v) if (ns.train and ok) else None
            print(
                f"KFEPOCH v={v} size={peer.size()} rank={peer.rank()} "
                f"world_rank={my_world_rank} psum={got} expect={expect} "
                f"pid={os.getpid()} ok={ok} strategy={comm.strategy}"
                + (f" loss={loss:.17g}" if loss is not None else ""),
                flush=True,
            )
            if not ok:
                return 1

            if v + 1 < len(schedule):
                if peer.rank() == 0:
                    peer.propose_new_size(schedule[v + 1])
                # every active worker may fetch the old config and agree on
                # it: retry until this peer adopts the next stage (or goes
                # standby)
                while (peer.cluster_version <= v and not peer.standby
                       and time.time() < deadline):
                    peer.resize_cluster_from_url()
            else:
                if peer.rank() == 0:
                    # shutdown sentinel: re-PUT the final cluster to bump
                    # the version past the schedule, so standbys exit
                    peer.propose_new_size(peer.size())
                break
        else:
            print("KFERROR: timeout", flush=True)
            return 3
    finally:
        peer.close()
    print(f"KFDONE world_rank={my_world_rank} pid={os.getpid()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
