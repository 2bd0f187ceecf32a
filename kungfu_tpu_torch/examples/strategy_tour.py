"""Tour of the device-plane strategy stack on one model (port of
``examples/strategy_tour.py``).

1. ``autotune_strategy``: measure every allreduce schedule on this
   mesh and install the winner (the reference's AUTO, decided by the
   hardware).
2. Train with the chosen schedule in the step
   (``synchronous_sgd(schedule=comm.strategy)``).
3. ``DeviceStrategyDriver``: watch step times; a sustained regression
   re-tunes and rebuilds the step (here with an injected slowdown).
4. The same step under ZeRO-1 weight-update sharding
   (``zero1_train_step``): the same math, 1/n of the optimizer memory.

Run: ``python -m kungfu_tpu_torch.examples.strategy_tour --cpu-devices 8``
(eight CPU ranks); without ``--cpu-devices`` eight co-resident ranks
share the card.
"""

from __future__ import annotations

import argparse
import time

#: the co-resident ranks on the card: the reference's 8-device mesh
CARD_RANKS = 8


def build(comm):
    """``(params, batch, loss_fn)`` on ``comm``'s device: the MLP
    64 -> 32 -> 10 (seed 0), a seeded batch of 8 rows a rank, and its
    mean softmax cross-entropy."""
    import numpy as np
    import torch

    from kungfu_tpu_torch.models.mlp import MLP

    n = comm.size
    model = MLP([64, 32], num_classes=10, input_dim=64)
    params = model.init(torch.Generator().manual_seed(0), device=comm.device)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.standard_normal((8 * n, 64)).astype(
                 np.float32)).to(comm.device),
             torch.from_numpy(rng.integers(0, 10, 8 * n)).to(comm.device))
    return params, batch, model.loss


def make_step(comm, loss_fn):
    """S-SGD (momentum 0.9) with ``comm.strategy`` in the step:
    ``(step, tx)``."""
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step

    tx = synchronous_sgd(sgd(0.1, momentum=0.9), comm.axis,
                         schedule=comm.strategy)
    return dp_train_step(loss_fn, tx, comm), tx


def zero1(comm, loss_fn, params, batch, steps: int = 4):
    """``steps`` ZeRO-1 steps: ``(losses, opt_state, inner)``."""
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel import zero1_train_step

    inner = sgd(0.1, momentum=0.9)
    zstep, zinit = zero1_train_step(loss_fn, inner, comm)
    zopt = zinit(params)
    zp, losses = params, []
    for _ in range(steps):
        zp, zopt, zloss = zstep(zp, zopt, batch)
        losses.append(float(zloss))
    return losses, zopt, inner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="N co-resident CPU ranks")
    ap.add_argument("--steps", type=int, default=24)
    ns = ap.parse_args(argv)

    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.monitor import DeviceStrategyDriver
    from kungfu_tpu_torch.parallel.zero import opt_state_bytes

    comm = Communicator(devices=(["cpu"] * ns.cpu_devices if ns.cpu_devices
                                 else [None] * CARD_RANKS))
    n = comm.size
    params, batch, loss_fn = build(comm)

    # 1. measured AUTO
    winner = comm.autotune_strategy(nbytes=1 << 14, trials=2)
    print(f"[1] autotune over {n} devices installed: {winner}")

    # 2. the schedule goes into the step
    step, tx = make_step(comm, loss_fn)
    opt = tx.init(params)
    p = params

    # 3. adaptive re-tuning on step-time regression (slowdown injected
    # half-way so the demo always exercises the swap path)
    driver = DeviceStrategyDriver(comm, check_every=3, regression=1.4,
                                  consecutive=2, autotune_nbytes=1 << 12)
    loss = float("nan")
    for i in range(ns.steps):
        t0 = time.perf_counter()
        p, opt, loss = step(p, opt, batch)
        dt = time.perf_counter() - t0
        if ns.steps // 2 <= i < ns.steps - 4:
            dt += 0.05  # simulated interference
        if driver.observe(dt):
            step, tx = make_step(comm, loss_fn)
    print(f"[3] trained {ns.steps} steps, loss {float(loss):.4f}, "
          f"adaptive re-tunes: {driver.swaps}")

    # 4. ZeRO-1: the same math, sharded optimizer state
    zlosses, zopt, inner = zero1(comm, loss_fn, params, batch)
    full = opt_state_bytes(inner.init(params))
    per_dev = opt_state_bytes(zopt) // n
    print(f"[4] zero1 loss {zlosses[-1]:.4f}; optimizer state "
          f"{full} B replicated vs ~{per_dev} B per device (1/{n})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
