"""GNS-driven elasticity: the monitor decides the cluster size (port of
``examples/gns_elastic.py``).

Every step the workers estimate the gradient noise scale over the host
collective plane, smooth it with an EMA and hand it to a
:class:`~kungfu_tpu_torch.policy.policies.GNSResizePolicy` driven by a
:class:`~kungfu_tpu_torch.policy.runner.PolicyRunner`: when the noise
scale says larger batches still help, the policy proposes a grow through
the config server and the elastic protocol re-carves the cluster, in one
run with no operator in the loop.

``--synthetic-gns`` substitutes a deterministic GNS ramp for the
measured value (the real estimator still runs and is printed): the
injection knob the end-to-end test uses; the monitor -> propose ->
resize pipeline it drives is the real one.

Run (grow 1 -> 2 when the noise scale rises)::

    python -m kungfu_tpu_torch -w -builtin-config-port 9332 \\
        -np 1 -H 127.0.0.1:2 python3 -m kungfu_tpu_torch.examples.gns_elastic \\
        -- --steps 10 --synthetic-gns 24,24,24,96,96,96,96,96,96,96
"""

from __future__ import annotations

import argparse


def grads_and_gns(model, params, batch, engine, batch_size: int):
    """The batch's loss and gradients, the gradients mean-allreduced over
    ``engine`` (when there is one), and the measured noise scale (0.0
    without an engine or on one worker): ``(loss, grads, gns_raw)``."""
    import torch

    from kungfu_tpu_torch.examples.mnist_slp import loss_and_grads
    from kungfu_tpu_torch.ops.fuse import defuse, fuse
    from kungfu_tpu_torch.ops.monitor import host_noise_scale

    loss, grads = loss_and_grads(model.loss, params, batch)
    gns_raw = 0.0
    if engine is not None:
        flat, spec = fuse(grads)
        local = flat.detach().cpu().numpy()
        red = engine.all_reduce(local, op="mean")
        grads = defuse(torch.from_numpy(red).to(flat.device), spec)
        # the real monitor: measured every step even when the run
        # injects a synthetic ramp
        gns = host_noise_scale(engine, local, red, batch_size)
        # one worker has no two-batch estimate (None): no signal, as
        # without an engine (the reference's example fails here on its
        # first, single-worker steps)
        gns_raw = 0.0 if gns is None else gns
    return loss, grads, gns_raw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--max-size", type=int, default=2)
    ap.add_argument("--synthetic-gns", default="",
                    help="comma list: per-step injected GNS values "
                         "(test/demo knob; empty = act on the measured EMA)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.examples.mnist_slp import synthetic_mnist
    from kungfu_tpu_torch.initializer import broadcast_parameters
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.optimizers import apply_updates, sgd
    from kungfu_tpu_torch.policy import GNSResizePolicy, PolicyRunner

    peer = kf.init()
    device = peer.device()
    rank = kf.current_rank()
    print(f"worker {rank}/{kf.cluster_size()} up (v{peer.cluster_version})",
          flush=True)

    model = mnist_slp()
    params = broadcast_parameters(
        model.init(torch.Generator().manual_seed(5), device=device), peer)
    x, y = synthetic_mnist()
    opt = sgd(args.lr)
    opt_state = opt.init(params)

    policy = GNSResizePolicy(
        min_size=1, max_size=args.max_size, threshold=0.4, cooldown_steps=2
    )
    runner = PolicyRunner([policy], peer=peer, batch_size=args.batch_size)
    injected = (
        [float(v) for v in args.synthetic_gns.split(",")]
        if args.synthetic_gns else []
    )

    runner.before_train()
    ema, alpha = 0.0, 0.3
    while runner.ctx.step < args.steps:
        size, rank = kf.cluster_size(), kf.current_rank()
        lo = ((runner.ctx.step * size + rank) * args.batch_size) % (
            len(x) - args.batch_size
        )
        batch = (torch.from_numpy(x[lo:lo + args.batch_size]).to(device),
                 torch.from_numpy(y[lo:lo + args.batch_size]).long()
                 .to(device))
        engine = peer.engine()
        loss, grads, gns_raw = grads_and_gns(model, params, batch, engine,
                                             args.batch_size)
        ema = (1 - alpha) * ema + alpha * gns_raw
        step_gns = (
            injected[min(runner.ctx.step, len(injected) - 1)]
            if injected else ema
        )
        if engine is not None:
            # the acted-on signal must be identical on every rank (a
            # joiner's step counter / fresh EMA would otherwise drive a
            # divergent policy decision): adopt the cluster max
            step_gns = float(
                engine.all_reduce(
                    np.array([step_gns], np.float64), op="max", record=False
                )[0]
            )

        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)

        prev_size = peer.size()
        params, stop = runner.after_step(
            params, gradient_noise_scale=step_gns
        )
        if stop:
            print(f"worker {rank}: detached at step {runner.ctx.step}",
                  flush=True)
            kf.finalize()
            return 0
        if peer.size() != prev_size:
            opt_state = opt.init(params)
            print(
                f"worker {kf.current_rank()}: GNS-resized "
                f"{prev_size}->{peer.size()} at step {runner.ctx.step}",
                flush=True,
            )
        print(
            f"step {runner.ctx.step} rank {kf.current_rank()} size "
            f"{peer.size()} loss {float(loss):.4f} real_gns={gns_raw:.3f} "
            f"acted_on={step_gns:.3f}",
            flush=True,
        )
    runner.after_train()
    print(
        f"worker {kf.current_rank()}: done size={peer.size()} "
        f"steps={runner.ctx.step} OK",
        flush=True,
    )
    kf.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
