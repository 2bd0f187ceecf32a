"""4-axis sharded transformer training, dp / pp / sp / tp [+ MoE-EP]
(port of ``examples/shard_train.py``).

The showcase of the parallelism subsystem: a GPT-style model trained
with data, pipeline, sequence (ring attention) and tensor parallelism
in one step over the mesh's co-resident ranks, which run in lockstep on
a stacked rank axis (:class:`~kungfu_tpu_torch.parallel.ShardedTrainer`).
No launcher is needed::

    python -m kungfu_tpu_torch.examples.shard_train --dp 2 --sp 2 --tp 2 --steps 5 --cpu-devices 8

Without ``--cpu-devices`` the plan's ranks share the card.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--experts", type=int, default=0, help="MoE experts (0 = dense)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="N co-resident CPU ranks")
    return p.parse_args(argv)


def build(args):
    """``(plan, devices, trainer, batch)``: the plan's trainer (Adam
    1e-3) and the seeded ``(ids, targets)`` ``[batch, seq]``, or a
    ``SystemExit`` when the plan needs more ranks than there are."""
    import numpy as np
    import torch

    from kungfu_tpu_torch.models.transformer import TransformerConfig
    from kungfu_tpu_torch.optimizers import adam
    from kungfu_tpu_torch.parallel import MeshPlan, ShardedTrainer
    from kungfu_tpu_torch.utils.device import resolve_device

    plan = MeshPlan(dp=args.dp, pp=args.pp, sp=args.sp, tp=args.tp)
    devs = ([resolve_device("cpu")] * args.cpu_devices if args.cpu_devices
            else [resolve_device(None)] * plan.size)
    if plan.size > len(devs):
        raise SystemExit(
            f"plan {plan} needs {plan.size} devices, have {len(devs)}; "
            f"rerun with --cpu-devices {plan.size}")
    cfg = TransformerConfig(
        vocab_size=512, d_model=128, n_layers=2 * max(args.pp, 1), n_heads=4,
        d_ff=256, max_seq=args.seq, causal=True, pos="rope",
    )
    trainer = ShardedTrainer(cfg, plan, n_experts=args.experts,
                             tx=adam(1e-3), devices=devs)
    rng = np.random.default_rng(0)
    data = rng.integers(0, cfg.vocab_size, size=(args.batch, args.seq + 1))
    batch = (torch.from_numpy(data[:, :-1]), torch.from_numpy(data[:, 1:]))
    return plan, devs, trainer, batch


def train(trainer, state, batch, steps: int) -> list:
    """``steps`` trainer steps from ``state``; each step's loss, printed
    as it comes."""
    losses = []
    for step in range(steps):
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))
        print(f"step {step}: loss {losses[-1]:.4f}")
    return losses


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    plan, devs, trainer, batch = build(args)
    state = trainer.init(torch.Generator().manual_seed(0))
    print(f"mesh {plan} over {plan.size}/{len(devs)} devices; "
          f"{'moe' if args.experts else 'dense'} ffn")
    losses = train(trainer, state, batch, args.steps)
    if args.steps > 1 and not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not improve: {losses[0]:.4f} -> "
                         f"{losses[-1]:.4f}")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
