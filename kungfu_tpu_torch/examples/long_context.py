"""Long-context training: sequence parallelism with ring attention (port
of ``examples/long_context.py``).

The sequence axis is sharded over an ``sp`` ring of co-resident ranks;
each rank holds S/sp tokens and the K/V blocks rotate by ``ppermute``
(:mod:`kungfu_tpu_torch.parallel.ring`).  On the card each rotation's
block runs through the flash kernels (``block_impl=auto``), so a rank's
attention memory is one kernel tile: the sequence length is limited by
the activations kept for the backward, not by the S^2 scores.

Run::

    python -m kungfu_tpu_torch.examples.long_context --sp 4 --seq-len 512 --cpu-devices 8
    python -m kungfu_tpu_torch.examples.long_context --sp 4 --seq-len 32768

The first runs on eight CPU ranks, the second on ``sp`` ranks of the
card.  Trains a small causal LM on synthetic tokens and checks the
sharded loss against the one-rank dense loss at the start (exactness is
the point of ring attention: it is dense attention, distributed); the
check needs the O(S^2) scores, so it runs below 4096 tokens only.
"""

from __future__ import annotations

import argparse
import sys
import time

#: the dense check materializes [B, H, S, S] scores: only below this
DENSE_CHECK_BELOW = 4096


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sp", type=int, default=4, help="ring size (mesh sp axis)")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="N co-resident CPU ranks (demo mode)")
    p.add_argument("--block-impl", default="auto",
                   choices=["auto", "flash", "einsum"])
    return p.parse_args(argv)


def devices_of(args) -> list:
    """The ranks' devices: ``--cpu-devices`` CPU ranks, else ``sp`` ranks
    of the card (raises without one)."""
    from kungfu_tpu_torch.utils.device import resolve_device

    if args.cpu_devices:
        return [resolve_device("cpu")] * args.cpu_devices
    return [resolve_device(None)] * args.sp


def build(args, device):
    """The example's model, its params (seed 0) and the synthetic batch
    ``(ids, targets)`` ``[B, S]`` on ``device``."""
    import numpy as np
    import torch

    from kungfu_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)

    cfg = TransformerConfig(
        vocab_size=1024, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=max(2, args.d_model // 64), d_ff=args.d_model * 4,
        max_seq=args.seq_len, causal=True, pos="learned",
        dtype="float32" if device.type == "cpu" else "bfloat16",
    )
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch_size, args.seq_len))
    ).to(device)
    return model, params, ids, torch.roll(ids, -1, dims=1)


def ring_attn(sp: int, block_impl: str = "auto"):
    """The model's ``attn_fn`` over the ``sp`` ranks: the batch rows
    arrive rank-major (``[sp * B, H, S/sp, D]``) and go through
    :func:`~kungfu_tpu_torch.parallel.ring.make_ring_attn` stacked
    ``[sp, B, H, S/sp, D]``."""
    from kungfu_tpu_torch.parallel.ring import make_ring_attn

    ring = make_ring_attn(axis="sp", block_impl=block_impl)

    def attn(q, k, v, causal):
        nb, h, s, d = q.shape
        shape = (sp, nb // sp, h, s, d)
        out = ring(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                   causal)
        return out.reshape(nb, h, s, d)

    return attn


def sharded_loss(model, params, ids, targets, sp: int, attn):
    """The mean next-token loss with the sequence sharded over ``sp``
    ranks: rank ``j`` holds tokens ``[j*S/sp, (j+1)*S/sp)`` at their
    global positions.  The global mean NLL is the mean of the ranks'
    equal-size shard means; the ranks share one params tree, so the
    gradient sums their contributions, as the reference's ``shard_map``
    with replicated params does."""
    import torch

    from kungfu_tpu_torch.ops import collective

    B, S = ids.shape
    s_loc = S // sp

    def shard(x):  # [B, S] -> rank-major rows [sp * B, S/sp]
        return x.reshape(B, sp, s_loc).transpose(0, 1).reshape(sp * B, s_loc)

    pos = (torch.arange(sp, device=ids.device)[:, None] * s_loc
           + torch.arange(s_loc, device=ids.device))
    positions = pos[:, None, :].expand(sp, B, s_loc).reshape(sp * B, s_loc)
    with collective.rank_world([("sp", sp)]):
        return model.loss(params, (shard(ids), shard(targets)),
                          attn_fn=attn, positions=positions)


def train_step(model, opt, sp: int, attn):
    """One Adam step of :func:`sharded_loss`: ``step(params, opt_state,
    ids, targets) -> (params, opt_state, loss)``."""
    from kungfu_tpu_torch.examples.mnist_slp import loss_and_grads
    from kungfu_tpu_torch.optimizers import apply_updates

    def step(params, opt_state, ids, targets):
        loss, grads = loss_and_grads(
            lambda p, b: sharded_loss(model, p, b[0], b[1], sp, attn),
            params, (ids, targets))
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step


def main(argv=None, report=None) -> int:
    """``report``, a dict when given, receives the run's figures: the
    dense check's pair, every step's loss (the warm-up's first), the
    timed steps' seconds and tokens a second."""
    args = parse_args(argv)

    import torch

    from kungfu_tpu_torch.optimizers import adam

    devs = devices_of(args)
    if len(devs) < args.sp:
        print(f"need {args.sp} devices, have {len(devs)} "
              f"(use --cpu-devices {args.sp})", file=sys.stderr)
        return 1
    if args.seq_len % args.sp:
        print("--seq-len must divide by --sp", file=sys.stderr)
        return 1

    model, params, ids, targets = build(args, devs[0])
    cfg = model.cfg
    attn = ring_attn(args.sp, args.block_impl)
    report = {} if report is None else report

    # exactness check: the sharded ring loss IS the dense loss.  The
    # dense reference materializes [B, H, S, S] scores, so it is gated:
    # at the sequence lengths this demo exists for, the check itself
    # would exhaust the card's memory
    if args.seq_len < DENSE_CHECK_BELOW:
        with torch.no_grad():
            ref = float(model.loss(params, (ids, targets)))
            got = float(sharded_loss(model, params, ids, targets, args.sp,
                                     attn))
        report["dense_check"] = (got, ref)
        print(f"loss check: ring={got:.6f} dense={ref:.6f}")
        assert abs(got - ref) < max(1e-4, 2e-3 * abs(ref)), (got, ref)
    else:
        gib = 4 * args.batch_size * cfg.n_heads * args.seq_len**2 / 2**30
        print(f"loss check skipped: dense reference needs the O(S^2) "
              f"scores (~{gib:.0f} GiB at S={args.seq_len})")

    opt = adam(1e-3)
    opt_state = opt.init(params)
    step = train_step(model, opt, args.sp, attn)

    # untimed warm-up step: builds the kernels' first launches so tok/s
    # reports the steady state
    params, opt_state, loss = step(params, opt_state, ids, targets)
    first = last = float(loss)
    losses = [first]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt_state, loss = step(params, opt_state, ids, targets)
        last = float(loss)
        losses.append(last)
    dt = time.perf_counter() - t0
    tok_s = args.batch_size * args.seq_len * args.steps / dt
    report.update(losses=losses, step_s=dt / max(args.steps, 1), tok_s=tok_s)
    print(f"trained {args.steps} steps: loss {first:.4f} -> {last:.4f} "
          f"({tok_s:,.0f} tok/s, sp={args.sp}, S={args.seq_len})")
    assert last < first, "loss did not decrease"
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
