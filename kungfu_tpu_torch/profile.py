"""Where the time goes on the card: the flagship forward, a full-batch
decode step of the serving engine, and one flagship training step,
traced with ``torch.profiler``.

    python -m kungfu_tpu_torch.profile [--steps N] [--lm-head plain|fused]
                                       [--ranks R] [--zero 0|1|2|3]
                                       [--model gpt_small|bert]
                                       [--optimizer ssgd|sma|gns|variance]
                                       [--out FILE]

For each phase it prints (and writes as JSON to ``--out``): host wall
time per call, device busy time per call (the sum of the CUDA kernel
durations the profiler recorded), the device's idle share of the wall
time, and the device time by kernel family (the hand-written flash,
cross-entropy and LM-head kernels, matrix products, everything else)
with the top kernels by name.  Random weights from seed 0 at the
flagship's full width; the training step is chip_smoke.py's (ids
[4, 2048], flash attention, ``dp_train_step`` with
``synchronous_sgd(sgd(0.05, momentum=0.9))``) with the plain head and
the fused cross-entropy (``--lm-head plain``, the default) or the fused
LM head (``--lm-head fused``).  ``--ranks R`` runs that step on ``R``
co-resident ranks of the card, one batch row each: ``synchronous_sgd``
under the ``pallas_ring`` schedule with fused gradients, or with
``--zero S`` the ZeRO stage ``S`` step under the ``pallas_ring`` bucket
schedule (chip_smoke.py's phases 8 and 9).  ``--model bert`` trains
``bert_base()`` instead (chip_smoke.py's phase 10: 8 x 512 tokens a
rank, flash attention without a mask, the plain head and the fused
cross-entropy, ``sgd(1e-3, momentum=0.9)`` inside ``--optimizer``:
``sma`` is ``synchronous_averaging`` over stacked per-replica params,
``gns`` and ``variance`` the monitors, ``ssgd`` plain
``synchronous_sgd``).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


def _family(name: str) -> str:
    low = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                   "xent_bwd", "lm_head_fwd", "lm_head_bwd_dh",
                   "lm_head_bwd_dw", "lm_head_split", "ring_rs",
                   "ring_ag"):
        if kernel in low:
            return f"{kernel} (hand-written)"
    # f32 products run on the CUDA cores (TF32 off): in the flagship
    # these are the LM head's (bf16 features promote against f32 weights)
    if any(t in low for t in ("sgemm", "simt", "f32f32", "ffma")):
        return "matmul f32 (cuBLAS: the LM head)"
    if any(t in low for t in ("gemm", "cutlass", "xmma", "cublas", "matmul",
                              "nvjet")):
        return "matmul bf16 (cuBLAS)"
    return "other (elementwise, reductions, copies, gathers)"


def _profile(torch, fn, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    launches = collections.Counter()
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dur = evt.time_range.elapsed_us()
            by_name[evt.name] += dur
            launches[evt.name] += 1
    busy_us = sum(by_name.values())
    families = collections.Counter()
    for name, us in by_name.items():
        families[_family(name)] += us
    return {
        "wall_ms_per_call": wall_us / steps / 1e3,
        "device_busy_ms_per_call": busy_us / steps / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
        "kernels_per_call": sum(launches.values()) / steps,
        "device_ms_by_family": {k: v / steps / 1e3
                                for k, v in families.most_common()},
        "top_kernels_ms": [(n[:90], us / steps / 1e3, launches[n] // steps)
                           for n, us in by_name.most_common(8)],
    }


def _train_step(torch, rng, lm_head: str, ranks: int = 1, zero: int = 0):
    """One flagship training step as a closure over its carried state;
    ``lm_head`` picks the plain head + fused xent or the fused head,
    ``ranks`` the co-resident ranks and ``zero`` the ZeRO stage."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.models.transformer import gpt_small
    from kungfu_tpu_torch.ops.cuda.attention import make_flash_attn
    from kungfu_tpu_torch.ops.lm_head import lm_head_nll
    from kungfu_tpu_torch.ops.xent import softmax_cross_entropy
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step
    from kungfu_tpu_torch.parallel.zero import zero_train_step

    model = gpt_small(max_seq=2048)
    flash = make_flash_attn()
    batch = tuple(torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, size=(4, 2048))).cuda() for _ in range(2))

    def loss_fn(p, b):
        if lm_head == "fused":
            h = model.hidden(p, b[0], train=True, attn_fn=flash)
            return lm_head_nll(h, p["head"]["w"], b[1]).mean()
        return softmax_cross_entropy(
            model.apply(p, b[0], train=True, attn_fn=flash), b[1]).mean()

    comm = Communicator(devices=["cuda:0"] * ranks, local_size=ranks)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    if zero:
        step = zero_train_step(loss_fn, sgd(0.05, momentum=0.9), comm,
                               stage=zero, schedule="pallas_ring")
        state = [step.init_params(params), step.init_opt(params)]
    else:
        schedule = "pallas_ring" if ranks > 1 else "psum"
        tx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis,
                             schedule=schedule, fuse_grads=ranks > 1)
        step = dp_train_step(loss_fn, tx, comm)
        state = [params, tx.init(params)]

    def run():
        state[0], state[1], _ = step(state[0], state[1], batch)

    return run


def _bert_step(torch, rng, ranks: int, optimizer: str):
    """One ``bert_base()`` training step of chip_smoke.py's phase 10 on
    ``ranks`` co-resident ranks (8 x 512 tokens each) under
    ``optimizer``, as a closure over its carried state."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.models.transformer import bert_base
    from kungfu_tpu_torch.ops.cuda.attention import make_flash_attn
    from kungfu_tpu_torch.ops.xent import softmax_cross_entropy
    from kungfu_tpu_torch.optimizers import (monitor_gradient_noise_scale,
                                             monitor_gradient_variance, sgd,
                                             synchronous_averaging,
                                             synchronous_sgd)
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 stack_for_replicas)

    model = bert_base()
    flash = make_flash_attn()
    batch = tuple(torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, size=(8 * ranks, 512))).cuda()
        for _ in range(2))

    def loss_fn(p, b):
        return softmax_cross_entropy(
            model.apply(p, b[0], train=True, attn_fn=flash), b[1]).mean()

    comm = Communicator(devices=["cuda:0"] * ranks, local_size=ranks)
    inner = sgd(1e-3, momentum=0.9)
    tx = {"ssgd": lambda: synchronous_sgd(inner, comm.axis),
          "sma": lambda: synchronous_averaging(inner, comm.axis, alpha=0.1),
          "gns": lambda: monitor_gradient_noise_scale(inner, comm.axis,
                                                      local_batch_size=8),
          "variance": lambda: monitor_gradient_variance(inner, comm.axis),
          }[optimizer]()
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    stacked = optimizer == "sma"
    step = dp_train_step(loss_fn, tx, comm, replicated_params=not stacked)
    state = [params, tx.init(params)]
    if stacked:
        state = [stack_for_replicas(t, ranks) for t in state]

    def run():
        state[0], state[1], _ = step(state[0], state[1], batch)

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lm-head", choices=("plain", "fused"), default="plain",
                    help="head of the training step")
    ap.add_argument("--ranks", type=int, default=1,
                    help="co-resident ranks of the training step")
    ap.add_argument("--zero", type=int, choices=(0, 1, 2, 3), default=0,
                    help="ZeRO stage of the training step (0: S-SGD)")
    ap.add_argument("--model", choices=("gpt_small", "bert"),
                    default="gpt_small", help="model of the training step")
    ap.add_argument("--optimizer", choices=("ssgd", "sma", "gns", "variance"),
                    default="ssgd",
                    help="distributed optimizer of the bert step")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from kungfu_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    from kungfu_tpu_torch.serve.engine import InferenceEngine

    cfg = TransformerConfig(vocab_size=32128, d_model=768, n_layers=12,
                            n_heads=12, d_ff=3072, max_seq=512, causal=True,
                            pos="rope", dtype="bfloat16")
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 256))).cuda()
    out = {"device": torch.cuda.get_device_name(0)}

    with torch.inference_mode():
        out["forward_4x256"] = _profile(
            torch, lambda: model.apply(params, ids), args.steps)
        engine = InferenceEngine(model, params, max_batch=8, max_seq=512)
        for i in range(8):
            engine.submit(f"r{i}",
                          rng.integers(0, cfg.vocab_size, size=128).tolist(),
                          256)
        while engine.pending_count:
            engine.step()  # admit all eight (one prefill per step)
        out["decode_step_batch8"] = _profile(torch, engine.step, args.steps)
    del engine, params
    if args.model == "bert":
        label = (f"train_step_bert_{8 * args.ranks}x512_{args.optimizer}_"
                 f"{args.ranks}_ranks")
        run = _bert_step(torch, rng, args.ranks, args.optimizer)
    else:
        label = f"train_step_4x2048_{args.lm_head}_head"
        if args.ranks > 1:
            label += f"_{args.ranks}_ranks_" + (
                f"zero{args.zero}" if args.zero else "ssgd_pallas_ring")
        run = _train_step(torch, rng, args.lm_head, args.ranks, args.zero)
    out[label] = _profile(torch, run, args.steps)

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
