"""kf-pipeline demo: 1F1B over async handles, then an elastic stage merge
(port of ``examples/pp_demo.py``).

Two ranks in this process form a 2-stage cross-DCN pipeline (each rank
one emulated slice; chaos injects 30 ms on every send, so every hop is a
DCN hop).  The drill:

1. train the same steps under the naive sequential schedule and under
   1F1B: the schedules must give bitwise-identical params (the schedule
   moves wall clock only), and 1F1B must be measurably faster;
2. commit the stage boundary, ring-mirror it, and run a planned 2 -> 1
   stage merge (the leaving stage serves its spans): the merged
   single-stage world restores bitwise.

Run: ``python -m kungfu_tpu_torch.examples.pp_demo``.  As the
reference's demo, it runs on the host (``KF_JAX_PLATFORM=cpu`` unless
the caller set it); ``KF_JAX_PLATFORM=gpu`` puts the stages on the card.
"""

from __future__ import annotations

import argparse
import os
import time

#: the demo's environment, where the caller has not set it
ENV_DEFAULT = {"KF_NATIVE_ENGINE": "0", "KF_CONFIG_LOG_LEVEL": "WARNING",
               "KF_CHAOS_SPEC": "delay:ms=30,on=send",
               "KF_JAX_PLATFORM": "cpu", "KF_TPU_HOST_TRANSPORT": "python"}
STEPS = 3


def config():
    from kungfu_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=96, d_model=32, n_layers=4,
                             n_heads=2, d_ff=64, max_seq=16, dtype="float32")


def batch():
    """The seeded ``(ids, targets)`` ``[8, 16]`` int32."""
    import numpy as np

    cfg = config()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return ids, tgt


def lockstep_steps(pipes, ids, tgt, steps):
    """``steps`` lockstep train steps of every pipe on its own thread:
    ``(wall seconds a step, the last step's outputs)``."""
    from kungfu_tpu_torch.examples._local import run_world

    walls, outs = [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        outs = run_world([lambda p=p: p.train_step(ids, tgt) for p in pipes],
                         timeout=300)
        walls.append(time.perf_counter() - t0)
    return walls, outs


def flat_of(tree):
    """Every leaf of ``tree`` raveled into one host f32 vector."""
    import numpy as np

    from kungfu_tpu_torch.utils.tree import tree_leaves

    return np.concatenate([l.detach().cpu().float().numpy().ravel()
                           for l in tree_leaves(tree)])


def schedules(full, ids, tgt, on_1f1b=None) -> tuple:
    """``STEPS`` steps of the 2-stage pipeline from ``full`` under each
    schedule: ``(finals, times)``, each stage's params and the best warm
    step's seconds by schedule.  ``on_1f1b(peers, pipes)`` runs on
    the 1F1B world before its peers close."""
    from kungfu_tpu_torch.examples._local import close_all, local_peers
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel import pp
    from kungfu_tpu_torch.parallel.train import ParallelPlan

    finals, times = {}, {}
    for sched in ("sequential", "1f1b"):
        plan = ParallelPlan(pp=2, n_micro=4, pp_schedule=sched)
        peers = local_peers(2, env={"KF_ALLREDUCE_STRATEGY": "STAR"})
        try:
            pipes = [pp.HostPipeline(p.engine(), plan, config(),
                                     full_params=full, inner=sgd(0.125),
                                     peer=p, device=p.device())
                     for p in peers]
            walls, _ = lockstep_steps(pipes, ids, tgt, steps=STEPS)
            times[sched] = min(walls[1:])  # drop the first step
            finals[sched] = [pipe.params[0] for pipe in pipes]
            if sched == "1f1b" and on_1f1b is not None:
                on_1f1b(peers, pipes)
        finally:
            close_all(peers)
    return finals, times


def stage_merge(peers, pipes) -> None:
    """Commit and ring-mirror the stage boundary, then the planned 2 -> 1
    stage merge (rank 1 leaves): the merged world restores bitwise."""
    import numpy as np

    from kungfu_tpu_torch.examples._local import run_world
    from kungfu_tpu_torch.parallel import pp

    cfg = config()
    sbs = [pp.StageBoundary() for _ in pipes]
    for pipe, sb in zip(pipes, sbs):
        pipe.commit_boundary(sb)

    def together(fn):
        run_world([lambda i=i: fn(i) for i in range(len(peers))], timeout=60)

    workers = peers[0].cluster.workers
    together(lambda i: sbs[i].replicate_ring(peers[i].channel,
                                             peers[i].cluster.workers,
                                             tag="demo"))
    nw = workers.select([0])
    together(lambda i: sbs[i].recarve(1, peer=peers[i], old_workers=workers,
                                      new_workers=nw, tag="demo"))
    _, n, params, _ = sbs[0].restore()
    merged = pp.merge_stage_trees(cfg, 2, 1,
                                  [pipes[0].params[0], pipes[1].params[0]])
    assert n == 1
    assert np.array_equal(flat_of(params), flat_of(merged)), \
        "stage merge is not bitwise"
    print("stage re-carve 2 -> 1: merged world restored bitwise from the "
          "boundary")


def main(argv=None, report=None) -> int:
    """``report``, a dict when given, receives each schedule's stage
    params and step seconds."""
    argparse.ArgumentParser().parse_args(argv)

    import numpy as np
    import torch

    from kungfu_tpu_torch.examples._local import scoped_env
    from kungfu_tpu_torch.parallel import pp
    from kungfu_tpu_torch.utils import envs
    from kungfu_tpu_torch.utils.device import resolve_device

    with scoped_env(default=ENV_DEFAULT):
        # the peers' device rule (Peer.device): the host under the
        # launcher's -backend cpu stamp, else the card
        device = resolve_device(
            "cpu" if os.environ.get(envs.JAX_PLATFORM) == "cpu" else None)
        full = pp.init_stacked_params(config(),
                                      torch.Generator().manual_seed(0),
                                      device=device)
        ids, tgt = batch()
        finals, times = schedules(full, ids, tgt, on_1f1b=stage_merge)

    assert all(np.array_equal(flat_of(a), flat_of(b)) for a, b in
               zip(finals["sequential"], finals["1f1b"])), \
        "schedules diverged: the schedule must move wall clock only"
    speedup = times["sequential"] / times["1f1b"]
    print(f"sequential step {1e3 * times['sequential']:.0f} ms, "
          f"1f1b step {1e3 * times['1f1b']:.0f} ms "
          f"-> {speedup:.2f}x, finals bitwise-identical")
    assert speedup > 1.1, f"1F1B did not beat sequential ({speedup:.2f}x)"
    print("pp-demo OK: 1F1B wins under injected DCN latency and the "
          "elastic stage merge is bitwise")
    if report is not None:
        report.update(finals=finals, times=times)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
