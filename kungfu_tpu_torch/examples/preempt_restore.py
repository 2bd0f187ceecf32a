"""Whole-job preemption -> durable cold restart onto a smaller world
(port of ``examples/preempt_restore.py``).

One file, two hats:

* ``--worker``: a ZeRO-style loop (identical per-rank gradients, sharded
  momentum, exact binary-fraction hyperparameters, so bitwise
  replayable).  Every step commits the momentum :class:`ZeroBoundary`
  and streams a manifest (momentum sharded per rank, params replicated)
  through a :class:`~kungfu_tpu_torch.elastic.persist.PersistPlane`.
  Under ``KF_PERSIST_RESTORE=1`` the ranks first agree on the newest
  complete manifest and resume from it, onto whatever world size this
  launch has.
* the demo (no flag): phase 1 launches 4 workers under
  ``-chaos 'preempt:all,step=3'``: every rank dies mid-run, the
  ``-restore-from`` supervisor sees every worker exit 43, finds a
  complete manifest and relaunches the group, which resumes and
  finishes.  Phase 2 cold-starts 2 workers from the same directory: the
  4-rank manifest re-carves onto the halved world.  The final params
  must equal a fixed-world replay bit for bit, or the demo exits 1.

Run::

    python3 -m kungfu_tpu_torch.examples.preempt_restore   # the demo: both phases

The workers are host-plane arithmetic only; ``--backend`` (default
``gpu``) is passed to the launcher.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

TOTAL = 32  # parameter count
LR, MOMENTUM = 0.125, 0.5  # exact binary fractions: bitwise-replayable
PHASE1_STEPS, PHASE2_STEPS = 6, 8
PREEMPT_STEP = 3


def grad_at(params: np.ndarray, step: int) -> np.ndarray:
    """Deterministic gradient, the same on every rank: the mean over
    ranks does not depend on the world size."""
    target = np.full(TOTAL, step * 0.125, np.float32)
    return (params - target).astype(np.float32)


def replay(n_steps: int) -> np.ndarray:
    """The fixed-world ground truth: plain momentum SGD."""
    params = np.arange(TOTAL, dtype=np.float32) / TOTAL
    m = np.zeros(TOTAL, np.float32)
    for t in range(n_steps):
        m = MOMENTUM * m + grad_at(params, t)
        params = params - np.float32(LR) * m
    return params


def worker(n_steps: int) -> None:
    os.environ.setdefault("KF_CONFIG_PEER_DEADLINE", "5")

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.persist import (PersistPlane,
                                                  agreed_manifest_path,
                                                  choose_manifest,
                                                  restore_from_manifest)
    from kungfu_tpu_torch.elastic.reshard import ZeroBoundary
    from kungfu_tpu_torch.utils import envs

    peer = kf.init()
    n, rank = kf.cluster_size(), peer.rank()
    knobs = envs.persist_knobs()
    root = knobs["dir"]
    assert root, "run me under the launcher's -persist-dir / -restore-from"
    # period 0: persist every committed step, so that the preemption
    # boundary has a fresh restore point
    plane = PersistPlane(root, rank, period_s=0.0)

    params = np.arange(TOTAL, dtype=np.float32) / TOTAL
    chunk = math.ceil(TOTAL / n)
    m_chunk = np.zeros(chunk, np.float32)
    boundary = ZeroBoundary()
    start = 0

    if knobs["restore"]:
        # every rank adopts rank 0's scan
        step, ver = (choose_manifest(root) if rank == 0 else (-1, -1))
        step, ver = plane.agree_manifest(
            peer.channel, peer.cluster.workers, rank, step, ver)
        mdir = agreed_manifest_path(root, step, ver)
        if mdir is not None:
            rs = restore_from_manifest(mdir, rank, n)
            params = rs.replicated["params"].numpy().astype(np.float32)
            m_chunk = rs.vec[0].numpy().copy()
            rs.install_into_boundary(boundary)
            start = rs.step + 1
            print(f"rank {rank}/{n}: restored step {rs.step} from "
                  f"{os.path.basename(mdir)} (persisted by "
                  f"{rs.meta['old_n']} ranks)", flush=True)
        else:
            print(f"rank {rank}/{n}: fresh start (no complete manifest)",
                  flush=True)

    for step in range(start, n_steps):
        chaos.note_step(peer.chaos_rank(), step)
        engine = peer.engine()
        g_chunk = np.asarray(engine.reduce_scatter(
            grad_at(params, step), op="mean", name=f"g{step}"))
        m_chunk = MOMENTUM * m_chunk + g_chunk
        padded = np.zeros(chunk * n, np.float32)
        padded[:TOTAL] = params
        p_chunk = padded[rank * chunk:(rank + 1) * chunk] \
            - np.float32(LR) * m_chunk
        params = np.asarray(engine.all_gather(p_chunk, name=f"p{step}")) \
            .reshape(-1)[:TOTAL].copy()
        boundary.commit_local(step, {"m": torch.from_numpy(m_chunk)},
                              total=TOTAL, old_n=n, my_old=rank)
        plane.commit(step, boundary,
                     replicated={"params": torch.from_numpy(params)})
    plane.persist_fence()
    plane.close()
    if peer.rank() == 0:
        print("FINAL " + json.dumps([float(x) for x in params]), flush=True)
    kf.finalize()


def _kfrun(np_, root: str, n_steps: int, backend: str,
           chaos_spec: str = "") -> str:
    import subprocess

    cmd = [sys.executable, "-m", "kungfu_tpu_torch", "-backend", backend,
           "-np", str(np_), "-restore-from", root]
    if chaos_spec:
        cmd += ["-chaos", chaos_spec]
    cmd += [sys.executable, "-m", "kungfu_tpu_torch.examples.preempt_restore",
            "--worker", "--n-steps", str(n_steps)]
    print(f"demo: {' '.join(cmd[2:])}", flush=True)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr)
    if out.returncode != 0:
        raise SystemExit(f"launcher phase failed: rc={out.returncode}")
    return out.stdout


def demo(backend: str) -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "manifests")
        # phase 1: 4 workers, the whole job preempted at step 3; the
        # supervisor relaunches from the newest complete manifest
        _kfrun(4, root, PHASE1_STEPS, backend,
               chaos_spec=f"preempt:all,step={PREEMPT_STEP}")
        # phase 2: a cold restart onto half the world from the same
        # directory
        text = _kfrun(2, root, PHASE2_STEPS, backend)
    finals = [ln for ln in text.splitlines() if "FINAL " in ln]
    if not finals:
        raise SystemExit("no FINAL line from phase 2")
    got = np.asarray(json.loads(finals[-1].split("FINAL ", 1)[1]),
                     np.float32)
    want = replay(PHASE2_STEPS)
    if not np.array_equal(got, want):
        raise SystemExit(
            f"restored run diverged from fixed-world replay:\n"
            f"  got  {got.tolist()}\n  want {want.tolist()}")
    print("PERSIST DEMO OK: preempt:all -> supervised relaunch -> "
          "4->2 cold restart, final params bitwise vs fixed-world replay",
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--n-steps", type=int, default=PHASE2_STEPS)
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.n_steps)
    else:
        demo(args.backend)


if __name__ == "__main__":
    main()
