"""``-restore-from`` — cold-restart supervision over the durable
manifest plane (port of ``kungfu_tpu/runner/supervise.py``).

MonitoredRun (``runner/monitored.py``) survives *partial* failures by
heartbeat detection and epoch-checkpoint replay; it is useless against a
whole-job preemption, where every worker (and every heartbeat source)
dies in the same instant.  PersistRun covers that case with the weakest
possible machinery: it knows nothing about epochs, detectors, or worker
health — only exit codes and the manifest directory.

Policy per round:

* every worker exits 0 → the job finished; success.
* every worker exits :data:`~kungfu_tpu_torch.chaos.inject.DIE_EXIT_CODE`
  (the injected/real preemption code) AND a complete manifest exists
  under the persist root → relaunch the whole group.  Workers come up
  with ``KF_PERSIST_RESTORE=1`` already set, agree on the newest
  complete manifest (``PersistPlane.agree_manifest``), and resume from
  it — onto whatever world size THIS launch has, because restore is
  pure ``reshard_plan`` re-carving.
* anything else (mixed codes, a crash that is not a preemption, no
  restorable manifest) → fail; supervision must not paper over bugs.

Relaunches strip ``preempt`` clauses from the workers' ``KF_CHAOS_SPEC``
— the chaos preemption models ONE eviction event; replaying it every
round would preempt the job forever and the goodput experiment would
never terminate.  Other clauses (delay, reset, …) survive the restart,
as real background faults would.
"""

from __future__ import annotations

from typing import List

from kungfu_tpu_torch.chaos.inject import DIE_EXIT_CODE
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.runner.job import Job
from kungfu_tpu_torch.runner.proc import run_all
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("persist-run")

#: relaunch budget — a job that gets preempted more often than this is
#: not making progress worth supervising (mirrors monitored.MAX_RESTARTS)
MAX_RELAUNCHES = 16


def strip_preempt(spec: str) -> str:
    """Drop ``preempt`` clauses from a raw ``KF_CHAOS_SPEC`` string,
    preserving every other clause verbatim (the spec round-trips
    textually — no parse/re-serialize drift)."""
    kept: List[str] = []
    for part in spec.split(";"):
        clause = part.strip()
        if not clause:
            continue
        kind = clause.split(":", 1)[0].strip()
        if kind == "preempt":
            continue
        kept.append(clause)
    return ";".join(kept)


def persist_run(ns, cluster: Cluster, job: Job) -> int:
    from kungfu_tpu_torch.chaos import SPEC_ENV
    from kungfu_tpu_torch.elastic.persist import newest_complete_manifest
    from kungfu_tpu_torch.utils import envs

    root = job.extra_envs.get(envs.PERSIST_DIR, "")
    relaunches = 0
    while True:
        procs = job.create_procs(cluster, ns.self_host)
        if not procs:
            _log.warning("no workers for host %s", ns.self_host)
            return 0
        _log.info(
            "round %d: launching %d/%d workers (persist root %s)",
            relaunches, len(procs), cluster.size(), root,
        )
        # fail_fast off: a preemption kills every rank at the same step
        # boundary, but wall-clock skew means the first death must not
        # SIGTERM the rest — their own exit codes (43 vs crash) are the
        # evidence this supervisor decides on
        codes = run_all(procs, quiet=ns.quiet, timeout=ns.timeout or None,
                        fail_fast=False)
        if all(c == 0 for c in codes):
            _log.info("training finished")
            return 0
        if not all(c == DIE_EXIT_CODE for c in codes):
            _log.error(
                "workers failed with non-preemption codes %s — not "
                "relaunching (a crash is a bug, not an eviction)", codes,
            )
            return 1
        newest = newest_complete_manifest(root) if root else None
        if newest is None:
            _log.error(
                "whole job preempted (codes %s) but no complete manifest "
                "under %r — nothing durable to restart from", codes, root,
            )
            return 1
        relaunches += 1
        if relaunches > MAX_RELAUNCHES:
            _log.error("giving up after %d relaunches", MAX_RELAUNCHES)
            return 1
        spec = job.extra_envs.get(SPEC_ENV, "")
        if spec:
            stripped = strip_preempt(spec)
            if stripped != spec:
                if stripped:
                    job.extra_envs[SPEC_ENV] = stripped
                else:
                    del job.extra_envs[SPEC_ENV]
                _log.info("chaos spec after preemption: %r",
                          stripped or "(cleared)")
        _log.warning(
            "whole job preempted; relaunching round %d from manifest %s",
            relaunches, newest,
        )
