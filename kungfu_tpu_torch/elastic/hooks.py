"""Elastic train-loop driver (port of ``kungfu_tpu/elastic/hooks.py``).

Parity with reference ``KungFuElasticTrainHook`` (``hooks/elastic.py:14-87``)
and the policy hooks: once per training step the loop (1) re-syncs the
global step by allreduce-MAX, (2) proposes the scheduled cluster size,
(3) runs the resize protocol, and (4) after a membership change
re-broadcasts params from rank 0 and re-syncs the step — or stops if this
worker was detached.

New workers spawned mid-job by the watch runner join at the new cluster
version; their *initial* ``broadcast_parameters`` call (named by cluster
version) rendezvouses with the survivors' *re*-broadcast, so state flows
to them without a checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from kungfu_tpu_torch.chaos import note_step as _chaos_note_step
from kungfu_tpu_torch.elastic.schedule import step_based_schedule
from kungfu_tpu_torch.initializer import broadcast_parameters
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.signals import monitor_compile_grace
from kungfu_tpu_torch.utils.log import get_logger, log_event

_log = get_logger("elastic")


@dataclass
class ElasticState:
    step: int = 0
    detached: bool = False
    resized: int = 0  # number of membership changes survived


def sync_step(peer, step: int) -> int:
    """Cluster-wide step = MAX over workers (reference
    ``hooks/elastic.py:33,50-52``) — new joiners jump to the global step."""
    engine = peer.engine()
    if engine is None:
        return step
    # auto-named (engine sequence numbers): a joiner's first sync must
    # rendezvous with the survivors' Nth — names must not embed the step
    out = engine.all_reduce(np.array([step], np.int64), op="max")
    return int(out[0])


def elastic_step(
    peer,
    state: ElasticState,
    schedule: Optional[str],
    params,
    zero_boundary=None,
    bandit=None,
) -> Tuple[ElasticState, object, bool]:
    """Run once per completed training step.

    Returns ``(new_state, params, should_stop)``; ``params`` are re-broadcast
    when membership changed.

    ``bandit`` (a kf-adapt driver, the reference's
    ``monitor/adapt_device.py``, ROADMAP A2b item 7) gets ``on_membership_change()`` after a resize: bandit state survives
    the resize by *re-exploring* — a 4-rank arm table says nothing about
    the 2-rank regime, so the measured winners are re-learned on the new
    membership instead of carried stale.

    Call order per training step is: local grads → gradient allreduce →
    apply → ``elastic_step``.  The step re-sync happens *first* here so a
    newly-joined worker (local step 0) jumps to the global step before the
    schedule is consulted — otherwise it would propose the schedule's
    step-0 size and shrink the cluster it just joined."""
    # fault injection rendezvous: `die:step=N` clauses fire here, at the
    # same step boundary on every rank (no-op unless KF_CHAOS_SPEC).
    # chaos_rank, not rank(): clause targeting survives rank reshuffles
    _chaos_note_step(peer.chaos_rank(), state.step)
    # note_step above already stamped the flight recorder's step counter;
    # the mark makes the step boundary itself visible in merged timelines
    timeline.event("step", f"step{state.step}", rank=peer.chaos_rank())
    step = sync_step(peer, state.step)
    target = step_based_schedule(schedule, step) if schedule else peer.size()
    changed = False
    old_workers = peer.cluster.workers  # pre-resize membership (recarve)
    if target != peer.size():
        log_event(f"proposing-resize-{peer.size()}->{target}-at-step-{step}")
        if peer.config.config_server:
            peer.propose_new_size(target)
            changed = peer.resize_cluster_from_url()
        else:
            _log.warning("no config server; cannot resize to %d", target)
    if changed:
        if zero_boundary is not None:
            # ZeRO-sharded optimizer state does not ride the params
            # broadcast (each rank holds 1/n): re-carve the committed
            # boundary leaderlessly for the new membership.  This runs
            # BEFORE the detach check — a planned resize's leavers are
            # alive and must serve their segments (nobody died, so no
            # ``dead`` set); survivors then restore the sharded state
            # with ``zero_boundary.place(new communicator)``.
            #
            # The exchange is symmetric: every NEW rank must be running
            # the same recarve.  elastic_step cannot arrange that for a
            # pure joiner (a fresh process sees `changed=False` here; a
            # rejoining standby adopted the cluster in await_rejoin) —
            # its side of the wiring is ZeroBoundary.join() + recarve
            # with the same memberships and tag, which only the
            # application can place in the joiner's startup path.
            # Proceeding would strand the joiner's segments in its
            # channel queue and leave it training on init_opt zeros, so
            # grows with unwired joiners fail loudly instead.
            joiners = [w for w in peer.cluster.workers
                       if old_workers.rank(w) is None]
            if joiners:
                raise ValueError(
                    f"elastic_step cannot re-carve ZeRO state through a "
                    f"grow with pure joiners ({len(joiners)} new "
                    "worker(s)): joiners must symmetrically run "
                    "ZeroBoundary.join() + recarve in their startup path, "
                    "or restore from a checkpoint")
            zero_boundary.recarve(
                peer.size(), peer=peer, old_workers=old_workers,
                new_workers=peer.cluster.workers,
                tag=f"v{peer.cluster_version}",
            )
        if peer.detached:
            log_event("detached-stopping")
            return replace(state, detached=True), params, True
        if bandit is not None:
            # survivors re-explore: the engines/communicators are rebuilt
            # for the new membership, so the measured arm tables reset
            # BEFORE any new-epoch window can be charged to a stale
            # winner.  After the detach check — a detached peer has no
            # engine in the new membership to re-anchor on
            bandit.on_membership_change(peer.cluster_version)
        log_event(f"resynced-after-resize-v{peer.cluster_version}")
        # the new cluster shape rebuilds the training step (a new
        # communicator, new buffers); tell the failure detector so the
        # next batch's stall allowance is compile-sized, not
        # heartbeat-sized (no-op when monitoring is off)
        monitor_compile_grace(peer.rank())
        # re-broadcast runs on the host channel (safe while the new engine
        # is cold).  Do NOT run an engine collective here: a joiner's first
        # engine op is its step's gradient allreduce, so the survivors'
        # first new-epoch engine op must be the same — alignment happens at
        # the top of the next elastic_step via sync_step.
        params = broadcast_parameters(params, peer)
        return (
            ElasticState(step=step + 1, resized=state.resized + 1),
            params,
            False,
        )
    return replace(state, step=step + 1), params, False
