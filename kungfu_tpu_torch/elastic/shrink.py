"""Shrink-to-survivors: in-flight peer-failure recovery.

Port of ``kungfu_tpu/elastic/shrink.py``.  The detector-driven relaunch
recovers from any failure, but a whole-job restart throws away every
surviving worker's warm state (built kernels, the pinned buffers, the
state on the card).  This module makes the restart the *last resort*
instead of the only mechanism:

1. a collective primitive exhausts its per-peer deadline and raises
   :class:`~kungfu_tpu_torch.comm.faults.PeerFailureError` (``comm/engine.py``);
2. each survivor **confirms** the dead set by pinging every current
   worker (the exception's rank is only a suspect — a peer blocked on
   the true victim times out toward an innocent neighbor);
3. the survivors run an **exclusion consensus** over the survivor peer
   list (the same ``consensus_bytes`` collective the resize protocol
   uses): everyone must propose the identical shrunk cluster + version;
4. quorum check — the survivors must be a strict majority of the
   current membership, otherwise :class:`QuorumLostError` (the caller
   escalates to the detector restart via
   :func:`~kungfu_tpu_torch.monitor.signals.monitor_report_down`);
5. the agreed cluster is applied through the **existing elastic propose
   path** (``Peer._propose``: runner notify, token fence, connection
   reset, mesh-epoch retirement), published to the config server so
   standby peers and watch runners observe it, and the caller replays
   from the last committed step boundary
   (:class:`kungfu_tpu_torch.checkpoint.StepSnapshot`).

Survivors that were blocked on the victim converge here within one
per-peer deadline of each other, so the consensus collective rendezvouses
without extra coordination.

**Multislice pods** (``MEGASCALE_NUM_SLICES`` > 1) run the same ladder at
*slice* granularity: the ping-confirmed dead set is
widened to whole slices (a partially-dead slice is excluded whole — its
live members get :class:`~kungfu_tpu_torch.comm.faults.SliceExcludedError`),
quorum is counted in slices with a lowest-slice tie-break at exactly
half, and the exclusion consensus runs over the surviving slices'
leaders with a relay to their members.  Single-slice jobs never touch
any of it.

A pipeline stage (``stage_boundary``, a
:class:`~kungfu_tpu_torch.parallel.pp.StageBoundary`) rides the same
ladder as rung 10: the surviving stages re-balance the layers over
themselves, a whole dead stage served from its predecessor's mirror.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from kungfu_tpu_torch.comm.faults import (PeerFailureError, QuorumLostError,
                                          SliceExcludedError)
from kungfu_tpu_torch.monitor import ledger, timeline
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.utils.log import get_logger, log_event

_log = get_logger("shrink")

#: ping-confirm budget per peer when probing the dead set
PROBE_TIMEOUT_S = 3.0

#: connect-ladder length for recovery-path sends (consensus / replay
#: broadcast): short, because these run exactly when peers are dying
_RECOVERY_SEND_RETRIES = 5


def find_dead_ranks(peer, suspects: Iterable[int] = (),
                    timeout: float = PROBE_TIMEOUT_S) -> List[int]:
    """Ranks of current workers whose endpoint no longer answers a ping.
    ``suspects`` (the blame carried by a ``PeerFailureError``) get a
    second confirming ping if the sweep found them alive — a victim can
    die between the collective failure and the sweep reaching it.

    One ping thread per peer: dead SYN-dropping hosts burn the full
    ``timeout``, and at pod scale a sequential sweep would serialize
    recovery latency behind each of them — the sweep is bounded at
    ~``timeout`` total, not ``timeout * n_dead`` (same head-of-line
    reasoning as the detector's parallel fan-out)."""
    import threading

    workers = peer.cluster.workers
    me = workers.rank(peer.config.self_id)

    def sweep(ranks: List[int]) -> List[int]:
        alive = [False] * len(ranks)

        def one(i, r):
            alive[i] = peer.channel.ping(workers[r], timeout=timeout)

        ts = [threading.Thread(target=one, args=(i, r), daemon=True)
              for i, r in enumerate(ranks)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout + 2.0)
        return [r for i, r in enumerate(ranks) if not alive[i]]

    # materialize ONCE: `suspects` may be a generator, and it is read
    # twice below (the timeline mark and the recheck filter) — iterating
    # a one-shot iterator twice would silently skip the confirming ping
    suspects = [s for s in suspects if s is not None]
    timeline.event("shrink", "ping-confirm", rank=me, suspects=suspects)
    dead = sweep([r for r in range(len(workers)) if r != me])
    recheck = [
        s for s in suspects
        if s != me and s not in dead and 0 <= s < len(workers)
    ]
    dead += sweep(recheck)
    return sorted(set(dead))


def _peer_slice_topology(peer):
    """The peer's current slice topology (None = single slice).  Guarded
    with ``getattr`` so hand-rolled peer doubles in tests — and any
    driver predating the multislice wiring — keep the rank-granular
    path unchanged."""
    fn = getattr(peer, "slice_topology", None)
    return fn() if callable(fn) else None


def expand_dead_to_slices(peer, topo, dead: Sequence[int]) -> List[int]:
    """Slice-granular death verdict: widen a ping-confirmed dead rank
    set to WHOLE slices.  A slice with every member dead is dead; a
    slice with some members dead is *degraded* — its survivors answer
    ping but have no within-slice mesh left, so the protocol excludes
    the whole slice rather than let a half-dead slice silently keep
    training.  Raises :class:`SliceExcludedError` when THIS peer's own
    slice is among them (the caller is alive but must stand down)."""
    from kungfu_tpu_torch.elastic.slices import slice_verdict

    workers = peer.cluster.workers
    me = workers.rank(peer.config.self_id)
    dead_slices, degraded = slice_verdict(dead, topo)
    excluded = dead_slices | degraded
    timeline.event("slice", "verdict", rank=me,
                   dead_slices=sorted(dead_slices),
                   degraded=sorted(degraded))
    if not excluded:
        return sorted(set(dead))
    if degraded:
        _log.warning(
            "slice(s) %s are PARTIALLY dead — degrading to excluded "
            "(a half-dead slice must not keep training)", sorted(degraded),
        )
    my_slice = topo.slice_of(me)
    if my_slice in excluded:
        timeline.event("slice", "self-excluded", rank=me, slice=my_slice)
        raise SliceExcludedError(
            my_slice, [r for r in dead if topo.slice_of(r) == my_slice])
    return sorted({r for s in excluded for r in topo.ranks_in(s)})


def _slice_consensus(peer, topo, payload: bytes, digest: str,
                     survivor_ranks: Sequence[int]) -> bool:
    """Exclusion consensus at slice granularity: one vote among the
    surviving slices' LEADERS over the control plane, then each leader
    relays the verdict to its own slice members.
    Slice members of a surviving slice are all alive by construction
    (any death degrades the slice to excluded), so the leader is always
    the slice's lowest rank."""
    workers = peer.cluster.workers
    me = workers.rank(peer.config.self_id)
    my_slice = topo.slice_of(me)
    surv_slices = sorted({topo.slice_of(r) for r in survivor_ranks})
    leader_ranks = [topo.leader_of(s) for s in surv_slices]
    leaders = workers.select(leader_ranks)
    timeline.event("slice", "leader-consensus", rank=me,
                   slices=surv_slices, digest=digest)
    ok = False
    if me in leader_ranks:
        try:
            # subgroup collective, not SPMD divergence: the participant
            # list IS `leaders`, and the guard admits exactly its
            # members — non-leaders rendezvous on the relay below
            ok = peer.channel.consensus_bytes(  # kflint: allow(collective-consistency)
                payload, leaders, name=f"kf.slice.{digest}",
                send_retries=_RECOVERY_SEND_RETRIES,
            )
        except (TimeoutError, ConnectionError, OSError) as e:
            _log.warning("slice-leader consensus did not converge: %s", e)
            ok = False
    if topo.ranks_per_slice == 1:
        return ok
    # relay: the leader broadcasts (verdict, payload) to its slice; a
    # member checks the payload against its OWN computed proposal so a
    # leader that agreed to a DIFFERENT shrunk cluster cannot drag its
    # slice along silently.  Name is digest- and slice-keyed: divergent
    # proposals and neighboring slices cannot cross-talk.
    members = workers.select(topo.ranks_in(my_slice))
    name = f"kf.slice.{digest}.s{my_slice}"
    verdict = (b"\x01" if ok else b"\x00") + payload
    try:
        if me == topo.leader_of(my_slice):
            peer.channel.broadcast_bytes(
                verdict, members, name,
                send_retries=_RECOVERY_SEND_RETRIES,
            )
            return ok
        blob = peer.channel.broadcast_bytes(None, members, name)
        return bool(blob) and blob[:1] == b"\x01" and blob[1:] == payload
    except (TimeoutError, ConnectionError, OSError) as e:
        _log.warning("slice verdict relay failed: %s", e)
        return False


def shrink_to_survivors(peer, dead_ranks: Sequence[int]) -> bool:
    """Evict ``dead_ranks`` by exclusion consensus among the survivors
    and apply the shrunk membership through the elastic propose path.

    Returns ``True`` on success (the peer's next ``engine()`` /
    ``communicator()`` call builds the shrunk epoch).  Returns ``False``
    when the survivors could not agree (divergent dead sets — e.g. a
    partition where each side sees the other down); the caller should
    escalate.  Raises :class:`QuorumLostError` when the survivors are
    not a strict majority of the current membership.
    """
    workers = peer.cluster.workers
    dead = sorted({r for r in dead_ranks if 0 <= r < len(workers)})
    if not dead:
        return False
    me = workers.rank(peer.config.self_id)
    if me is None or me in dead:
        raise ValueError("shrink_to_survivors must run on a surviving member")
    # kf-overlap fence, BEFORE exclusion consensus: every issued async
    # handle must settle first — handles toward the dead complete with
    # their typed PeerFailureError via the per-peer deadline (bounded,
    # cannot hang), and a handle left in flight would otherwise tangle
    # its old-epoch recvs with the consensus traffic and the rebuilt
    # engine.  _propose drains again, but by then the consensus has run;
    # the window must be empty before the first shrink collective.
    eng = getattr(peer, "_engine", None)
    if eng is not None:
        drained = eng.drain_async()
        if drained:
            timeline.event("shrink", "drain", rank=me, drained=drained)
    topo = _peer_slice_topology(peer)
    if topo is not None and topo.num_slices <= 1:
        # a job shrunk down to ONE surviving slice has its failure grain
        # back at ranks (there is no cross-slice mesh left to protect,
        # and treating the lone slice as excludable-whole would turn any
        # single death into a full stop) — run the classic rank ladder
        topo = None
    if topo is not None:
        # slice-granular: whole slices die together (partial death
        # degrades the slice to excluded; raises SliceExcludedError on
        # a surviving member of a degraded slice)
        dead = expand_dead_to_slices(peer, topo, dead)
    survivor_ranks = [r for r in range(len(workers)) if r not in dead]
    if topo is not None:
        # quorum is counted in SLICES: strict majority, or exactly half
        # holding the lowest slice id (the deterministic tie-break only
        # one partition side can satisfy) — the rule that makes the
        # canonical 2-slice pod's slice loss survivable at all
        from kungfu_tpu_torch.elastic.slices import slice_quorum_ok

        surv_slices = sorted({topo.slice_of(r) for r in survivor_ranks})
        if not slice_quorum_ok(surv_slices, topo):
            timeline.event("slice", "quorum-lost", rank=me,
                           survivors=len(surv_slices),
                           total=topo.num_slices)
            if me == min(survivor_ranks):
                from kungfu_tpu_torch.monitor.aggregator import \
                    post_control_if_enabled

                post_control_if_enabled(peer, "quorum-lost", dead=dead,
                                        survivors=len(surv_slices))
            raise QuorumLostError(len(surv_slices), topo.num_slices)
    # strict majority: a minority partition must NOT shrink-and-continue
    # (two half-clusters training independently is silent divergence,
    # worse than a restart) — it falls back to the detector instead
    elif 2 * len(survivor_ranks) <= len(workers):
        timeline.event("shrink", "quorum-lost", rank=me,
                       survivors=len(survivor_ranks), total=len(workers))
        if me == min(survivor_ranks):
            from kungfu_tpu_torch.monitor.aggregator import post_control_if_enabled

            # the operator's "full restart incoming" signal on kftop
            post_control_if_enabled(peer, "quorum-lost", dead=dead,
                                    survivors=len(survivor_ranks))
        raise QuorumLostError(len(survivor_ranks), len(workers))

    survivors = workers.select(survivor_ranks)
    new_cluster = Cluster(peer.cluster.runners, survivors)
    version = peer.cluster_version + 1
    payload = new_cluster.digest() + version.to_bytes(8, "little")
    # consensus over the SURVIVOR list: the gather root is the lowest
    # surviving rank, so a dead rank 0 cannot wedge the vote.  Divergent
    # dead sets mean divergent survivor lists — the vote then either
    # disagrees on the payload or never rendezvouses at all (recv
    # timeout); both are "no agreement", not a crash.
    #
    # The rendezvous name is keyed by the PAYLOAD DIGEST, not just the
    # version: a failed round can leave its messages queued (the version
    # only bumps on success), and a version-keyed retry would consume
    # that stale round's bytes.  Digest-keying makes divergent proposals
    # miss each other entirely (timeout → contained below) and makes any
    # leftover same-name message byte-identical to the live one — stale
    # equals fresh, so it cannot poison the vote.
    import hashlib

    digest = hashlib.blake2b(payload, digest_size=8).hexdigest()
    timeline.event("shrink", "consensus", rank=me, dead=dead,
                   version=version, digest=digest)
    if topo is not None:
        # cross-slice agreement runs over slice LEADERS only (one
        # round trip per surviving slice), relayed within each slice
        ok = _slice_consensus(peer, topo, payload, digest, survivor_ranks)
    else:
        try:
            # send_retries is SHORT: this collective runs exactly when
            # peers are dying, and a consensus root that died after the
            # ping sweep must surface as ConnectionError in seconds, not
            # after the channel's 500-rung bring-up ladder
            ok = peer.channel.consensus_bytes(
                payload, survivors, name=f"kf.shrink.{digest}",
                send_retries=_RECOVERY_SEND_RETRIES,
            )
        except (TimeoutError, ConnectionError, OSError) as e:
            _log.warning("exclusion consensus did not converge: %s", e)
            ok = False
    if not ok:
        _log.warning(
            "survivors disagree on the dead set (mine: %s) — not shrinking",
            dead,
        )
        return False
    _log.warning(
        "excluding dead rank(s) %s: %d -> %d workers (v%d)",
        dead, len(workers), len(survivors), version,
    )
    timeline.event("shrink", "propose", rank=me, dead=dead,
                   version=version, survivors=len(survivors))
    # kf-ledger: a shrink is the most consequential "decision" the
    # cluster makes — the consensus version is the agreement round
    ledger.record_decision(
        "shrink", "world", len(workers), len(survivors),
        consensus_seq=version, evidence={"dead": list(dead)})
    if topo is not None:
        timeline.event("slice", "propose", rank=me,
                       dead_slices=sorted({topo.slice_of(r) for r in dead}),
                       version=version)
    _publish_shrunk_cluster(peer, new_cluster, survivors)
    peer._propose(new_cluster, version)
    log_event(f"shrunk-to-survivors-v{version}-n{len(survivors)}")
    # control event for the live plane, AFTER _propose: the propose path
    # posts its own generic "resize" event, and kftop's cluster-health
    # line shows only the newest control — the shrink (which names the
    # dead set, the thing the operator needs) must be the one that sticks
    if survivors.rank(peer.config.self_id) == 0:
        from kungfu_tpu_torch.monitor.aggregator import post_control_if_enabled

        extra = {}
        if topo is not None:
            extra["slices"] = sorted({topo.slice_of(r) for r in dead})
        post_control_if_enabled(peer, "shrink", dead=dead, version=version,
                                survivors=len(survivors), **extra)
    return True


def _publish_shrunk_cluster(peer, new_cluster: Cluster, survivors) -> None:
    """Lowest surviving rank PUTs the shrunk cluster to the config server
    (best effort): standby peers, watch runners, and late joiners must
    observe the post-failure membership, and the next schedule-driven
    resize must diff against it rather than the pre-failure list."""
    if not peer.config.config_server:
        return
    if survivors.rank(peer.config.self_id) != 0:
        return
    import urllib.request

    req = urllib.request.Request(
        peer.config.config_server,
        data=new_cluster.to_json().encode(),
        method="PUT",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()
    except OSError as e:
        _log.warning("cannot publish shrunk cluster: %s", e)


def recover_from_peer_failure(
    peer,
    failure: Optional[BaseException] = None,
    snapshot=None,
    zero_boundary=None,
    stage_boundary=None,
) -> Tuple[bool, Optional[Tuple[int, object, dict]]]:
    """The full survivor-side driver: confirm the dead set, shrink, and
    hand back the replay point.

    Returns ``(shrunk, replay)`` where ``replay`` is the **agreed**
    ``(step, tree, meta)`` boundary — the shrink leader's (new rank 0's)
    snapshot, broadcast to every survivor — or ``None`` without one.
    The agreement matters: the dead peer may have fed some survivors
    before dying, so committed steps can diverge by one across
    survivors, and replaying from per-peer snapshots would rendezvous
    collectives under mismatched step names forever.  Pass ``snapshot``
    on every surviving rank or on none (the broadcast must be
    symmetric).

    ``zero_boundary`` (a :class:`kungfu_tpu_torch.elastic.reshard.ZeroBoundary`,
    same all-or-none symmetry) carries ZeRO-sharded optimizer state,
    which cannot ride the leader-broadcast ``snapshot`` (each rank holds
    only its 1/n chunk): after the shrink it is re-carved **leaderlessly**
    across the survivors — each rank exchanging only the O(total/n)
    segments the new geometry moves, dead ranks' chunks served from
    their ring-buddy mirrors — and the caller restores the sharded state
    for the shrunk epoch with ``zero_boundary.place(new_comm)``.

    ``stage_boundary`` (a :class:`kungfu_tpu_torch.parallel.pp.StageBoundary`,
    same all-or-none symmetry AND the same snapshot requirement) carries
    a pipeline stage's params + ZeRO-2 optimizer chunks through the
    shrink: after the membership is applied, the surviving stages
    re-balance the LAYERS over themselves via the pure stage re-carve
    plan — a whole dead stage (= a dead slice under the PP-across-slices
    mapping) is restored from the ring-buddy mirror on its predecessor
    stage instead of aborting the job.  Recovery-ladder rung 10.

    ``shrunk=False`` means nothing provably died (a transient — the
    caller may simply retry the collective).  On quorum loss this
    signals the failure detector (``otherdown`` → the MonitoredRun
    relaunch, the pre-existing last resort) and re-raises
    :class:`QuorumLostError`.
    """
    if stage_boundary is not None and snapshot is None:
        raise ValueError(
            "stage_boundary needs a StepSnapshot alongside it — the "
            "leader-agreed replay step gates the stage re-carve against "
            "survivors whose boundaries committed different steps")
    if zero_boundary is not None and snapshot is None:
        # checked before anything destructive: the recarve must be gated
        # on the leader-agreed replay step (survivors' boundaries can
        # diverge by one), and that step only exists via the snapshot
        raise ValueError(
            "zero_boundary needs a StepSnapshot alongside it — the "
            "leader-agreed replay step gates the re-carve against "
            "survivors whose boundaries committed different steps")
    suspects = []
    if isinstance(failure, PeerFailureError) and failure.rank is not None:
        suspects.append(failure.rank)
    dead = find_dead_ranks(peer, suspects)
    if not dead:
        _log.info(
            "peer failure (%s) but every worker answers ping — transient, "
            "not shrinking", failure,
        )
        return False, None
    old_workers = peer.cluster.workers  # pre-shrink membership, for recarve
    try:
        shrunk = shrink_to_survivors(peer, dead)
    except QuorumLostError:
        from kungfu_tpu_torch.monitor.signals import monitor_report_down

        _log.error(
            "quorum lost (%d dead of %d): escalating to detector-driven "
            "restart", len(dead), peer.size(),
        )
        monitor_report_down()
        raise
    replay = None
    if shrunk and snapshot is not None:
        replay = _sync_replay_point(peer, snapshot)
    if shrunk and zero_boundary is not None:
        from kungfu_tpu_torch.elastic.reshard import recarve_after_shrink

        # the leader-agreed replay step gates the recarve: a survivor
        # whose boundary committed one step ahead (the dead peer fed it
        # before dying) holds state the step-behind replay cannot use —
        # recarve raises loudly instead of blending two steps.  A
        # snapshot was passed (entry check) but the replay sync itself
        # can degrade (broadcast timeout, nothing committed yet): with
        # no agreed step there is nothing to gate on, and an ungated
        # exchange would blend divergent boundaries SILENTLY — fail the
        # recovery toward the checkpoint restart instead.
        if replay is None:
            raise RuntimeError(
                "replay-point sync yielded no agreed step (broadcast "
                "failed or no boundary was committed): the zero_boundary "
                "re-carve cannot be step-gated and survivors' boundaries "
                "may diverge — escalate to the checkpoint restart")
        recarve_after_shrink(peer, zero_boundary, old_workers,
                             expect_step=replay[0])
    if shrunk and stage_boundary is not None:
        from kungfu_tpu_torch.parallel.pp import recarve_stages_after_shrink

        # rung 10: re-balance pipeline stages over the survivors — the
        # same step gate as the ZeRO re-carve, for the same reason
        if replay is None:
            raise RuntimeError(
                "replay-point sync yielded no agreed step (broadcast "
                "failed or no boundary was committed): the stage "
                "re-carve cannot be step-gated and survivors' boundaries "
                "may diverge — escalate to the checkpoint restart")
        recarve_stages_after_shrink(peer, stage_boundary, old_workers,
                                    expect_step=replay[0])
    return shrunk, replay


def _sync_replay_point(peer, snapshot):
    """All survivors adopt the leader's committed boundary: the lowest
    surviving rank broadcasts its :class:`StepSnapshot` wire form over
    the (already-shrunk) worker list; everyone else adopts it.  A
    survivor one committed step ahead of the leader deliberately steps
    back — consistency of the replayed step beats that one step of
    progress (the alternative is a cluster-wide rendezvous livelock)."""
    survivors = peer.cluster.workers
    version = peer.cluster_version
    name = f"kf.shrink.replay.v{version}"
    # rank=None → the module default (the process's stable identity set
    # at Peer.start) stamps the event; the POST-shrink rank would alias
    # a dead peer's id in the merged timeline
    timeline.event("shrink", "replay", version=version,
                   new_rank=survivors.rank(peer.config.self_id))
    try:
        if survivors.rank(peer.config.self_id) == 0:
            peer.channel.broadcast_bytes(
                snapshot.serialize(), survivors, name,
                send_retries=_RECOVERY_SEND_RETRIES,
            )
            return snapshot.last()
        blob = peer.channel.broadcast_bytes(None, survivors, name)
        return snapshot.adopt(blob)
    except (TimeoutError, ConnectionError, OSError, ValueError) as e:
        _log.warning(
            "no agreed replay point (%s); continuing without replay", e
        )
        return None
