"""Autoscale execution: serving resize intents become real workers (port
of ``kungfu_tpu/serve/scale.py``).

:class:`~kungfu_tpu_torch.policy.serve.ServeAutoscalePolicy` raises
worker-count intents on a :class:`~kungfu_tpu_torch.policy.base.
PolicyContext`; :class:`ServeFleet` executes them:

1. the target is slice-aligned through
   :func:`kungfu_tpu_torch.elastic.resize.slice_aligned_size` (a
   fractional slice has no mesh to serve from);
2. with a config server, the aligned size is published through
   ``Peer.propose_new_size`` by rank 0, as a training resize is;
3. ``spawn_fn(rank)`` builds the engine and a started
   :class:`~kungfu_tpu_torch.serve.router.ServeWorker` for a provisioned
   rank and the router admits it
   (:meth:`~kungfu_tpu_torch.serve.router.ServeRouter.admit_worker`);
   scale-in retires whole failure domains, highest first, once drained,
   through the router's exclusion.

``plan=`` is a :class:`~kungfu_tpu_torch.parallel.train.ParallelPlan`
(``pp`` must be 1, ``zero_stage`` 0, ``dp`` floors the replica count).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from kungfu_tpu_torch.monitor import ledger, timeline
from kungfu_tpu_torch.policy.base import PolicyContext
from kungfu_tpu_torch.policy.serve import ServeAutoscalePolicy
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("serve-scale")


class ServeFleet:
    """Owns the serving worker set of one router and executes autoscale
    intents as spawns/retires.

    ``spawn_fn(rank) -> ServeWorker`` must return a STARTED worker for
    a provisioned cluster rank; ``stop_fn(rank, worker)`` (optional)
    tears one down on scale-in.  ``plan`` validates the parallel shape
    of the deployment (pp == 1; ``plan.dp`` floors the replica count).
    """

    def __init__(self, router, policy: Optional[ServeAutoscalePolicy],
                 spawn_fn: Callable[[int], object], *,
                 stop_fn: Optional[Callable[[int, object], None]] = None,
                 plan=None):
        if plan is not None:
            if plan.pp != 1:
                raise ValueError(
                    "serving workers run the whole model (plan.pp must "
                    "be 1; pipelined serving is not wired yet)")
            if plan.zero_stage:
                raise ValueError(
                    "serving holds no optimizer state — plan.zero_stage "
                    "must be 0")
        self.router = router
        self.policy = policy or ServeAutoscalePolicy()
        self.plan = plan
        self._spawn = spawn_fn
        self._stop = stop_fn
        #: live worker objects by rank (the spawned ones; pre-existing
        #: workers admitted at router construction are not owned here)
        self.workers: dict = {}
        self._min = (plan.dp if plan is not None
                     else self.policy.min_workers)

    # -- capacity ----------------------------------------------------------
    def _provisioned(self) -> List[int]:
        """Cluster ranks that can host a worker: everything except the
        router's own rank."""
        workers = self.router.peer.config.cluster.workers
        me = workers.rank(self.router.peer.config.self_id)
        return [r for r in range(len(workers)) if r != me]

    def live(self) -> List[int]:
        return self.router.live_workers

    def _aligned(self, target_workers: int) -> Tuple[int, int]:
        """Slice-align through the existing resize path — in CLUSTER
        units, the same units ``propose_new_size`` speaks: the aligned
        total membership is ``target_workers`` plus the non-serving
        ranks (the router), rounded to whole slices by the peer's live
        topology.  Returns ``(aligned_workers, aligned_total)`` so the
        published size and the spawned count can never disagree by the
        router's offset (single-slice deployments pass through)."""
        from kungfu_tpu_torch.elastic.resize import slice_aligned_size

        others = (len(self.router.peer.config.cluster.workers)
                  - len(self._provisioned()))
        total = slice_aligned_size(self.router.peer,
                                   int(target_workers) + others)
        return max(0, total - others), total

    # -- the control tick ---------------------------------------------------
    def tick(self, view: Optional[dict] = None, **metrics) -> List[int]:
        """One autoscale tick: feed the policy (an aggregator
        ``/cluster`` view, or direct ``serve_queued=/serve_e2e_ms=``
        metrics), then execute any intent.  Returns the ranks spawned
        (positive) — retires return an empty list but take effect via
        the router's live set."""
        if view is not None:
            self.policy.observe_view(view)
        ctx = PolicyContext(cluster_size=len(self.live()))
        ctx.metrics.update(metrics)
        self.policy.after_step(ctx)
        target = ctx.requested_size
        if target is None or target == len(self.live()):
            return []
        return self.scale_to(target)

    def scale_to(self, target: int) -> List[int]:
        """Execute a worker-count intent: slice-align, publish through
        the elastic propose path when one is wired, spawn/retire, and
        admit/exclude on the router."""
        live = self.live()
        aligned, total = self._aligned(int(target))
        aligned = max(self._min, aligned)
        spare = [r for r in self._provisioned() if r not in live]
        if aligned > len(self._provisioned()):
            _log.warning(
                "autoscale target %d exceeds the provisioned world "
                "(%d slots) — clamping", aligned, len(self._provisioned()))
            aligned = len(self._provisioned())
            total = aligned + (len(self.router.peer.config.cluster.workers)
                               - len(self._provisioned()))
        peer = self.router.peer
        if peer.config.config_server and peer.rank() == 0:
            # the existing elastic publish path: the config server (and
            # every watch runner) observes the serving fleet's agreed
            # size exactly like a training resize.  ``total`` is already
            # in cluster units AND slice-aligned, so propose_new_size's
            # internal alignment is a no-op — the published membership
            # always matches what the fleet actually runs
            try:
                peer.propose_new_size(total)
            except (OSError, RuntimeError) as e:
                _log.warning("could not publish fleet size: %s", e)
        if aligned > len(live):
            spawned = []
            for r in spare[: aligned - len(live)]:
                w = self._spawn(r)
                self.workers[r] = w
                self.router.admit_worker(r)
                spawned.append(r)
            timeline.event("serve", "scale-up", rank=peer.chaos_rank(),
                           ranks=spawned, target=aligned)
            ledger.record_decision(
                "serve-fleet", "workers", len(live),
                len(live) + len(spawned),
                evidence={"ranks": spawned, "target": aligned},
                effect_series="e2e_ms")
            _log.info("autoscale: spawned workers %s (target %d)",
                      spawned, aligned)
            return spawned
        # scale-in: retire whole FAILURE DOMAINS, highest first — a
        # slice-aware router's mark_worker_dead excludes at slice
        # grain, so retiring one rank of a slice would cascade-exclude
        # its (possibly busy) siblings and replay their requests: the
        # exact latency spike the autoscaler exists to avoid.  Every
        # member of a retire group must be fleet-owned (excluding a
        # pre-existing worker would leave its thread running as a
        # zombie) AND drained (nothing outstanding); a group that
        # fails either check is skipped whole — the next tick retries.
        topo = self.router.topology
        if topo is None:
            groups = [[r] for r in sorted(live, reverse=True)]
        else:
            by_slice: dict = {}
            for r in live:
                by_slice.setdefault(topo.slice_of(r), []).append(r)
            groups = [sorted(by_slice[s])
                      for s in sorted(by_slice, reverse=True)]
        floor = max(self._min, aligned)
        remaining = len(live)
        retire = []
        for g in groups:
            if remaining - len(g) < floor:
                continue
            busy = [r for r in g if self.router.outstanding(r) > 0]
            if busy or any(r not in self.workers for r in g):
                if busy:
                    _log.info("autoscale: workers %s still have work "
                              "outstanding — deferring their retire",
                              busy)
                continue
            retire.append(g)
            remaining -= len(g)
        victims = []
        for g in retire:
            excluded = self.router.mark_worker_dead(g[0], readmit=True)
            for r in sorted(set(excluded) | set(g)):
                victims.append(r)
                w = self.workers.pop(r, None)
                if w is not None:
                    (self._stop or (lambda _r, _w: _w.stop()))(r, w)
        if victims:
            timeline.event("serve", "scale-down", rank=peer.chaos_rank(),
                           ranks=victims, target=aligned)
            ledger.record_decision(
                "serve-fleet", "workers", len(live),
                len(live) - len(victims),
                evidence={"ranks": victims, "target": aligned},
                effect_series="e2e_ms")
            _log.info("autoscale: retired workers %s (target %d)",
                      victims, aligned)
        return []
