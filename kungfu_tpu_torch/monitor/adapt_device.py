"""Online collective adaptation on both planes: the UCB bandit drivers.

Copy of ``kungfu_tpu/monitor/adapt_device.py``.  The decision core is
the bandit of :mod:`kungfu_tpu_torch.policy.bandit`; this module makes
it safe to run on a cluster:

* :class:`HostBanditDriver` — the arms are host-plane strategies
  (:class:`~kungfu_tpu_torch.plan.strategy.Strategy` graph sets) plus
  the measured-latency MST tree (``"mst"``); the observable is the
  per-step engine collective seconds the caller feeds to :meth:`step`,
  and the engine's swap-eligibility epochs gate the hysteresis.
* :class:`DeviceBanditDriver` — the arms are the device plane's
  allreduce schedules ``psum``/``two_stage``/``ring``/``pallas_ring``
  (the last through the port's ring kernels), learned per payload-size
  bucket (:data:`kungfu_tpu_torch.ops.schedules.SIZE_BUCKETS`) and
  installed into the communicator's per-``nbytes`` dispatch
  (:meth:`~kungfu_tpu_torch.comm.device.Communicator.
  set_bucket_strategy`).  Observations come from the communicator's
  latency hook (every eager allreduce reports ``(nbytes, schedule,
  seconds)`` of execution) or, with ``feed="timeline"``, from the
  flight recorder's device spans, which carry ``nbytes`` and ``sched``.

The swap fence is the reference's ``adaptation.go:8-28``: (1) the window
exchange is an allreduce of each rank's per-arm ``(count, sum)`` deltas
and its straggler vote, so every rank folds the same numbers into its
table; (2) the decision is pure (:meth:`ArmStats.select` breaks ties by
arm order); (3) the ranks digest-agree on the proposal
(``consensus_bytes``); (4) barrier, then swap in lockstep, with a
``swap`` timeline event on every rank and a fresh swap epoch on the
engine.

The straggler vote (:mod:`kungfu_tpu_torch.monitor.skew`) reads the
process-local flight recorder: when a cluster-wide majority sees a
consistent straggler, the window is not charged to the active arm, and
the host driver prefers the MST arm.  The bandit state does not survive
a membership change: both drivers reset and re-explore when the cluster
version moves (``elastic_step(bandit=)`` calls
:meth:`HostBanditDriver.on_membership_change`, and both drivers also
notice ``peer.cluster_version`` move by themselves).

Each swap writes a decision record through
:func:`kungfu_tpu_torch.monitor.ledger.record_decision`, as the
reference's does.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kungfu_tpu_torch.monitor import ledger, timeline
from kungfu_tpu_torch.monitor.skew import (COLLECTIVE_KINDS, SPIKE_FACTOR,
                                     skew_rows, straggler_verdict)
from kungfu_tpu_torch.policy.bandit import ArmStats, ScheduleTable
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("kf-adapt")


def _spiky_straggler(events: Sequence[dict]) -> bool:
    """True when the skew analysis names a straggler AND at least one
    group shows a real spike (slowest >= SPIKE_FACTOR x fastest).
    ``straggler_verdict`` alone votes a rank for ANY >=2-rank group —
    including perfectly healthy ones with microsecond skew — and a
    bandit that believed it would discard every window and never learn;
    the spike threshold keeps the verdict for genuinely sick ranks."""
    rows = skew_rows(list(events))
    spiky = any(
        r["fastest_s"] > 0 and r["slowest_s"] >= SPIKE_FACTOR * r["fastest_s"]
        for r in rows
    )
    return spiky and straggler_verdict(list(events)) is not None

#: the measured-latency MST arm of the host bandit: installing it
#: re-carves the broadcast topology over the ping-latency MST
#: (``peer.set_tree``), the reference's ``adaptation.cpp`` move
MST_ARM = "mst"

#: default host-plane arm set; the incumbent engine strategy is
#: prepended when it is not already a member
DEFAULT_HOST_ARMS = ("STAR", "RING", "BINARY_TREE_STAR", MST_ARM)

_DEVICE_SPAN_KINDS = frozenset({"device"})


def _median(xs: Sequence[float]) -> Optional[float]:
    finite = [x for x in xs if math.isfinite(x) and x > 0]
    return statistics.median(finite) if finite else None


class HostBanditDriver:
    """Per-rank driver over the host collective engine.  Every rank must
    construct one with the SAME arguments and call :meth:`step` at the
    same loop points (the window exchange and the fence are collective).

    Typical loop::

        driver = HostBanditDriver(peer, check_every=4)
        for batch in data:
            t0 = time.perf_counter()
            grads = peer.engine().all_reduce(grads, op="mean")
            driver.step(time.perf_counter() - t0)  # may lockstep-swap
    """

    def __init__(self, peer, arms: Optional[Sequence[str]] = None,
                 check_every: int = 8, c: float = 0.5, min_pulls: int = 1,
                 decay: float = 1.0, min_swap_collectives: int = 2,
                 mst_samples: int = 3):
        self.peer = peer
        self.check_every = max(1, check_every)
        self.min_swap_collectives = max(0, min_swap_collectives)
        self.mst_samples = max(1, mst_samples)
        arm_list = list(arms) if arms is not None else list(DEFAULT_HOST_ARMS)
        incumbent = self._engine_arm_name()
        if incumbent is not None and incumbent not in arm_list:
            arm_list.insert(0, incumbent)
        self.table = ArmStats(arm_list, c=c, min_pulls=min_pulls, decay=decay)
        self.active = incumbent if incumbent in arm_list else arm_list[0]
        self._window: List[float] = []
        self._step_n = 0
        self._seq = 0            # check-boundary sequence (lockstep)
        self._settling = False   # discard the first window after a swap
        self._skew_cursor = 0
        self._seen_version = getattr(peer, "cluster_version", 0)
        self.swaps = 0

    # -- helpers ---------------------------------------------------------
    def _engine_arm_name(self) -> Optional[str]:
        if self.peer is None or getattr(self.peer, "detached", False):
            return None  # a detached peer has no engine in the new world
        engine = self.peer.engine()
        if engine is None:
            return None
        s = engine.strategy
        if s is None:  # an explicit tree is installed
            return MST_ARM
        return getattr(s, "name", str(s))

    def _rank(self) -> Optional[int]:
        r = self.peer.chaos_rank()
        return r if r is not None else self.peer.rank()

    def _straggler_suspected(self) -> bool:
        """Local suspicion from the flight recorder's recent collective
        spans — cheap (cursor read), spike-thresholded
        (:func:`_spiky_straggler`), and only ever *advisory*: the
        cluster-wide majority vote in the window exchange is what makes
        the verdict identical on every rank."""
        self._skew_cursor, events = timeline.events_tail(
            self._skew_cursor, kinds=frozenset(COLLECTIVE_KINDS))
        return _spiky_straggler(events)

    # -- membership ------------------------------------------------------
    def on_membership_change(self, version: Optional[int] = None) -> None:
        """Reset and re-explore: called by ``elastic_step(bandit=...)``
        after a resize, and self-detected from ``peer.cluster_version``.
        The rebuilt engine runs the configured default strategy, so the
        active arm re-anchors on what is actually installed."""
        self.table.reset()
        self._window = []
        self._settling = True
        # re-anchor the check fence at the resize boundary: a joiner
        # constructs a FRESH driver (counters 0), so survivors carrying
        # pre-resize _step_n/_seq would hit check boundaries at loop
        # iterations the joiner does not (mismatched collective streams)
        # and stamp different seqs into the swap digest (false
        # "tables diverged" consensus failures)
        self._step_n = 0
        self._seq = 0
        self._seen_version = (version if version is not None
                              else getattr(self.peer, "cluster_version", 0))
        incumbent = self._engine_arm_name()
        if incumbent is not None and incumbent in self.table.arms:
            self.active = incumbent
        _log.info("membership changed: bandit state reset (re-exploring "
                  "from %s)", self.active)

    # -- the per-step driver ---------------------------------------------
    def step(self, collective_seconds: Optional[float] = None) -> bool:
        """Feed one step's measured collective seconds; returns True when
        a fenced swap happened (collectively, on every rank)."""
        if getattr(self.peer, "cluster_version", 0) != self._seen_version:
            self.on_membership_change()
        if (collective_seconds is not None
                and math.isfinite(collective_seconds)
                and collective_seconds > 0):
            self._window.append(collective_seconds)
        self._step_n += 1
        if self._step_n % self.check_every:
            return False
        return self._check()

    def _check(self) -> bool:
        med = _median(self._window)
        self._window = []  # cleared even when there is no engine — a
        # single-process loop feeding step() forever must not grow an
        # unbounded list of measurements nobody will read
        engine = self.peer.engine()
        if engine is None:
            return False  # single-process: no host collectives to adapt
        suspected = self._straggler_suspected()
        # ONE fused window-exchange allreduce (record=False keeps the
        # 24-byte vote out of the throughput window it is judging):
        # [n_obs, sum_of_window_medians, straggler_votes]
        row = np.array(
            [0.0 if med is None else 1.0,
             0.0 if med is None else med,
             1.0 if suspected else 0.0],
            np.float64,
        )
        agreed = engine.all_reduce(row, op="sum", record=False)
        n_obs, obs_sum = float(agreed[0]), float(agreed[1])
        straggler = float(agreed[2]) * 2 > self.peer.size()
        self._seq += 1
        if self._settling:
            # the first window after a swap measures the swap transient
            # (connection churn, fresh graphs) — a clean window seeds the
            # new arm's own baseline instead
            self._settling = False
            return False
        if n_obs > 0 and not straggler and self.active in self.table.arms:
            # agreed observation: the mean of the ranks' window medians.
            # A straggler-voted window is NOT charged to the arm — a sick
            # rank slows every strategy; swapping cannot fix it
            self.table.observe(self.active, obs_sum / n_obs)
        proposal = self.table.select()
        if straggler and MST_ARM in self.table.arms:
            # agreed straggler: prefer the topology fix that routes
            # around the slow rank/link over strategy roulette
            proposal = MST_ARM
        if proposal == self.active:
            return False
        if not engine.swap_eligible(self.min_swap_collectives):
            return False  # the incumbent has not been measured yet
        self._install(engine, proposal)
        return True

    # -- the fenced swap --------------------------------------------------
    def _install(self, engine, proposal: str) -> None:
        """Digest-agree → barrier → swap in lockstep → ``swap`` event on
        every rank (the reference ``SetGlobalStrategy`` fence).

        The proposal digest runs for EVERY arm, the MST included: a
        diverged rank must be surfaced by this loud RuntimeError, not by
        the deadlock of one rank entering the latency allgather while
        another enters a consensus round (the exact failure the fence
        exists to catch)."""
        prev = self.active
        digest = f"kf-bandit:{self._seq}:{proposal}".encode()
        if not self.peer.consensus_bytes(digest, name="bandit-swap"):
            raise RuntimeError(
                f"ranks disagree on the bandit swap target {proposal!r}"
                " — bandit tables diverged (non-collective step calls?)"
            )
        if proposal == MST_ARM:
            from kungfu_tpu_torch.monitor.adapt import \
                minimum_spanning_tree_from_latencies

            # the latency matrix is allgathered → identical on all ranks
            # → identical MST; peer.set_tree runs its own digest
            # consensus + barrier around the engine swap
            forest = minimum_spanning_tree_from_latencies(
                self.peer, samples=self.mst_samples)
            self.peer.set_tree(forest)
        else:
            from kungfu_tpu_torch.plan.strategy import parse_strategy

            self.peer.barrier()
            engine.set_strategy(parse_strategy(proposal))
        engine.mark_swap()
        timeline.event(
            "swap", proposal, rank=self._rank(), plane="host",
            seq=self._seq, prev=prev, step=timeline.current_step(),
        )
        # the decision ledger's record; the digest seq is the consensus
        # round that agreed on it
        ledger.record_decision(
            "bandit-host", "strategy", prev, proposal,
            consensus_seq=self._seq, evidence={"plane": "host"})
        self.active = proposal
        self._settling = True
        self.swaps += 1
        _log.info("bandit swap (host): %s -> %s at seq %d",
                  prev, proposal, self._seq)


class DeviceBanditDriver:
    """Per-controller driver over the device communicator's size-bucketed
    schedule table.  Arms are the allreduce schedules; each payload
    bucket learns its own winner and installs it via
    ``comm.set_bucket_strategy``, which the next eager allreduce of that
    bucket dispatches on.

    One controller (the port's co-resident ranks) decides locally (the
    decision is deterministic anyway); with a ``peer``, the controllers
    fence through the peer's host plane exactly like
    :class:`HostBanditDriver`.
    """

    def __init__(self, comm, peer=None,
                 arms: Optional[Sequence[str]] = None,
                 check_every: int = 16, c: float = 0.5, min_pulls: int = 1,
                 decay: float = 1.0, feed: str = "hook"):
        from kungfu_tpu_torch.ops.schedules import (ALLREDUCE_SCHEDULES,
                                                    SIZE_BUCKETS)

        if feed not in ("hook", "timeline"):
            raise ValueError(f"feed must be hook|timeline, got {feed!r}")
        self.peer = peer
        self.check_every = max(1, check_every)
        self._buckets = len(SIZE_BUCKETS)
        self._bucket_names = SIZE_BUCKETS
        arm_list = list(arms) if arms is not None else list(ALLREDUCE_SCHEDULES)
        self.table = ScheduleTable(arm_list, self._buckets, c=c,
                                   min_pulls=min_pulls, decay=decay)
        self._feed = feed
        self._tl_cursor = 0
        self._skew_cursor = 0
        #: local window accumulators: [bucket][arm] -> [count, sum]
        self._pending = [
            {a: [0.0, 0.0] for a in self.table.arms}
            for _ in range(self._buckets)
        ]
        self._settling = [False] * self._buckets
        self._step_n = 0
        self._seq = 0
        self.swaps = 0
        self.comm = None
        self._seen_version = None
        self.rebind(comm)

    # -- binding / membership --------------------------------------------
    def rebind(self, comm) -> None:
        """Bind to a (new) mesh-epoch communicator: install the latency
        hook, seed the active arms from its current strategy, and reset
        the table — a new epoch is a new regime (re-explore)."""
        if self.comm is not None and self.comm is not comm:
            self.comm.set_latency_hook(None)
        self.comm = comm
        self._seen_version = comm.version
        if self._feed == "hook":
            comm.set_latency_hook(self._on_collective)
        self.table.reset()
        for b in range(self._buckets):
            self.table.active[b] = comm.strategy_for_bucket(b)
            self._pending[b] = {a: [0.0, 0.0] for a in self.table.arms}
        self._settling = [False] * self._buckets
        # re-anchor the check fence (see HostBanditDriver
        # .on_membership_change): a new epoch's joiners start fresh
        # drivers at 0, and the swap digest embeds _seq
        self._step_n = 0
        self._seq = 0

    def on_membership_change(self, version: Optional[int] = None) -> None:
        """Re-explore after a resize (``elastic_step(bandit=...)``): the
        next ``step`` rebinds to the new epoch's communicator."""
        self._seen_version = None

    # -- feeding ---------------------------------------------------------
    def _on_collective(self, nbytes: int, sched: str, seconds: float) -> None:
        from kungfu_tpu_torch.ops.schedules import size_bucket

        if not math.isfinite(seconds) or seconds <= 0:
            return
        acc = self._pending[size_bucket(nbytes)].get(sched)
        if acc is not None:
            acc[0] += 1.0
            acc[1] += seconds

    def feed_from_timeline(self) -> int:
        """Drain device-plane collective spans from the flight recorder
        into the per-schedule rings (``feed="timeline"`` mode — for loops
        whose collectives are observed by tracing rather than the eager
        hook).  Returns the number of spans consumed."""
        self._tl_cursor, events = timeline.events_tail(
            self._tl_cursor, kinds=_DEVICE_SPAN_KINDS)
        used = 0
        for e in events:
            attrs = e.get("attrs") or {}
            nbytes, sched = attrs.get("nbytes"), attrs.get("sched")
            if nbytes is None or sched is None or e["dur"] <= 0:
                continue
            self._on_collective(int(nbytes), sched, float(e["dur"]))
            used += 1
        return used

    def _straggler_suspected(self) -> bool:
        self._skew_cursor, events = timeline.events_tail(
            self._skew_cursor, kinds=frozenset(COLLECTIVE_KINDS))
        return _spiky_straggler(events)

    # -- the per-step driver ---------------------------------------------
    def step(self) -> bool:
        """Call once per training step on every controller; returns True
        when at least one bucket's schedule was swapped (in lockstep)."""
        if self.peer is not None and (
                self._seen_version is None
                or self.peer.cluster_version != self._seen_version):
            comm = self.peer.communicator()
            if comm is not self.comm or comm.version != self._seen_version:
                self.rebind(comm)
        if self._feed == "timeline":
            self.feed_from_timeline()
        self._step_n += 1
        if self._step_n % self.check_every:
            return False
        return self._check()

    def _agree(self, row: np.ndarray) -> Tuple[np.ndarray, int]:
        """Sum the window vector across ranks; returns (agreed, world)."""
        engine = self.peer.engine() if self.peer is not None else None
        if engine is None:
            return row, 1
        return (np.asarray(engine.all_reduce(row, op="sum", record=False)),
                self.peer.size())

    def _check(self) -> bool:
        suspected = self._straggler_suspected()
        arms = self.table.arms
        # fused exchange: per (bucket, arm) [count, sum] + straggler vote
        flat: List[float] = []
        for b in range(self._buckets):
            for a in arms:
                flat.extend(self._pending[b][a])
            self._pending[b] = {a: [0.0, 0.0] for a in arms}
        flat.append(1.0 if suspected else 0.0)
        agreed, world = self._agree(np.asarray(flat, np.float64))
        straggler = float(agreed[-1]) * 2 > world
        self._seq += 1
        swapped = False
        proposals: List[Tuple[int, str, str]] = []
        off = 0
        for b in range(self._buckets):
            settle, self._settling[b] = self._settling[b], False
            for i, a in enumerate(arms):
                cnt, tot = float(agreed[off + 2 * i]), float(agreed[off + 2 * i + 1])
                if cnt > 0 and not straggler and not settle:
                    # one window observation per (bucket, arm): the mean
                    # collective latency across ranks and repeats.
                    # Straggler-voted and post-swap (warm-up) windows are
                    # discarded, not charged
                    self.table.observe(b, a, tot / cnt)
            off += 2 * len(arms)
            proposal = self.table.select(b)
            if proposal != self.table.active[b]:
                proposals.append((b, self.table.active[b], proposal))
        if not proposals:
            return False
        self._fence(proposals)
        for b, prev, arm in proposals:
            self.comm.set_bucket_strategy(b, arm)
            self.table.install(b, arm)
            self._settling[b] = True
            timeline.event(
                "swap", arm, rank=self._rank(), plane="device",
                bucket=self._bucket_names[b], seq=self._seq, prev=prev,
                step=timeline.current_step(),
            )
            ledger.record_decision(
                "bandit-device", "schedule", prev, arm,
                consensus_seq=self._seq,
                evidence={"plane": "device",
                          "bucket": self._bucket_names[b]})
            self.swaps += 1
            swapped = True
            _log.info("bandit swap (device, %s bucket): %s -> %s at seq %d",
                      self._bucket_names[b], prev, arm, self._seq)
        return swapped

    def _rank(self) -> Optional[int]:
        if self.peer is None:
            return timeline.current_rank()
        r = self.peer.chaos_rank()
        return r if r is not None else self.peer.rank()

    def _fence(self, proposals: List[Tuple[int, str, str]]) -> None:
        """Digest-agree + barrier across controllers before any bucket
        installs — a controller running ring collectives while a peer
        runs psum is two different programs on one mesh."""
        if self.peer is None or self.peer.size() <= 1:
            return
        digest = ";".join(
            f"{self._bucket_names[b]}:{prev}->{arm}"
            for b, prev, arm in proposals
        )
        payload = f"kf-bandit-dev:{self._seq}:{digest}".encode()
        if not self.peer.consensus_bytes(payload, name="bandit-dev-swap"):
            raise RuntimeError(
                "controllers disagree on the device bucket swap "
                f"{digest!r} — bandit tables diverged"
            )
        self.peer.barrier()

    def summary(self) -> Dict:
        """Per-bucket active arm + arm stats (observability surface)."""
        return self.table.summary()
