"""UCB bandit over collective strategies, the decision core of online
adaptation.

Copy of ``kungfu_tpu/policy/bandit.py``.  The arms are collective
strategies (host-plane :class:`~kungfu_tpu_torch.plan.strategy.Strategy`
graphs plus the measured-latency MST tree, or the device plane's
allreduce schedules ``psum``/``two_stage``/``ring``/``pallas_ring``, the
last through the port's ring kernels), and the reward is measured window
latency (lower is better).

Every decision is a pure function of the agreed stats table: the drivers
(:mod:`kungfu_tpu_torch.monitor.adapt_device`) allreduce each window's
per-arm ``(count, sum)`` deltas, every rank folds the same agreed
numbers into its table, and :meth:`ArmStats.select` breaks every tie by
arm order, so N ranks fed the same stream make the same swap at the
same step without a leader.  The active arm keeps being measured, so a
degraded incumbent's mean climbs and UCB leaves it; the ``log N`` bonus
re-probes abandoned arms at a decaying rate, and ``decay`` ages the
table.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kungfu_tpu_torch.policy.base import BasePolicy, PolicyContext

#: default exploration weight: the bonus is ``c * mean_latency *
#: sqrt(2 ln N / n_arm)`` — scaled by the observed mean so it is in
#: latency units and one constant works for microsecond device windows
#: and 100 ms degraded host windows alike
DEFAULT_EXPLORE_C = 0.5


class ArmStats:
    """Per-arm ``(count, sum-of-latency)`` table with UCB selection for
    MINIMIZATION.  Pure state machine: no clocks, no randomness — the
    same observation sequence always yields the same selections."""

    def __init__(self, arms: Sequence[str], c: float = DEFAULT_EXPLORE_C,
                 min_pulls: int = 1, decay: float = 1.0):
        if not arms:
            raise ValueError("bandit needs at least one arm")
        if len(set(arms)) != len(arms):
            raise ValueError(f"duplicate arms in {arms}")
        self.arms: Tuple[str, ...] = tuple(arms)
        self.c = float(c)
        self.min_pulls = max(1, int(min_pulls))
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = float(decay)
        self.counts: List[float] = [0.0] * len(self.arms)
        self.sums: List[float] = [0.0] * len(self.arms)

    # -- feeding ---------------------------------------------------------
    def index(self, arm: str) -> int:
        try:
            return self.arms.index(arm)
        except ValueError:
            raise KeyError(f"unknown arm {arm!r}; arms are {self.arms}")

    def observe(self, arm: str, latency_s: float, count: float = 1.0) -> None:
        """Fold ``count`` observations summing to ``latency_s * count``
        seconds into ``arm``.  Drivers pass the ALLREDUCED window deltas
        here (count = ranks, latency = mean over ranks), so the table
        stays identical on every rank.  Non-finite, negative, or
        exactly-zero samples are rejected loudly — a 0-second "winner"
        is how a startup probe goes wrong, and an arm with mean 0 would
        also zero its UCB score floor and become permanently
        unbeatable."""
        if count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        if not math.isfinite(latency_s) or latency_s <= 0:
            raise ValueError(
                f"latency must be finite and positive, got {latency_s!r}")
        if self.decay < 1.0:
            for i in range(len(self.arms)):
                self.counts[i] *= self.decay
                self.sums[i] *= self.decay
        i = self.index(arm)
        self.counts[i] += count
        self.sums[i] += latency_s * count

    def reset(self) -> None:
        """Forget everything — the re-explore after a membership change
        (a 4-rank winner says nothing about the 2-rank regime)."""
        self.counts = [0.0] * len(self.arms)
        self.sums = [0.0] * len(self.arms)

    # -- deciding --------------------------------------------------------
    def mean(self, arm: str) -> Optional[float]:
        i = self.index(arm)
        return self.sums[i] / self.counts[i] if self.counts[i] > 0 else None

    def unexplored(self) -> Optional[str]:
        """First arm (in declaration order) still under ``min_pulls`` —
        the deterministic exploration phase."""
        for i, a in enumerate(self.arms):
            if self.counts[i] < self.min_pulls:
                return a
        return None

    def select(self) -> str:
        """The UCB1 pick: unexplored arms first (declaration order), then
        the argmin of ``mean - c * overall_mean * sqrt(2 ln N / n)``.
        Ties break to the earlier arm — arrival order can never flip a
        cluster-wide decision."""
        arm = self.unexplored()
        if arm is not None:
            return arm
        total = sum(self.counts)
        overall = sum(self.sums) / total if total > 0 else 0.0
        best_i, best_score = 0, math.inf
        for i in range(len(self.arms)):
            bonus = self.c * overall * math.sqrt(
                2.0 * math.log(max(total, math.e)) / self.counts[i])
            score = self.sums[i] / self.counts[i] - bonus
            if score < best_score:  # strict: ties keep the earlier arm
                best_i, best_score = i, score
        return self.arms[best_i]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{arm: {count, mean_s}}`` for observability surfaces."""
        out = {}
        for i, a in enumerate(self.arms):
            out[a] = {
                "count": round(self.counts[i], 3),
                "mean_s": (self.sums[i] / self.counts[i]
                           if self.counts[i] > 0 else None),
            }
        return out


class ScheduleTable:
    """Size-bucketed arm tables: small control tensors and large fused
    gradient buckets learn **independent** winners (the per-``nbytes``
    schedule table installed into
    :meth:`kungfu_tpu_torch.comm.device.Communicator.set_bucket_strategy`)."""

    def __init__(self, arms: Sequence[str], n_buckets: int,
                 c: float = DEFAULT_EXPLORE_C, min_pulls: int = 1,
                 decay: float = 1.0):
        if n_buckets < 1:
            raise ValueError(f"need >= 1 bucket, got {n_buckets}")
        self.tables = [ArmStats(arms, c=c, min_pulls=min_pulls, decay=decay)
                       for _ in range(n_buckets)]
        self.active: List[str] = [self.tables[0].arms[0]] * n_buckets

    @property
    def arms(self) -> Tuple[str, ...]:
        return self.tables[0].arms

    def observe(self, bucket: int, arm: str, latency_s: float,
                count: float = 1.0) -> None:
        self.tables[bucket].observe(arm, latency_s, count)

    def select(self, bucket: int) -> str:
        return self.tables[bucket].select()

    def install(self, bucket: int, arm: str) -> None:
        self.tables[bucket].index(arm)  # unknown arm raises before install
        self.active[bucket] = arm

    def reset(self) -> None:
        for t in self.tables:
            t.reset()

    def summary(self) -> Dict[int, Dict]:
        return {b: {"active": self.active[b], "arms": t.snapshot()}
                for b, t in enumerate(self.tables)}


class OverlapDepthBandit:
    """UCB arms over the engine's async in-flight window depth: the
    measured reward is the wall time of one bucketed pipeline run
    (``parallel/zero.py::host_bucket_pipeline``) at the active depth,
    fed via :meth:`observe`; every ``check_every`` observations the
    table re-selects and installs the winner with
    :meth:`~kungfu_tpu_torch.comm.engine.CollectiveEngine.set_overlap_depth`.

    Unlike the strategy arms this needs **no fence and no consensus**:
    the window is local backpressure — tags and issue order never
    change with it — so each rank may legally learn its own depth
    (a straggler host with slow NICs wants a deeper window than its
    peers; forcing agreement would deny exactly that).  The per-bucket
    latencies behind the pipeline measurement arrive through the
    engine's latency hook (``engine.set_latency_hook``), the same feed
    shape the device bandit drinks from."""

    def __init__(self, engine, depths: Sequence[int] = (1, 2, 4),
                 check_every: int = 3, c: float = DEFAULT_EXPLORE_C,
                 min_pulls: int = 1, decay: float = 1.0):
        if not depths or any(d < 1 for d in depths):
            raise ValueError(f"depths must be positive, got {depths}")
        self.stats = ArmStats([str(d) for d in depths], c=c,
                              min_pulls=min_pulls, decay=decay)
        self.check_every = max(1, int(check_every))
        self._engine = engine
        self.swaps = 0
        self._n = 0
        # start on the table's first arm so exploration order is the
        # declaration order (determinism contract of ArmStats)
        self.active = self.stats.arms[0]
        engine.set_overlap_depth(int(self.active))

    def observe(self, pipeline_seconds: float) -> bool:
        """Fold one pipeline run's wall time into the active depth's
        arm; True when a new depth was just installed."""
        self.stats.observe(self.active, pipeline_seconds)
        self._n += 1
        if self._n % self.check_every:
            return False
        pick = self.stats.select()
        if pick == self.active:
            return False
        from kungfu_tpu_torch.monitor import ledger

        # depth changes are local (no consensus fence: the depth does not
        # shape a collective), so consensus_seq=None; the ledger is a
        # do-nothing hook until ROADMAP A9
        ledger.record_decision(
            "overlap-depth", "depth", int(self.active), int(pick),
            evidence={"checks": self._n // self.check_every})
        self.active = pick
        self._engine.set_overlap_depth(int(pick))
        self.swaps += 1
        return True

    def reset(self) -> None:
        """Re-explore (post-resize: a 4-rank depth winner says nothing
        about the 2-rank wire regime) — same contract as the strategy
        tables."""
        self.stats.reset()
        self._n = 0
        self.active = self.stats.arms[0]
        self._engine.set_overlap_depth(int(self.active))


class CollectiveBanditPolicy(BasePolicy):
    """Policy-runner wiring for the bandit drivers: runs the host-plane
    (and optionally device-plane) bandit after every step, feeding it the
    measured step collective seconds the loop reports via
    ``runner.after_step(..., step_collective_s=dt)``.  Every rank's
    policy runner must drive it at the same step points — the swap fence
    is collective (:mod:`kungfu_tpu_torch.monitor.adapt_device`)."""

    #: metric key the training loop reports measured collective seconds
    #: under (``runner.after_step(step_collective_s=dt)``)
    METRIC = "step_collective_s"

    def __init__(self, peer, device_comm=None, **driver_kwargs):
        from kungfu_tpu_torch.monitor.adapt_device import (DeviceBanditDriver,
                                                     HostBanditDriver)

        self.host = HostBanditDriver(peer, **driver_kwargs)
        self.device = (DeviceBanditDriver(device_comm, peer=peer)
                       if device_comm is not None else None)

    def after_step(self, ctx: PolicyContext) -> None:
        dt = ctx.metrics.get(self.METRIC)
        if self.host.step(dt):
            ctx.metrics["bandit_swaps"] = float(self.host.swaps)
        if self.device is not None and self.device.step():
            ctx.metrics["bandit_device_swaps"] = float(self.device.swaps)
