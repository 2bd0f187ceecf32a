"""Closed-loop strategy adaptation, on the host plane and the device
plane.

Port of ``kungfu_tpu/monitor/adaptive.py``:

* :class:`AdaptiveStrategyDriver` (reference :55) watches the host
  engine's per-strategy throughput windows; when a cluster-wide majority
  sees a drop under 0.8 of the best (interference), every rank swaps to
  the next alternative strategy, or installs the latency-MST tree, in
  lockstep (reference ``session/adaptiveStrategies.go:57-121``,
  ``tensorflow/ops/cpu/adaptation.cpp``);
* :func:`monitored_all_reduce` (:164) is an allreduce and a driver step
  in one call;
* :class:`DeviceStrategyDriver` (:173) re-tunes the device plane's
  allreduce schedule when the step time regresses.

The host swap is fenced as the reference's ``SetGlobalStrategy``
(``session/adaptation.go:8-28``): the majority vote is an allreduce, so
every rank reaches the same verdict; the ranks agree on the proposed
strategy by a consensus digest, barrier, then swap.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.monitor.adapt import (
    INTERFERENCE_THRESHOLD,
    check_interference,
    majority_vote_interference,
    minimum_spanning_tree_from_latencies,
)
from kungfu_tpu_torch.plan.strategy import Strategy
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("kungfu_tpu_torch.adaptive")

#: default swap rotation; a rotation keeps swapping meaningful when
#: interference persists across several strategies
DEFAULT_ALTERNATIVES = (
    Strategy.BINARY_TREE_STAR,
    Strategy.MULTI_BINARY_TREE_STAR,
    Strategy.RING,
    Strategy.STAR,
)


class AdaptiveStrategyDriver:
    """Per-rank driver over the host engine; every rank constructs one
    with the same arguments and calls :meth:`step` at the same points of
    the loop (the decisions are collective).

    Typical loop::

        driver = AdaptiveStrategyDriver(peer, check_every=32)
        for step in range(steps):
            grads = engine.all_reduce(grads, op="mean")
            driver.step()          # may swap the strategy in lockstep
    """

    def __init__(
        self,
        peer,
        check_every: int = 32,
        alternatives: Sequence[Strategy] = DEFAULT_ALTERNATIVES,
        threshold: float = INTERFERENCE_THRESHOLD,
        use_mst: bool = False,
        min_steps_between_swaps: int = 2,
        consecutive_drops: int = 2,
    ):
        self.peer = peer
        self.check_every = max(1, check_every)
        self.alternatives = list(alternatives)
        self.threshold = threshold
        self.use_mst = use_mst
        self.min_checks_between_swaps = max(1, min_steps_between_swaps)
        #: windows under the threshold in a row before this rank votes
        #: "interference": one noisy window must not swap the cluster
        self.consecutive_drops = max(1, consecutive_drops)
        self._drops = 0
        self._step = 0
        self._checks_since_swap = self.min_checks_between_swaps
        self._alt_idx = 0  # rotation cursor over `alternatives`
        self.swaps = 0

    def step(self) -> bool:
        """Call once per training step; True when a strategy swap
        happened (collectively, on every rank)."""
        self._step += 1
        if self._step % self.check_every:
            return False
        engine = self.peer.engine()
        if engine is None:
            return False
        dropped = bool(check_interference(engine, threshold=self.threshold))
        self._drops = self._drops + 1 if dropped else 0
        suspected = self._drops >= self.consecutive_drops
        # the vote is an allreduce: every rank computes the same verdict
        agreed = majority_vote_interference(self.peer, suspected)
        self._checks_since_swap += 1
        if not agreed:
            return False
        if self._checks_since_swap < self.min_checks_between_swaps:
            # a fresh strategy needs a window to set its own best
            return False
        if not self._swap(engine):
            # agreed interference but nothing to swap to: no phantom swap
            return False
        self._checks_since_swap = 0
        self._drops = 0
        self.swaps += 1
        return True

    def _next_strategy(self, engine) -> Optional[Strategy]:
        """The next alternative in rotation that is not installed."""
        cur = engine.strategy
        n = len(self.alternatives)
        for _ in range(n):
            s = self.alternatives[self._alt_idx % n]
            self._alt_idx += 1
            if s != cur:
                return s
        return None

    def _swap(self, engine) -> bool:
        """Whether a topology or strategy change was installed."""
        if self.use_mst:
            # min of three pings per edge filters a scheduler spike on a
            # loaded host but keeps an injected floor.  The matrix is
            # allgathered, so every rank computes the same MST;
            # peer.set_tree runs the consensus and barrier
            forest = minimum_spanning_tree_from_latencies(self.peer, samples=3)
            self.peer.set_tree(forest)
            _log.info("interference: installed latency-MST tree %s", forest)
            return True
        target = self._next_strategy(engine)
        if target is None:
            _log.warning("interference agreed but no alternative strategy")
            return False
        digest = f"strategy:{target.name}".encode()
        if not self.peer.consensus_bytes(digest, name="adapt-swap"):
            raise RuntimeError(
                f"peers disagree on the strategy swap target {target.name}")
        self.peer.barrier()
        engine.set_strategy(target)
        _log.info("interference: swapped strategy to %s", target.name)
        return True


def monitored_all_reduce(engine, x: np.ndarray, driver: AdaptiveStrategyDriver,
                         op: str = "sum", name: str = "") -> np.ndarray:
    """Allreduce and adaptation step in one call (the reference's
    ``MonitoredAllReduce`` op, ``collective.go:16-157``)."""
    out = engine.all_reduce(x, op=op, name=name)
    driver.step()
    return out


class DeviceStrategyDriver:
    """Feed it every step's measured seconds (:meth:`observe`).  Every
    ``check_every`` steps it takes the window's median; when that
    regresses past ``regression`` times the baseline (an EMA of healthy
    medians) for ``consecutive`` checks, as agreed by a majority vote
    over the mesh, it re-runs :meth:`Communicator.autotune_strategy
    <kungfu_tpu_torch.comm.device.Communicator.autotune_strategy>` and
    reports True, so the caller rebuilds its step with
    ``schedule=comm.strategy``.  The first window after a (re)build holds
    the warm-up and is discarded, and the next seeds a fresh baseline, so
    a new schedule gets a clean window before it is judged.  Every
    controller calls :meth:`observe` every step (the vote is a
    collective); one process votes for all its ranks.

    Typical loop::

        driver = DeviceStrategyDriver(comm)
        step = make_step(comm.strategy)
        for batch in data:
            t0 = time.perf_counter(); ...step...; dt = time.perf_counter()-t0
            if driver.observe(dt):
                step = make_step(comm.strategy)
    """

    def __init__(self, comm, check_every: int = 64, regression: float = 1.3,
                 consecutive: int = 2, ema: float = 0.1,
                 autotune_nbytes: int = 4 << 20):
        self.comm = comm
        self.check_every = max(1, check_every)
        self.regression = regression
        self.consecutive = max(1, consecutive)
        self.ema = ema
        self.autotune_nbytes = autotune_nbytes
        self._baseline = None  # EMA of healthy window medians
        self._warmed = False  # the first window holds the warm-up
        self._window = []
        self._step = 0
        self._drops = 0
        self.swaps = 0

    def _vote(self, suspected: bool) -> bool:
        """The mesh's majority on this window's verdict: every rank's
        vote, summed by an allreduce."""
        votes = torch.full((self.comm.size, 1), 1.0 if suspected else 0.0,
                           device=self.comm.device)
        total = float(self.comm.all_reduce(votes)[0, 0])
        return total * 2 > self.comm.size

    def observe(self, step_seconds: float) -> bool:
        """Feed one measured step time; True when the schedule was
        re-tuned (rebuild the step)."""
        self._window.append(step_seconds)
        self._step += 1
        if self._step % self.check_every:
            return False
        med = sorted(self._window)[len(self._window) // 2]
        self._window = []
        if not self._warmed:
            self._warmed = True
            self._vote(False)  # every check votes
            return False
        if self._baseline is None:
            self._baseline = med
            self._vote(False)
            return False
        regressed = med > self.regression * self._baseline
        agreed = self._vote(regressed)
        if not agreed:
            if not regressed:
                # a healthy window tracks slow drift
                self._baseline = ((1 - self.ema) * self._baseline
                                  + self.ema * med)
            self._drops = 0
            return False
        self._drops += 1
        if self._drops < self.consecutive:
            return False
        before = self.comm.strategy
        ratio = med / self._baseline
        winner = self.comm.autotune_strategy(nbytes=self.autotune_nbytes)
        self._drops = 0
        # the new schedule sets its own baseline after a discarded window
        self._baseline = None
        self._warmed = False
        self.swaps += 1
        _log.info("device step-time regression %.2fx: autotune %s -> %s",
                  ratio, before, winner)
        return True
