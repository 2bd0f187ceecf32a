"""Step-time-driven re-tuning of the device plane's allreduce schedule.

Port of ``kungfu_tpu/monitor/adaptive.py:173 DeviceStrategyDriver``.
The host-plane ``AdaptiveStrategyDriver`` (:55) watches the host
engine's per-strategy throughput and comes with that engine.
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("kungfu_tpu_torch.adaptive")


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
