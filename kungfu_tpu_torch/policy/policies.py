"""Concrete adaptation policies.

Copy of ``kungfu_tpu/policy/policies.py``.  :class:`ScheduledSizePolicy`
is the policy form of the reference's ``StepBasedSchedule`` elastic
hook; :class:`AdaptiveStrategyPolicy` runs the host plane's
:class:`~kungfu_tpu_torch.monitor.adaptive.AdaptiveStrategyDriver`;
:class:`GNSResizePolicy` grows the cluster when the gradient noise scale
says larger batches would still help, and shrinks it when it says they
are wasted.
"""

from __future__ import annotations

from typing import Optional

from kungfu_tpu_torch.elastic.schedule import step_based_schedule
from kungfu_tpu_torch.policy.base import BasePolicy, PolicyContext


class ScheduledSizePolicy(BasePolicy):
    """Propose the size given by a ``"size:steps,..."`` schedule."""

    def __init__(self, schedule: str):
        self.schedule = schedule

    def after_step(self, ctx: PolicyContext) -> None:
        target = step_based_schedule(self.schedule, ctx.step)
        if target != ctx.cluster_size:
            ctx.request_resize(target)


class AdaptiveStrategyPolicy(BasePolicy):
    """Policy form of the closed adaptation loop: run the
    :class:`~kungfu_tpu_torch.monitor.adaptive.AdaptiveStrategyDriver` after
    every step (it self-paces via ``check_every``).  Every rank's policy
    runner must drive it at the same step points — the swap decision is a
    collective."""

    def __init__(self, peer, **driver_kwargs):
        from kungfu_tpu_torch.monitor.adaptive import AdaptiveStrategyDriver

        self.driver = AdaptiveStrategyDriver(peer, **driver_kwargs)

    def after_step(self, ctx: PolicyContext) -> None:
        if self.driver.step():
            ctx.metrics["strategy_swaps"] = float(self.driver.swaps)


class GNSResizePolicy(BasePolicy):
    """Resize toward ``gns / batch_size`` workers, within bounds.

    The critical-batch heuristic (OpenAI GNS estimator, reference
    ``grad_noise_scale.py``): efficiency drops once the global batch
    exceeds the noise scale, so the useful worker count is about
    ``gns / per_worker_batch``.  Hysteresis: only move when the target
    differs from the current size by ``threshold`` (fraction)."""

    def __init__(
        self,
        min_size: int = 1,
        max_size: int = 64,
        threshold: float = 0.5,
        cooldown_steps: int = 10,
    ):
        self.min_size = min_size
        self.max_size = max_size
        self.threshold = threshold
        self.cooldown_steps = cooldown_steps
        self._last_change: Optional[int] = None

    def target_size(self, ctx: PolicyContext) -> Optional[int]:
        gns, bs = ctx.gradient_noise_scale, ctx.batch_size
        if not gns or gns <= 0 or bs <= 0:
            return None
        want = max(self.min_size, min(self.max_size, round(gns / bs)))
        lo = ctx.cluster_size * (1 - self.threshold)
        hi = ctx.cluster_size * (1 + self.threshold)
        if lo <= want <= hi:
            return None  # within hysteresis band
        return want

    def after_step(self, ctx: PolicyContext) -> None:
        if (
            self._last_change is not None
            and ctx.step - self._last_change < self.cooldown_steps
        ):
            return
        want = self.target_size(ctx)
        if want is not None and want != ctx.cluster_size:
            self._last_change = ctx.step
            ctx.request_resize(want)
