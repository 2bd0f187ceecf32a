"""Policy interface and the mutable training context.

Copy of ``kungfu_tpu/policy/base.py``.  The reference's
``policy/base_policy.py`` defines before/after train/epoch/step hooks,
and ``policy_hook.py:8-77`` threads the training globals (batch size,
trained samples) through them.  Here the globals live on a plain
:class:`PolicyContext`: policies read metrics and record intents on it,
and the :class:`~kungfu_tpu_torch.policy.runner.PolicyRunner` applies
the intents.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class PolicyContext:
    """Named training globals (reference ``variables.py``) + intents."""

    batch_size: int = 0
    trained_samples: int = 0
    step: int = 0
    epoch: int = 0
    cluster_size: int = 1
    gradient_noise_scale: Optional[float] = None
    gradient_variance: Optional[float] = None
    metrics: Dict[str, float] = field(default_factory=dict)

    # intents — consumed (and reset) by the runner after each callback
    requested_size: Optional[int] = None
    stop_requested: bool = False

    def request_resize(self, new_size: int) -> None:
        self.requested_size = int(new_size)

    def request_stop(self) -> None:
        self.stop_requested = True


class BasePolicy:
    """Override any subset; every hook receives the shared context
    (reference ``BasePolicy`` before/after train/epoch/step interface)."""

    def before_train(self, ctx: PolicyContext) -> None:  # noqa: B027
        pass

    def after_train(self, ctx: PolicyContext) -> None:  # noqa: B027
        pass

    def before_epoch(self, ctx: PolicyContext) -> None:  # noqa: B027
        pass

    def after_epoch(self, ctx: PolicyContext) -> None:  # noqa: B027
        pass

    def before_step(self, ctx: PolicyContext) -> None:  # noqa: B027
        pass

    def after_step(self, ctx: PolicyContext) -> None:  # noqa: B027
        pass
