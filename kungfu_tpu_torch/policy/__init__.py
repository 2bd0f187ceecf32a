"""Adaptation policies (copy of ``kungfu_tpu/policy/__init__.py``'s
exports).

A :class:`BasePolicy` has before/after train/epoch/step callbacks
(reference ``kungfu/tensorflow/policy/{base_policy,policy_hook}.py``);
a :class:`PolicyRunner` drives them, keeps the named training globals
(batch size, trained samples, gradient noise scale) and executes their
resize and stop intents through the elastic protocol.

The serving policies (``BatchWidthController``, ``ServeAutoscalePolicy``,
``serve_signals``) steer the serving plane from the aggregator's view;
``sentinel_signals`` reads the sentinel's alert state from it.
"""

from kungfu_tpu_torch.policy.base import BasePolicy, PolicyContext  # noqa: F401
from kungfu_tpu_torch.policy.bandit import (  # noqa: F401
    ArmStats,
    CollectiveBanditPolicy,
    ScheduleTable,
)
from kungfu_tpu_torch.policy.policies import (  # noqa: F401
    AdaptiveStrategyPolicy,
    GNSResizePolicy,
    ScheduledSizePolicy,
)
from kungfu_tpu_torch.policy.runner import PolicyRunner  # noqa: F401
from kungfu_tpu_torch.policy.serve import (  # noqa: F401
    BatchWidthController,
    ServeAutoscalePolicy,
    serve_signals,
)


def __getattr__(name):
    # lazy, as the reference's export is
    if name == "sentinel_signals":
        from kungfu_tpu_torch.policy.sentinel import sentinel_signals

        return sentinel_signals
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
