"""Adaptation policies (copy of ``kungfu_tpu/policy/__init__.py``'s
exports).

A :class:`BasePolicy` has before/after train/epoch/step callbacks
(reference ``kungfu/tensorflow/policy/{base_policy,policy_hook}.py``);
a :class:`PolicyRunner` drives them, keeps the named training globals
(batch size, trained samples, gradient noise scale) and executes their
resize and stop intents through the elastic protocol.

The serving policies (``BatchWidthController``, ``ServeAutoscalePolicy``,
``serve_signals``) steer the serving plane from the aggregator's view.
``sentinel_signals`` comes with the sentinel (ROADMAP A9b); until then
that name raises ``NotImplementedError``.
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

#: lazy names of the reference's package, with the ROADMAP item that
#: ports each
_NOT_PORTED = {
    "sentinel_signals": "A9b (policy/sentinel.py, with the sentinel)",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"kungfu_tpu_torch.policy.{name} waits for ROADMAP "
            f"{_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
