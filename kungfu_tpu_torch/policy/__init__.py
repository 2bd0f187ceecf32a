"""Adaptation policies (copy of ``kungfu_tpu/policy/__init__.py``'s
exports).

A :class:`BasePolicy` has before/after train/epoch/step callbacks
(reference ``kungfu/tensorflow/policy/{base_policy,policy_hook}.py``);
a :class:`PolicyRunner` drives them, keeps the named training globals
(batch size, trained samples, gradient noise scale) and executes their
resize and stop intents through the elastic protocol.

The serving policies (``BatchWidthController``, ``ServeAutoscalePolicy``,
``serve_signals``) come with the router (ROADMAP A3), and
``sentinel_signals`` with the sentinel (ROADMAP A9); until then those
names raise ``NotImplementedError``.
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

#: lazy names of the reference's package, with the ROADMAP item that
#: ports each
_NOT_PORTED = {
    "BatchWidthController": "A3 (policy/serve.py, with the router)",
    "ServeAutoscalePolicy": "A3 (policy/serve.py, with the router)",
    "serve_signals": "A3 (policy/serve.py, with the router)",
    "sentinel_signals": "A9 (policy/sentinel.py, with the sentinel)",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"kungfu_tpu_torch.policy.{name} waits for ROADMAP "
            f"{_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
