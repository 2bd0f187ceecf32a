"""Metrics registry, flight-recorder timeline and pulse (trimmed copies),
the straggler math (:mod:`~kungfu_tpu_torch.monitor.skew`), the
adaptation signals (:mod:`~kungfu_tpu_torch.monitor.adapt`), the
strategy drivers of both planes and the UCB bandit drivers; the
sentinel plane (:mod:`~kungfu_tpu_torch.monitor.sentinel` over
``detect``, ``history`` and the decision ``ledger``) and its tools, run
as ``python -m kungfu_tpu_torch.monitor.{kfhist,kftop,traceview}``."""

from kungfu_tpu_torch.monitor.adaptive import (
    AdaptiveStrategyDriver,
    DeviceStrategyDriver,
    monitored_all_reduce,
)

__all__ = ["AdaptiveStrategyDriver", "DeviceStrategyDriver",
           "monitored_all_reduce"]

#: the bandit drivers, exported lazily as the reference's are
#: (``kungfu_tpu/monitor/__init__.py:55-71``): adapt_device imports the
#: policy package, whose runner imports elastic.hooks, which imports
#: chaos, whose injector imports this package for the timeline
_LAZY_BANDIT = ("DeviceBanditDriver", "HostBanditDriver")
__all__ += list(_LAZY_BANDIT)


def __getattr__(name):
    if name in _LAZY_BANDIT:
        from kungfu_tpu_torch.monitor import adapt_device

        return getattr(adapt_device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
