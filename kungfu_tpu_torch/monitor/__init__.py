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
#: chaos, whose injector imports this package for the timeline.  The
#: detector, the registry and the heartbeat senders load the same way,
#: so that importing this package for the timeline pulls in nothing else
_LAZY = {
    "DeviceBanditDriver": "kungfu_tpu_torch.monitor.adapt_device",
    "HostBanditDriver": "kungfu_tpu_torch.monitor.adapt_device",
    "DetectorServer": "kungfu_tpu_torch.monitor.detector",
    "DetectorResults": "kungfu_tpu_torch.monitor.detector",
    "DEFAULT_DETECTOR_PORT": "kungfu_tpu_torch.monitor.detector",
    "REGISTRY": "kungfu_tpu_torch.monitor.registry",
    "monitor_batch_begin": "kungfu_tpu_torch.monitor.signals",
    "monitor_batch_end": "kungfu_tpu_torch.monitor.signals",
    "monitor_compile_grace": "kungfu_tpu_torch.monitor.signals",
    "monitor_epoch_end": "kungfu_tpu_torch.monitor.signals",
    "monitor_train_end": "kungfu_tpu_torch.monitor.signals",
}
__all__ += list(_LAZY)


def __getattr__(name):
    # each name of _LAZY loads its module on first use, so no import
    # cycle can close through this package
    src = _LAZY.get(name)
    if src is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(src), name)
    globals()[name] = value
    return value

