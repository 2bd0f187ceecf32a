"""Metrics registry, flight-recorder timeline and pulse (trimmed copies),
and the device plane's strategy driver."""

from kungfu_tpu_torch.monitor.adaptive import DeviceStrategyDriver

__all__ = ["DeviceStrategyDriver"]
