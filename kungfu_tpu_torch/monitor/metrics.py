"""Device-memory gauges (trimmed copy of ``kungfu_tpu/monitor/metrics.py``).

Only :func:`publish_device_memory` is ported: the peer's
:class:`~kungfu_tpu_torch.monitor.aggregator.RankReporter` calls it
before every snapshot.  ``NetMonitor`` and the metrics server come with
ROADMAP A9.
"""

from __future__ import annotations

from kungfu_tpu_torch.monitor.registry import REGISTRY


def publish_device_memory() -> bool:
    """Poll the local cards' allocator into the registry:
    ``kf_device_memory_bytes{kind="in_use"|"limit"}`` summed over the
    visible CUDA devices (``torch.cuda.memory_allocated`` and each
    device's total memory).  Returns False, publishing nothing, where
    there is no CUDA device, as the reference's does on a CPU backend;
    it never raises, because a raise in the reporter's
    ``pre_snapshot_fn`` would cost the snapshot its event window."""
    try:
        import torch

        if not torch.cuda.is_available():
            return False
        n = torch.cuda.device_count()
        in_use = sum(int(torch.cuda.memory_allocated(d)) for d in range(n))
        limit = sum(int(torch.cuda.get_device_properties(d).total_memory)
                    for d in range(n))
    except Exception:  # noqa: BLE001 - monitoring must not raise
        return False
    if n == 0:
        return False
    REGISTRY.gauge("kf_device_memory_bytes", kind="in_use").set(in_use)
    if limit:
        REGISTRY.gauge("kf_device_memory_bytes", kind="limit").set(limit)
    return True
