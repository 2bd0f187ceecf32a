"""The collective ops over co-resident stacked ranks, the cost model and
the hand-written CUDA and Triton kernels (``ops/cuda``, ``ops/triton``).

The package exports the reference's fifteen names
(``kungfu_tpu/ops/__init__.py``): the rank-world collectives of
:mod:`~kungfu_tpu_torch.ops.collective`, the schedules, ``fuse`` /
``defuse``, the gradient-noise monitors and the state ops.  ``fuse`` and
``defuse`` bind at import, as the reference's do (the function shadows
its module's name, as there); the rest load on first use.
"""

from kungfu_tpu_torch.ops.fuse import defuse, fuse

_LAZY = {
    "all_reduce": "kungfu_tpu_torch.ops.collective",
    "group_all_reduce": "kungfu_tpu_torch.ops.collective",
    "all_gather": "kungfu_tpu_torch.ops.collective",
    "broadcast": "kungfu_tpu_torch.ops.collective",
    "barrier_value": "kungfu_tpu_torch.ops.collective",
    "peer_rank": "kungfu_tpu_torch.ops.collective",
    "peer_size": "kungfu_tpu_torch.ops.collective",
    "ALLREDUCE_SCHEDULES": "kungfu_tpu_torch.ops.schedules",
    "all_reduce_scheduled": "kungfu_tpu_torch.ops.schedules",
    "global_noise_scale": "kungfu_tpu_torch.ops.monitor",
    "group_all_reduce_with_variance": "kungfu_tpu_torch.ops.monitor",
    "counter": "kungfu_tpu_torch.ops.state",
    "exponential_moving_average": "kungfu_tpu_torch.ops.state",
}

__all__ = ["all_reduce", "group_all_reduce", "all_gather", "broadcast",
           "barrier_value", "peer_rank", "peer_size", "ALLREDUCE_SCHEDULES",
           "all_reduce_scheduled", "fuse", "defuse", "global_noise_scale",
           "group_all_reduce_with_variance", "counter",
           "exponential_moving_average"]


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
