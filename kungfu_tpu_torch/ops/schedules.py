"""Allreduce schedules: the ``psum`` arm of ``all_reduce_scheduled``.

Port of ``kungfu_tpu/ops/schedules.py:445 all_reduce_scheduled``.  The
reference decomposes the collective in-program for its ``two_stage``,
``ring`` and ``pallas_ring`` schedules; those arms need a world larger
than one card and come with the data-parallel slice (port slice 4).
"""

from __future__ import annotations

from kungfu_tpu_torch.ops.collective import _OPS, Axis, all_reduce

#: the reference's schedule names (``ops/schedules.py:49``)
ALLREDUCE_SCHEDULES = ("psum", "two_stage", "ring", "pallas_ring")


def all_reduce_scheduled(x, axis: Axis, op: str = "sum",
                         schedule: str = "psum"):
    """Allreduce a tensor or tree across ``axis`` with an explicit
    schedule; ``psum`` is :func:`~kungfu_tpu_torch.ops.collective.
    all_reduce`, every other schedule raises."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    if schedule not in ALLREDUCE_SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; one of {ALLREDUCE_SCHEDULES}")
    if schedule != "psum":
        raise NotImplementedError(
            f"allreduce schedule {schedule!r} comes with the data-parallel "
            "slice (port slice 4); only 'psum' is ported")
    return all_reduce(x, axis, op=op)
