"""Synchronous SGD — allreduce gradients, then the inner update.

Port of ``kungfu_tpu/optimizers/sync_sgd.py:10 synchronous_sgd``.
"""

from __future__ import annotations

from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.ops.schedules import all_reduce_scheduled
from kungfu_tpu_torch.optimizers._transform import GradientTransformation


def synchronous_sgd(inner: GradientTransformation, axis,
                    average: bool = True, schedule: str = "psum",
                    fuse_grads: bool = False) -> GradientTransformation:
    """The S-SGD wrapper: allreduce the gradients over ``axis`` (mean, or
    sum with ``average=False``) with ``schedule``, then ``inner``.
    ``fuse_grads=True`` packs the gradient tree into one flat buffer for
    the collective (:func:`~kungfu_tpu_torch.ops.fuse.fuse`)."""

    def init(params):
        return inner.init(params)

    def update(grads, state, params=None):
        op = "mean" if average else "sum"
        if fuse_grads:
            buf, spec = fuse(grads)
            buf = all_reduce_scheduled(buf, axis, op=op, schedule=schedule)
            grads = defuse(buf, spec)
        else:
            grads = all_reduce_scheduled(grads, axis, op=op, schedule=schedule)
        return inner.update(grads, state, params)

    return GradientTransformation(init, update)
