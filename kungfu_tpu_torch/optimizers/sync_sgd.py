"""Synchronous SGD — allreduce gradients, then the inner update.

Port of ``kungfu_tpu/optimizers/sync_sgd.py:10 synchronous_sgd``.
"""

from __future__ import annotations

from kungfu_tpu_torch.ops.collective import current_world, replicated
from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.ops.schedules import all_reduce_scheduled
from kungfu_tpu_torch.optimizers._transform import GradientTransformation


def synchronous_sgd(inner: GradientTransformation, axis,
                    average: bool = True, schedule: str = "psum",
                    fuse_grads: bool = False) -> GradientTransformation:
    """The S-SGD wrapper: allreduce the gradients over ``axis`` (mean, or
    sum with ``average=False``) with ``schedule``, then ``inner``.
    ``fuse_grads=True`` packs the gradient tree into one flat buffer for
    the collective (:func:`~kungfu_tpu_torch.ops.fuse.fuse`).

    Inside a rank world the gradients arrive stacked ``[n, ...]``, one
    row per rank; the reduced gradient is the same on every rank, so
    ``inner`` sees it once (:func:`~kungfu_tpu_torch.ops.collective.
    replicated`) and updates the replicated params and state once."""

    def init(params):
        return inner.init(params)

    def update(grads, state, params=None):
        op = "mean" if average else "sum"
        if fuse_grads:
            stacked = current_world() is not None
            buf, spec = fuse(grads, batch_axes=int(stacked))
            buf = all_reduce_scheduled(buf, axis, op=op, schedule=schedule)
            if stacked:  # one row, defused to the unstacked leaves
                buf = replicated(buf)
                spec = spec._replace(shapes=tuple(s[1:] for s in spec.shapes))
            grads = defuse(buf, spec)
        else:
            grads = replicated(all_reduce_scheduled(grads, axis, op=op,
                                                    schedule=schedule))
        return inner.update(grads, state, params)

    return GradientTransformation(init, update)
