"""Synchronous model averaging (SMA / EA-SGD).

Port of ``kungfu_tpu/optimizers/sma_sgd.py:19 synchronous_averaging``:
each step averages the *weights* over the ranks, pulls each replica
towards the average by ``alpha`` and applies its local gradients.  The
params, state and gradients are stacked per replica (``dp_train_step(
..., replicated_params=False)``); the average is the plain reduction over
the stacked axis (:func:`~kungfu_tpu_torch.ops.collective.all_reduce`,
the reference's ``psum``).
"""

from __future__ import annotations

from kungfu_tpu_torch.ops.collective import all_reduce
from kungfu_tpu_torch.optimizers._transform import GradientTransformation
from kungfu_tpu_torch.utils.tree import tree_map

DEFAULT_ALPHA = 0.1  # reference sma_sgd.py


def synchronous_averaging(inner: GradientTransformation, axis,
                          alpha: float = DEFAULT_ALPHA
                          ) -> GradientTransformation:
    def update(grads, state, params):
        if params is None:
            raise ValueError("synchronous_averaging requires params")
        avg = all_reduce(params, axis, op="mean")
        inner_updates, new_state = inner.update(grads, state, params)
        updates = tree_map(lambda u, p, a: u + alpha * (a - p).to(u.dtype),
                           inner_updates, params, avg)
        return updates, new_state

    return GradientTransformation(inner.init, update)
