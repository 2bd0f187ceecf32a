"""AdaptiveSGD: SMA early, S-SGD late.

Port of ``kungfu_tpu/optimizers/ada_sgd.py:28 adaptive_sgd``: model
averaging before ``change_step``, one full pull (``alpha`` = 1) at it,
which re-synchronises the replicas, and synchronous SGD after.  Both
averages (of the weights and of the gradients) are taken on every step
and each rank picks its own by its step count with ``where``, as the
reference's uniform SPMD program does: a branch on the host would read
the count back every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kungfu_tpu_torch.ops.collective import (all_reduce, group_all_reduce,
                                             rank_view)
from kungfu_tpu_torch.optimizers._transform import GradientTransformation
from kungfu_tpu_torch.optimizers.sma_sgd import DEFAULT_ALPHA
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map


class AdaptiveSGDState(NamedTuple):
    step: torch.Tensor  # int32; [n] when stacked per replica
    inner: object


def adaptive_sgd(inner: GradientTransformation, axis, change_step: int,
                 alpha: float = DEFAULT_ALPHA) -> GradientTransformation:
    def init(params):
        first = tree_leaves(params)[0]
        return AdaptiveSGDState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            inner.init(params))

    def update(grads, state, params):
        if params is None:
            raise ValueError("adaptive_sgd requires params")
        step = state.step
        in_sma = step < change_step
        at_switch = step == change_step
        avg = all_reduce(params, axis, op="mean")
        sync_grads = group_all_reduce(grads, axis, op="mean")
        used = tree_map(lambda g, sg: torch.where(rank_view(in_sma, g), g, sg),
                        grads, sync_grads)
        inner_updates, new_inner = inner.update(used, state.inner, params)
        # the pull: alpha while averaging, 1 at the switch, 0 after
        one = torch.ones_like(step, dtype=torch.float32)
        pull = torch.where(in_sma, one * alpha,
                           torch.where(at_switch, one, one * 0.0))
        updates = tree_map(
            lambda u, p, a: u + (rank_view(pull, u) * (a - p)).to(u.dtype),
            inner_updates, params, avg)
        return updates, AdaptiveSGDState(step + 1, new_inner)

    return GradientTransformation(init, update)
