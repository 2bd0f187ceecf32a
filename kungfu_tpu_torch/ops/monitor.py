"""Training-statistics reductions: the gradient noise scale and the
cross-replica gradient variance.

Port of ``kungfu_tpu/ops/monitor.py``: ``_sq_norm`` (:22), the square
norm the pulse monitor samples, ``global_noise_scale`` (:55) and
``group_all_reduce_with_variance`` (:81).  Inside a rank world the
gradients are stacked ``[n, ...]``; each rank's square norm is its own
row's (:func:`rank_sq_norms`), never the sum over the stack, and every
per-rank result is stacked ``[n]``, as each device holds its own in the
reference.  ``host_noise_scale`` (:27) rides the host collective engine
and comes with it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kungfu_tpu_torch.monitor.pulse import GNS_EPS
from kungfu_tpu_torch.ops.collective import (all_reduce, current_world,
                                             peer_size)
from kungfu_tpu_torch.utils.tree import tree_leaves


def _sq_norm(tree) -> torch.Tensor:
    """Sum of squares over every leaf, in f32 (a 0-d tensor)."""
    return sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))


def rank_sq_norms(tree) -> torch.Tensor:
    """Each rank's square norm of its own row of a stacked tree, f32
    ``[n]``, inside a rank world; :func:`_sq_norm` outside one."""
    world = current_world()
    if world is None:
        return _sq_norm(tree)
    return sum(torch.square(l.float()).reshape(world.n, -1).sum(1)
               for l in tree_leaves(tree))


def global_noise_scale(local_grads, avg_grads, local_batch_size, axis):
    """The raw gradient noise scale ``S / |G|^2`` of one step, per rank
    (``[n]``, every row alike): ``local_grads`` are each rank's gradients
    (batch ``b_small``), ``avg_grads`` their allreduced mean (batch
    ``b_big = n * b_small``).  Smooth it with
    :func:`~kungfu_tpu_torch.ops.state.exponential_moving_average`.
    ``None`` on one peer, where the two-batch estimator divides by
    zero."""
    n = peer_size(axis)
    if n <= 1:
        return None
    first = tree_leaves(local_grads)[0]
    b_small = torch.tensor(float(local_batch_size), dtype=torch.float32,
                           device=first.device)
    b_big = b_small * n
    # the local square norms are averaged, so every rank's estimate is
    # the same
    g_local_sq = all_reduce(rank_sq_norms(local_grads), axis, op="mean")
    g_global_sq = rank_sq_norms(avg_grads)
    g2 = (b_big * g_global_sq - b_small * g_local_sq) / (b_big - b_small)
    s = (g_local_sq - g_global_sq) / (1.0 / b_small - 1.0 / b_big)
    return s / (torch.abs(g2) + GNS_EPS)


def group_all_reduce_with_variance(grads, axis) -> Tuple:
    """Mean-allreduce the gradients and estimate the cross-rank variance
    ``E_i |g_i - g_avg|^2`` with one more reduction of square norms.
    Returns ``(avg_grads, variance)``, the variance clamped at 0."""
    avg = all_reduce(grads, axis, op="mean")
    mean_sq = all_reduce(rank_sq_norms(grads), axis, op="mean")
    var = mean_sq - rank_sq_norms(avg)
    return avg, torch.clamp(var, min=0.0)
