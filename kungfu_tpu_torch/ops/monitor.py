"""Training-statistics reductions: the gradient noise scale and the
cross-replica gradient variance.

Port of ``kungfu_tpu/ops/monitor.py``: ``_sq_norm`` (:22), the square
norm the pulse monitor samples, ``global_noise_scale`` (:55) and
``group_all_reduce_with_variance`` (:81).  Inside a rank world the
gradients are stacked ``[n, ...]``; each rank's square norm is its own
row's (:func:`rank_sq_norms`), never the sum over the stack, and every
per-rank result is stacked ``[n]``, as each device holds its own in the
reference.  ``host_noise_scale`` (:27) runs the same estimator over the
host collective engine (:mod:`kungfu_tpu_torch.comm.engine`), its square
norms in f64 numpy as the reference takes them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kungfu_tpu_torch.monitor import pulse
from kungfu_tpu_torch.monitor.pulse import GNS_EPS
from kungfu_tpu_torch.ops.collective import (all_reduce, current_world,
                                             peer_size)
from kungfu_tpu_torch.utils.tree import tree_leaves


def _sq_norm(tree) -> torch.Tensor:
    """Sum of squares over every leaf, in f32 (a 0-d tensor)."""
    return sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))


def _f64(x) -> np.ndarray:
    """A host buffer (a CPU tensor of any float dtype, or an array) as
    f64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def host_noise_scale(engine, local_flat, avg_flat, local_batch_size):
    """Gradient-noise-scale estimate over the host collective plane
    (reference ``ops/monitor.py:27``): the OpenAI estimator of
    :func:`global_noise_scale`, with the cross-peer mean of the local
    square norms taken by the
    :class:`~kungfu_tpu_torch.comm.engine.CollectiveEngine`.

    ``local_flat``: this worker's fused local gradient; ``avg_flat``: the
    allreduced mean gradient the step applied (CPU tensors or numpy
    arrays).  Every worker calls this at the same step point, since the
    inner mean is a collective.  Returns the raw estimate
    (:func:`kungfu_tpu_torch.monitor.pulse.noise_scale`), ``None`` on a
    single worker."""
    n = len(engine.peers)
    g_local_sq = float(np.sum(np.square(_f64(local_flat))))
    g_local_sq = float(
        engine.all_reduce(
            np.array([g_local_sq], np.float64), op="mean", record=False
        )[0]
    )
    g_global_sq = float(np.sum(np.square(_f64(avg_flat))))
    return pulse.noise_scale(g_local_sq, g_global_sq, local_batch_size, n)


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
