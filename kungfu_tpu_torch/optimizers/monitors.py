"""Monitoring optimizers: S-SGD whose state carries a training
statistic.

Port of ``kungfu_tpu/optimizers/monitors.py``: ``monitor_gradient_noise_
scale`` (:28, the OpenAI gradient-noise-scale estimator smoothed by an
EMA) and ``monitor_gradient_variance`` (:61).  Inside a rank world the
gradients arrive stacked ``[n, ...]``; the mean gradient and the
statistic are the same on every rank, so ``inner`` sees them once
(:func:`~kungfu_tpu_torch.ops.collective.replicated`), as
``synchronous_sgd`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kungfu_tpu_torch.ops.collective import group_all_reduce, replicated
from kungfu_tpu_torch.ops.monitor import (global_noise_scale,
                                          group_all_reduce_with_variance)
from kungfu_tpu_torch.ops.state import (EMAState, ema_init,
                                        exponential_moving_average)
from kungfu_tpu_torch.optimizers._transform import GradientTransformation
from kungfu_tpu_torch.utils.tree import tree_leaves


def _device(params):
    return tree_leaves(params)[0].device


class GNSState(NamedTuple):
    inner: object
    ema: EMAState
    noise_scale: torch.Tensor  # the smoothed estimate


def monitor_gradient_noise_scale(inner: GradientTransformation, axis,
                                 local_batch_size: int,
                                 ema_alpha: float = 0.01
                                 ) -> GradientTransformation:
    """S-SGD whose state also carries the smoothed gradient noise scale
    (``state.noise_scale``); at one rank the estimate does not exist and
    the EMA is carried unchanged."""

    def init(params):
        dev = _device(params)
        return GNSState(inner.init(params), ema_init(device=dev),
                        torch.zeros((), dtype=torch.float32, device=dev))

    def update(grads, state, params=None):
        avg = group_all_reduce(grads, axis, op="mean")
        raw = global_noise_scale(grads, avg, local_batch_size, axis)
        updates, new_inner = inner.update(replicated(avg), state.inner,
                                          params)
        if raw is None:
            return updates, GNSState(new_inner, state.ema, state.noise_scale)
        new_ema, smoothed = exponential_moving_average(
            state.ema, replicated(raw), ema_alpha)
        return updates, GNSState(new_inner, new_ema, smoothed)

    return GradientTransformation(init, update)


class GradVarianceState(NamedTuple):
    inner: object
    variance: torch.Tensor


def monitor_gradient_variance(inner: GradientTransformation, axis
                              ) -> GradientTransformation:
    """S-SGD whose state carries the cross-rank gradient variance."""

    def init(params):
        return GradVarianceState(
            inner.init(params),
            torch.zeros((), dtype=torch.float32, device=_device(params)))

    def update(grads, state, params=None):
        avg, var = group_all_reduce_with_variance(grads, axis)
        updates, new_inner = inner.update(replicated(avg), state.inner,
                                          params)
        return updates, GradVarianceState(new_inner, replicated(var))

    return GradientTransformation(init, update)
