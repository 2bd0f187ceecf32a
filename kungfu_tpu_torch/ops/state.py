"""Stateful scalar ops, functional style.

Port of ``kungfu_tpu/ops/state.py:16-45``: a counter and an exponential
moving average whose state is explicit, ``new_state, value = f(state,
...)``, carried in the optimizer state tree.  The first EMA sample sets
the value.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kungfu_tpu_torch.utils.device import resolve_device


class CounterState(NamedTuple):
    step: torch.Tensor  # int32


def counter(state: Optional[CounterState] = None, incr: int = 1,
            device=None):
    """``(new_state, value_before_increment)``.  A new counter (``state``
    None) lives on ``device`` (default ``cuda``)."""
    if state is None:
        dev = resolve_device(device)
        return (CounterState(torch.tensor(incr, dtype=torch.int32,
                                          device=dev)),
                torch.tensor(0, dtype=torch.int32, device=dev))
    return CounterState(state.step + incr), state.step


class EMAState(NamedTuple):
    value: torch.Tensor
    initialized: torch.Tensor  # bool


def ema_init(shape=(), dtype=torch.float32, device=None) -> EMAState:
    """Zeros, not yet initialized, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return EMAState(torch.zeros(shape, dtype=dtype, device=dev),
                    torch.tensor(False, device=dev))


def exponential_moving_average(state: EMAState, x, alpha: float = 0.01):
    """``v <- (1 - alpha) v + alpha x``; the first sample sets ``v = x``.
    Returns ``(state, value)``."""
    v = state.value
    x = torch.as_tensor(x, dtype=v.dtype, device=v.device)
    new = torch.where(state.initialized, (1 - alpha) * v + alpha * x, x)
    return EMAState(new, torch.ones_like(state.initialized)), new
