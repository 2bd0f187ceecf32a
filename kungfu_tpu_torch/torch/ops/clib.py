"""Dtype-keyed conversion between torch tensors and the host engine's
buffers (port of ``kungfu_tpu/torch/ops/clib.py``, reference
``kungfu/torch/ops/clib.py:10-35``).

Each supported torch dtype maps to a ``(to_np, from_np)`` pair.  numpy
holds these dtypes one to one; bfloat16, which numpy lacks, goes through
float32, which is exact for the reduce ops.  ``from_np`` returns a tensor
on the device of the tensor it is ``like``: a card tensor's result goes
back to the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _identity_pair():
    def to_np(t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(t.detach().cpu().numpy())

    def from_np(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=like.device, dtype=like.dtype)

    return to_np, from_np


def _via_f32_pair():
    def to_np(t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(t.detach().float().cpu().numpy())

    def from_np(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=like.device, dtype=like.dtype)

    return to_np, from_np


#: torch dtype -> (tensor -> ndarray, ndarray -> tensor)
CONVERTERS = {
    torch.bfloat16: _via_f32_pair(),
    **{
        dt: _identity_pair()
        for dt in (
            torch.float16, torch.float32, torch.float64,
            torch.uint8, torch.int8, torch.int32, torch.int64,
        )
    },
}

SUPPORTED_DTYPES = frozenset(CONVERTERS)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    try:
        to_np, _ = CONVERTERS[t.dtype]
    except KeyError:
        raise TypeError(f"unsupported torch dtype {t.dtype}") from None
    return to_np(t)


def from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    _, from_np = CONVERTERS[like.dtype]
    return from_np(a, like)
