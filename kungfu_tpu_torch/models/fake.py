"""Gradient-shaped fake models for collective benchmarking.

Port of ``kungfu_tpu/models/fake.py``: the per-tensor parameter counts
of resnet50-imagenet, vgg16-imagenet, bert and slp-mnist (the
reference's ``tests/go/fakemodel/fakemodel.go:12-17``), materialized as
gradient-shaped tensors from the same ``np.random.RandomState`` draws.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from kungfu_tpu_torch.utils.device import resolve_device

# per-tensor float counts (grouped); totals are what matters for bandwidth
_FAKE_SIZES: Dict[str, List[int]] = {
    "slp-mnist": [784 * 10, 10],
    "resnet50-imagenet": (
        [9408, 64, 64]
        + [4096, 16384, 36864, 64, 64, 256] * 3
        + [32768, 131072, 147456, 128, 128, 512] * 4
        + [131072, 524288, 589824, 256, 256, 1024] * 6
        + [524288, 2097152, 2359296, 512, 512, 2048] * 3
        + [2048 * 1000, 1000]
    ),
    "vgg16-imagenet": [
        1728, 36864, 73728, 147456, 294912, 589824, 589824,
        1179648, 2359296, 2359296, 2359296, 2359296, 2359296,
        102760448, 16777216, 4096000,
    ],
    "bert": [30528 * 768, 512 * 768, 2 * 768]
    + [768 * 768 * 4 + 768 * 4 + 768 * 3072 * 2 + 3072 + 768 * 3] * 12
    + [768 * 768, 768],
}


def fake_model_names() -> List[str]:
    return sorted(_FAKE_SIZES)


def fake_model_sizes(name: str) -> List[int]:
    try:
        return list(_FAKE_SIZES[name])
    except KeyError:
        raise ValueError(f"unknown fake model {name!r}; one of "
                         f"{fake_model_names()}") from None


def fake_grads(name: str, dtype: torch.dtype = torch.float32,
               stacked: int = 0, seed: int = 0,
               device=None) -> List[torch.Tensor]:
    """Gradient-shaped tensors on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``); ``stacked=n`` adds a leading
    peer axis for the co-resident communicator.  Each is the reference's
    f64 uniform draw rounded once to ``dtype``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    out = []
    for sz in fake_model_sizes(name):
        shape = (stacked, sz) if stacked else (sz,)
        draw = torch.from_numpy(rng.uniform(-1, 1, size=shape))
        out.append(draw.to(dtype).to(dev))
    return out


def total_params(name: str) -> int:
    return sum(fake_model_sizes(name))
