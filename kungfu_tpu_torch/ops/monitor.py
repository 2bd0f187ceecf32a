"""Training-statistics reductions.

Port of ``kungfu_tpu/ops/monitor.py:22 _sq_norm``, the square norm the
pulse monitor samples (:mod:`kungfu_tpu_torch.monitor.pulse`).
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch.utils.tree import tree_leaves


def _sq_norm(tree) -> torch.Tensor:
    """Sum of squares over every leaf, in f32 (a 0-d tensor)."""
    return sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))
