"""Minimum spanning tree over measured peer latencies.

Copy of ``kungfu_tpu/plan/mst.py``.

Parity with reference ``include/kungfu/mst.hpp:10-57`` (Prim's algorithm
over the symmetrized latency matrix) feeding the ``MinimumSpanningTree``
TF op (``topology.cpp:118``): the resulting tree becomes the broadcast
topology via ``set_tree``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def minimum_spanning_tree(weights: np.ndarray) -> List[int]:
    """Prim's MST over a symmetric (n, n) weight matrix; returns the
    forest array ``f[i] = father(i)`` rooted at 0."""
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    if w.shape != (n, n):
        raise ValueError(f"weights must be square, got {w.shape}")
    w = (w + w.T) / 2.0  # symmetrize (reference does the same)
    father = list(range(n))
    if n <= 1:
        return father
    in_tree = np.zeros(n, dtype=bool)
    in_tree[0] = True
    best_cost = w[0].copy()
    best_from = np.zeros(n, dtype=np.int64)
    for _ in range(n - 1):
        masked = np.where(in_tree, np.inf, best_cost)
        j = int(np.argmin(masked))
        if not np.isfinite(masked[j]):
            raise ValueError("disconnected weight matrix")
        father[j] = int(best_from[j])
        in_tree[j] = True
        improve = w[j] < best_cost
        best_cost = np.where(improve, w[j], best_cost)
        best_from = np.where(improve, j, best_from)
    return father
