"""Tensor fusion: flatten a tree of tensors into one contiguous buffer and
back.

Port of ``kungfu_tpu/ops/fuse.py`` (reference fuse/defuse): small tensors
are packed into one buffer so a collective is one launch instead of one
per leaf.  Leaves are packed in ``jax.tree_util`` order (sorted dict
keys), so the buffer has the reference's layout.  ``batch_axes``
preserves leading stacked axes outside the flattening.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Tuple

import torch

from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten


class FuseTreeDef(NamedTuple):
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    fused_dtype: torch.dtype


def fuse(tree, batch_axes: int = 0, dtype=None):
    """Flatten every leaf (beyond ``batch_axes`` leading dims) and
    concatenate.  Returns ``(buffer, FuseTreeDef)``.  Leaves are cast to
    a common ``dtype`` (default: the promotion of the leaves' dtypes)."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("fuse of empty tree")
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    if dtype is None:
        dtype = functools.reduce(torch.promote_types, dtypes)
    flat = [l.reshape(l.shape[:batch_axes] + (-1,)).to(dtype) for l in leaves]
    sizes = tuple(f.shape[-1] for f in flat)
    return torch.cat(flat, dim=-1), FuseTreeDef(treedef, shapes, dtypes,
                                                sizes, dtype)


def defuse(buf: torch.Tensor, spec: FuseTreeDef, batch_axes: int = 0):
    """Inverse of :func:`fuse` (``batch_axes`` is implied by the buffer:
    the leaves' own shapes are restored)."""
    del batch_axes
    pieces = torch.split(buf, list(spec.sizes), dim=-1)
    leaves = [p.reshape(shape).to(dt)
              for p, shape, dt in zip(pieces, spec.shapes, spec.dtypes)]
    return tree_unflatten(spec.treedef, leaves)
