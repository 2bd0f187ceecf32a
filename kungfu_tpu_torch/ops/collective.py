"""Collective ops over a communicator's axis, at world size 1.

Port of the subset of ``kungfu_tpu/ops/collective.py`` the single-card
training step runs: :func:`all_reduce`, :func:`group_all_reduce`,
:func:`peer_rank`, :func:`peer_size`.  ``axis`` is
:attr:`kungfu_tpu_torch.comm.device.Communicator.axis`.  The world is
one process on one card until the data-parallel slice: a reduction over
one peer returns its input (``mean`` over one is the identity too), and
a larger ``torch.distributed`` world raises instead of reducing wrongly.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch.distributed as dist

Axis = Union[str, Tuple[str, ...]]

_OPS = ("sum", "mean", "min", "max")


def peer_size(axis: Axis) -> int:
    """Peers along ``axis``: the ``torch.distributed`` world size when a
    process group is up, else 1."""
    del axis
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def peer_rank(axis: Axis) -> int:
    """Global index along ``axis`` (0 in a world of one)."""
    _single(axis)
    return 0


def _single(axis: Axis) -> None:
    n = peer_size(axis)
    if n != 1:
        raise NotImplementedError(
            f"collectives over {n} peers come with the data-parallel slice "
            "(port slice 4); this build reduces over one peer only")


def all_reduce(x, axis: Axis, op: str = "sum"):
    """Allreduce one tensor or tree across ``axis``: over one peer every
    op returns ``x``."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    _single(axis)
    return x


def group_all_reduce(tensors, axis: Axis, op: str = "sum"):
    """Allreduce a tree of gradients in one logical group."""
    return all_reduce(tensors, axis, op)
