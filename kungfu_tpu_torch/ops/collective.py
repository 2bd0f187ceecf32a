"""Collective ops over a communicator's axes, on ranks stacked in one
process.

Port of ``kungfu_tpu/ops/collective.py``.  The reference runs its
collectives inside ``shard_map``, where each device holds its own value
and ``axis`` names a mesh axis.  The port's ranks are co-resident: one
process holds every rank's value, **stacked** on a leading axis of size
``n`` in mesh-major rank order (the reference's eager convention,
``kungfu_tpu/comm/device.py:25-29``).  A :func:`rank_world` context takes
the place of ``shard_map``'s axis environment: it names the mesh axes and
their sizes, and :func:`peer_size`, :func:`peer_rank` and every
collective here read it.  Nothing reads ``torch.distributed``.

Outside any world every axis has size 1 and values are not stacked: a
reduction returns its input, as it does over one peer in the reference.
Inside a world of size ``n`` every leaf passed to a collective has a
leading axis of ``n`` and the result is stacked the same way, each rank's
row holding what that rank's device would hold in the reference.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

Axis = Union[str, Tuple[str, ...]]

_OPS = ("sum", "mean", "min", "max")


class RankWorld:
    """The mesh axes of a stacked world, outer to inner, with their
    sizes; rank ``r`` is the mesh-major index of its coordinates."""

    def __init__(self, axes: Sequence[Tuple[str, int]]):
        self.names = tuple(name for name, _ in axes)
        self.sizes = tuple(int(size) for _, size in axes)
        if len(set(self.names)) != len(self.names) or min(self.sizes) < 1:
            raise ValueError(f"bad rank-world axes {list(axes)}")
        self.n = math.prod(self.sizes)

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise ValueError(f"axis {name!r} is not bound in the rank world "
                             f"{dict(zip(self.names, self.sizes))}") from None

    def __repr__(self):
        return f"RankWorld({dict(zip(self.names, self.sizes))})"


_local = threading.local()


def _stack():
    if not hasattr(_local, "worlds"):
        _local.worlds = []
    return _local.worlds


@contextlib.contextmanager
def rank_world(axes: Sequence[Tuple[str, int]]):
    """Bind ``axes`` (``[(name, size), ...]``, outer first) for the
    collectives called inside: the counterpart of ``shard_map``'s axis
    environment.  Worlds nest; the innermost one is read."""
    with use_world(RankWorld(axes)) as world:
        yield world


@contextlib.contextmanager
def use_world(world: Optional[RankWorld]):
    """Re-enter a world captured earlier (``None``: no world), as a
    backward pass does on autograd's own thread."""
    if world is None:
        yield None
        return
    _stack().append(world)
    try:
        yield world
    finally:
        _stack().pop()


def current_world() -> Optional[RankWorld]:
    """The innermost :func:`rank_world`, or ``None`` outside any."""
    stack = _stack()
    return stack[-1] if stack else None


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def peer_size(axis: Axis) -> int:
    """Peers along ``axis`` (the product of its axes' sizes); 1 outside
    a rank world."""
    world = current_world()
    if world is None:
        return 1
    return math.prod(world.sizes[world.index(a)] for a in _names(axis))


def peer_rank(axis: Axis):
    """Each rank's index along ``axis`` (folded outer to inner over a
    tuple, as the reference folds ``axis_index``): an int64 ``[n]``
    tensor in a rank world, ``0`` outside one."""
    world = current_world()
    if world is None:
        return 0
    idx = torch.zeros(world.sizes, dtype=torch.int64)
    for a in _names(axis):
        i = world.index(a)
        shape = [1] * len(world.sizes)
        shape[i] = world.sizes[i]
        idx = idx * world.sizes[i] + torch.arange(world.sizes[i]).reshape(shape)
    return idx.reshape(-1)


def check_stacked(x, n: Optional[int] = None) -> None:
    """Every leaf of ``x`` has the leading rank axis of the current
    world (or of ``n``)."""
    if n is None:
        world = current_world()
        n = 1 if world is None else world.n
    for leaf in tree_leaves(x):
        if leaf.dim() == 0 or leaf.shape[0] != n:
            raise ValueError(f"stacked collective input must have leading "
                             f"rank axis {n}, got {tuple(leaf.shape)}")


def group_view(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A stacked ``[n, *rest]`` tensor as ``[G, k, *rest]``: ``k`` ranks
    along ``axis`` (folded as :func:`peer_rank` folds it) in each of the
    ``G`` groups that share the other axes.  A view where the grouping
    keeps mesh order (the whole world, or an inner suffix of it)."""
    world = current_world()
    names = _names(axis)
    gidx = [world.index(a) for a in names]
    other = [i for i in range(len(world.sizes)) if i not in gidx]
    rest = tuple(x.shape[1:])
    nd = len(world.sizes)
    v = x.reshape(*world.sizes, *rest).permute(
        *other, *gidx, *range(nd, nd + len(rest)))
    g = math.prod(world.sizes[i] for i in other)
    k = math.prod(world.sizes[i] for i in gidx)
    return v.reshape(g, k, *rest)


def ungroup(y: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Inverse of :func:`group_view`: ``[G, k, *rest]`` back to the
    stacked ``[n, *rest]`` in mesh-major rank order."""
    world = current_world()
    names = _names(axis)
    gidx = [world.index(a) for a in names]
    other = [i for i in range(len(world.sizes)) if i not in gidx]
    perm = other + gidx
    nd = len(world.sizes)
    rest = tuple(y.shape[2:])
    v = y.reshape(*(world.sizes[i] for i in perm), *rest)
    inv = [perm.index(i) for i in range(nd)]
    return v.permute(*inv, *range(nd, nd + len(rest))).reshape(world.n, *rest)


def _reduce_group(g: torch.Tensor, op: str) -> torch.Tensor:
    if op in ("sum", "mean"):
        red = g.sum(1, keepdim=True, dtype=g.dtype)
        return red / g.shape[1] if op == "mean" else red
    if op == "min":
        return g.amin(1, keepdim=True)
    return g.amax(1, keepdim=True)


def _all_reduce_leaf(a: torch.Tensor, axis: Axis, op: str) -> torch.Tensor:
    g = group_view(a, axis)
    return ungroup(_reduce_group(g, op).expand_as(g), axis)


def all_reduce(x, axis: Axis, op: str = "sum"):
    """Allreduce one tensor or tree across ``axis``: every rank's row
    holds the reduction over its group.  Over one peer every op returns
    ``x``."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    if peer_size(axis) == 1:
        return x
    check_stacked(x)
    return tree_map(lambda a: _all_reduce_leaf(a, axis, op), x)


def group_all_reduce(tensors, axis: Axis, op: str = "sum"):
    """Allreduce a tree of gradients in one logical group."""
    return all_reduce(tensors, axis, op)


def all_gather(x, axis: Axis, tiled: bool = False):
    """Every rank receives its group's values along ``axis``: stacked
    ``[n, k, *rest]``, or ``[n, k * d0, ...]`` with ``tiled``.  Outside a
    world, ``[1, *shape]`` (or ``x`` tiled)."""
    if current_world() is None:
        return x if tiled else tree_map(lambda a: a[None], x)
    check_stacked(x)

    def leaf(a):
        g = group_view(a, axis)
        k = g.shape[1]
        out = ungroup(g.unsqueeze(1).expand(g.shape[0], k, *g.shape[1:]),
                      axis)
        return out.reshape(out.shape[0], k * out.shape[2], *out.shape[3:]) \
            if tiled else out

    return tree_map(leaf, x)


def broadcast(x, axis: Axis, root: int = 0):
    """Every rank gets its group's rank ``root``'s value: the root's
    value where the rank is the root, zeros elsewhere, summed (``where``,
    never a mask-multiply: a NaN on another rank must not reach the sum,
    ``kungfu_tpu/ops/collective.py:72-77``)."""
    if peer_size(axis) == 1:
        return x
    check_stacked(x)
    is_root = peer_rank(axis) == root

    def leaf(a):
        mask = is_root.to(a.device).reshape((-1,) + (1,) * (a.dim() - 1))
        return _all_reduce_leaf(torch.where(mask, a, torch.zeros_like(a)),
                                axis, "sum")

    return tree_map(leaf, x)


def rank_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` with trailing unit axes to ``like``'s rank, so that a per-rank
    ``[n]`` value (a stacked step count) meets a stacked ``[n, ...]``
    leaf row by row; a 0-d ``v`` broadcasts to every row."""
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - v.dim()))


#: when true, :func:`replicated` checks that every rank's row is bitwise
#: equal to row 0 before it takes row 0 (the tests turn it on)
CHECK_REPLICAS = False


def replicated(x):
    """One copy of a value every rank holds alike (a reduced gradient, a
    loss): row 0 of each stacked leaf, as the reference's ``P()`` output
    takes device 0's.  Outside a world ``x`` is not stacked and is
    returned.  With :data:`CHECK_REPLICAS` a row that differs raises."""
    world = current_world()
    if world is None:
        return x
    check_stacked(x)

    def leaf(a):
        if CHECK_REPLICAS and not all(torch.equal(a[0], a[r])
                                      for r in range(1, a.shape[0])):
            raise AssertionError(
                f"replicated value of shape {tuple(a.shape)} differs "
                "between ranks")
        return a[0]

    return tree_map(leaf, x)


def barrier_value(axis: Axis):
    """A value every rank of ``axis`` contributes to: the int32 sum of
    ones (stacked ``[n]`` in a world, a 0-d ``1`` outside one)."""
    world = current_world()
    if world is None:
        return torch.tensor(1, dtype=torch.int32)
    return all_reduce(torch.ones(world.n, dtype=torch.int32), axis)
