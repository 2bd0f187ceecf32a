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

A world may span processes (a :class:`~kungfu_tpu_torch.comm.world.
ProcessSpan`, the reference's multi-controller mode): each process then
holds the rows of its own ranks only, ``[first, first + rows)`` of ``n``,
and passes and receives those (the reference's addressable slice).  Each
collective here gathers every rank's rows through the span's symmetric
buffers, computes what the world of one process computes over them, and
keeps its own rows (:func:`lift`), so its result is that world's bit for
bit.  The ring kernels read the peers' rows in place instead
(:mod:`kungfu_tpu_torch.ops.collectives`).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                        tree_map, tree_unflatten)

Axis = Union[str, Tuple[str, ...]]

_OPS = ("sum", "mean", "min", "max")


class RankWorld:
    """The mesh axes of a stacked world, outer to inner, with their
    sizes; rank ``r`` is the mesh-major index of its coordinates.  With a
    ``span`` the ranks live in several processes and this one holds the
    rows of ranks ``[first, first + rows)``; otherwise it holds all
    ``n``."""

    def __init__(self, axes: Sequence[Tuple[str, int]], span=None):
        self.names = tuple(name for name, _ in axes)
        self.sizes = tuple(int(size) for _, size in axes)
        if len(set(self.names)) != len(self.names) or min(self.sizes) < 1:
            raise ValueError(f"bad rank-world axes {list(axes)}")
        self.n = math.prod(self.sizes)
        self.span = span
        if span is not None and span.n != self.n:
            raise ValueError(f"a span of {span.n} ranks under rank-world "
                             f"axes of {self.n}")
        #: the first rank whose row this process holds, and how many
        self.first = 0 if span is None else span.first
        self.rows = self.n if span is None else span.rows
        self._whole = self if span is None else None

    def whole(self) -> "RankWorld":
        """The same axes with every rank's row held here: the world a
        collective computes in once it has gathered every row."""
        if self._whole is None:
            self._whole = RankWorld(list(zip(self.names, self.sizes)))
        return self._whole

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
def rank_world(axes: Sequence[Tuple[str, int]], span=None):
    """Bind ``axes`` (``[(name, size), ...]``, outer first) for the
    collectives called inside: the counterpart of ``shard_map``'s axis
    environment.  Worlds nest; the innermost one is read.  ``span``: the
    :class:`~kungfu_tpu_torch.comm.world.ProcessSpan` of a world across
    processes."""
    with use_world(RankWorld(axes, span=span)) as world:
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


def spanning() -> bool:
    """True inside a world whose ranks live in several processes."""
    world = current_world()
    return world is not None and world.span is not None


class _Lift(torch.autograd.Function):
    """:func:`lift` as one differentiable op.  The forward gathers every
    rank's rows of the inputs through the span, runs ``fn`` over the
    whole world and keeps this process's rows.  The backward gathers
    every rank's rows of the output cotangents through the span, takes
    the vjp of ``fn`` over the whole world's rows (the gathered inputs
    kept from the forward) and keeps this process's rows of the input
    cotangents, so each process's gradient rows are the one-process
    world's bit for bit.

    The backward's exchange is a collective like the forward's: every
    process of the span must reach it, in the same order.  Autograd runs
    the same graph on every process (each makes the same calls with the
    same shapes), so the backward ops run in the same order everywhere
    and every process meets the others at each exchange."""

    @staticmethod
    def forward(ctx, io, *leaves):
        world, treedef, fn = io["world"], io["treedef"], io["fn"]
        full = world.span.gather(leaves)
        with use_world(world.whole()):
            out = fn(tree_unflatten(treedef, full))
        outs, io["out_def"] = tree_flatten(out)
        lo, hi = world.first, world.first + world.rows
        mine = tuple(a[lo:hi].clone() for a in outs)
        ctx.io = io
        ctx.save_for_backward(*full)
        ctx.mark_non_differentiable(*(a for a in mine
                                      if not a.is_floating_point()))
        return mine

    @staticmethod
    def backward(ctx, *cts):
        io = ctx.io
        world, treedef, fn = io["world"], io["treedef"], io["fn"]
        full_in = ctx.saved_tensors
        wants = ctx.needs_input_grad[1:]
        # the cotangent rows of every floating output, every rank's
        floating = [i for i, c in enumerate(cts)
                    if c is not None and c.is_floating_point()]
        full_ct = world.span.gather([cts[i].contiguous() for i in floating])
        with torch.enable_grad(), use_world(world.whole()):
            ins = [a.detach().requires_grad_(w)
                   for a, w in zip(full_in, wants)]
            outs = tree_leaves(fn(tree_unflatten(treedef, ins)))
            pairs = [(outs[i], c) for i, c in zip(floating, full_ct)
                     if outs[i].requires_grad]
            need = [a for a in ins if a.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in pairs], need, [c for _, c in pairs],
                allow_unused=True) if pairs and need else [None] * len(need)
        lo, hi = world.first, world.first + world.rows
        got = iter(grads)
        out = []
        for a, w in zip(ins, wants):
            g = next(got) if w else None
            if w and g is None:
                g = torch.zeros_like(a)
            out.append(None if g is None else g[lo:hi])
        return (None, *out)


def lift(x, fn):
    """``fn`` -- a collective over the stacked rows of all ``n`` ranks --
    run in a world that spans processes: every rank's rows of each leaf
    of ``x`` are gathered through the span (one exchange for the tree),
    ``fn`` runs on them in :meth:`RankWorld.whole`, and this process's
    rows of its result are returned.  The result is the one-process
    world's, bit for bit.

    Differentiable (the counterpart of ``jax.grad`` transposing a
    collective across the processes of a multi-controller mesh): where
    autograd records the call, the backward gathers the cotangent rows,
    takes ``fn``'s vjp over the whole world and returns this process's
    rows (:class:`_Lift`), the one-process world's gradient bit for
    bit."""
    leaves, treedef = tree_flatten(x)
    check_stacked(x)
    io = {"world": current_world(), "treedef": treedef, "fn": fn}
    mine = _Lift.apply(io, *leaves)
    return tree_unflatten(io["out_def"], list(mine))


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
    return idx.reshape(-1)[world.first:world.first + world.rows]


_INDEX: dict = {}


def index_tensor(values: Sequence[int], device) -> torch.Tensor:
    """An int64 tensor of ``values`` on ``device``, copied there once and
    kept: the lockstep ops index the rank axis with the same few index
    lists every step, and a host-to-device copy per op would hold the
    host until the stream drained."""
    key = (tuple(int(v) for v in values), str(device))
    t = _INDEX.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.long, device=device)
        _INDEX[key] = t
    return t


def axis_index(axis: Axis, device=None):
    """``lax.axis_index``: each rank's index along ``axis``, an int64
    ``[rows]`` tensor on ``device`` in a rank world (``0`` outside one)."""
    idx = peer_rank(axis)
    if isinstance(idx, int) or device is None:
        return idx
    return index_tensor(idx.tolist(), device)


def check_stacked(x, n: Optional[int] = None) -> None:
    """Every leaf of ``x`` has the leading rank axis of the current
    world (the rows this process holds), or of ``n``."""
    if n is None:
        world = current_world()
        n = 1 if world is None else world.rows
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
    if spanning():
        return lift(x, lambda full: all_reduce(full, axis, op))
    check_stacked(x)
    return tree_map(lambda a: _all_reduce_leaf(a, axis, op), x)


def all_reduce_prod(a: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The product over ``axis`` of a stacked tensor, on every rank's row
    (the communicator's ``prod``, which the reference reduces through a
    plain gather)."""
    if spanning():
        return lift(a, lambda full: all_reduce_prod(full, axis))
    g = group_view(a, axis)
    return ungroup(g.prod(1, keepdim=True).expand_as(g), axis)


def group_all_reduce(tensors, axis: Axis, op: str = "sum"):
    """Allreduce a tree of gradients in one logical group."""
    return all_reduce(tensors, axis, op)


def all_gather(x, axis: Axis, tiled: bool = False):
    """Every rank receives its group's values along ``axis``: stacked
    ``[n, k, *rest]``, or ``[n, k * d0, ...]`` with ``tiled``.  Outside a
    world, ``[1, *shape]`` (or ``x`` tiled)."""
    if current_world() is None:
        return x if tiled else tree_map(lambda a: a[None], x)
    if spanning():
        return lift(x, lambda full: all_gather(full, axis, tiled))
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
    if spanning():
        return lift(x, lambda full: broadcast(full, axis, root))
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
    return all_reduce(torch.ones(world.rows, dtype=torch.int32), axis)


def ppermute(x, axis: str, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute`` on the stacked rank axis: within each group of
    ``axis``, the rank at index ``dst`` receives the value of the rank at
    index ``src`` for every ``(src, dst)`` in ``perm``; a rank that
    receives nothing gets zeros.  Differentiable through autograd's
    gather/scatter pair, so the gradient is the inverse permutation, the
    reference's transpose.  Outside a world (or over one peer) a
    permutation that keeps index 0 returns ``x``."""
    k = peer_size(axis)
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or any(not 0 <= i < k for i in srcs + dsts)):
        raise ValueError(f"ppermute over {k} ranks needs distinct sources "
                         f"and destinations in [0, {k}), got {pairs}")
    if k == 1:
        return x if pairs else tree_map(torch.zeros_like, x)
    if spanning():
        return lift(x, lambda full: ppermute(full, axis, pairs))
    check_stacked(x)

    inv = [0] * k
    for s, d in pairs:
        inv[d] = s

    def leaf(a):
        g = group_view(a, axis)
        if len(pairs) == k:  # a permutation: one gather
            out = g.index_select(1, index_tensor(inv, a.device))
        else:
            out = torch.zeros_like(g).index_copy(
                1, index_tensor(dsts, a.device),
                g.index_select(1, index_tensor(srcs, a.device)))
        return ungroup(out, axis)

    return tree_map(leaf, x)


def all_to_all(x, axis: str, split_axis: int, concat_axis: int):
    """``lax.all_to_all(tiled=True)`` on the stacked rank axis: each
    rank's value (``split_axis`` and ``concat_axis`` count its own dims,
    without the rank axis) is cut into ``k`` chunks along ``split_axis``;
    chunk ``j`` goes to the group's rank ``j``, which concatenates what
    it receives along ``concat_axis`` in source-rank order.  Pure
    reshapes and permutes, so autograd's gradient is the inverse
    all-to-all, the reference's transpose.  Over one peer returns
    ``x``."""
    k = peer_size(axis)
    if k == 1:
        return x
    if spanning():
        return lift(x, lambda full: all_to_all(full, axis, split_axis,
                                               concat_axis))
    check_stacked(x)

    def leaf(a):
        shape = list(a.shape[1:])
        m = len(shape)
        sa, ca = split_axis % m, concat_axis % m
        if shape[sa] % k:
            raise ValueError(f"all_to_all split axis {sa} of size "
                             f"{shape[sa]} is not divisible by {k} ranks")
        g = group_view(a, axis)                       # [G, k_src, *shape]
        G = g.shape[0]
        g = g.reshape(G, k, *shape[:sa], k, shape[sa] // k, *shape[sa + 1:])
        g = g.movedim(2 + sa, 1)                      # [G, k_dst, k_src, ...]
        g = g.movedim(2, 2 + ca)                      # k_src before concat
        out = list(shape)
        out[sa] //= k
        out[ca] *= k
        return ungroup(g.reshape(G, k, *out), axis)

    return tree_map(leaf, x)
