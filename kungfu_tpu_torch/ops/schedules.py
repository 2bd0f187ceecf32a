"""Allreduce schedules and the bucketed reduce-scatter / all-gather pair,
over stacked co-resident ranks.

Port of ``kungfu_tpu/ops/schedules.py``.  Every function takes and
returns values stacked on the leading rank axis of the current
:func:`~kungfu_tpu_torch.ops.collective.rank_world` (outside a world,
every axis has size 1 and each collective is the identity).

* ``psum`` — :func:`kungfu_tpu_torch.ops.collective.all_reduce`.
* ``two_stage`` — reduce-scatter then all-gather, each a plain reduction
  or copy over the stacked axis (the reference's ``psum_scatter`` and
  ``all_gather``, which are XLA collectives, not Pallas kernels).
* ``ring`` — the reference's ``ppermute`` ring, hop by hop in its fold
  order, on the stacked axis.
* ``pallas_ring`` — the ring reduce-scatter and all-gather of
  :mod:`kungfu_tpu_torch.ops.collectives`: the hand-written CUDA kernels
  on the card, their plain versions on the CPU.

``reduce_scatter_flat`` and ``all_gather_flat`` keep the reference's
ZeRO geometry: each rank's flat buffer viewed ``[n, chunk]`` mesh-major,
bucketed along the chunk, so the concatenation over buckets is the
un-bucketed layout bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from kungfu_tpu_torch.ops import collective as coll
from kungfu_tpu_torch.ops.collective import _OPS, Axis, all_reduce
from kungfu_tpu_torch.utils.tree import tree_map

#: the reference's schedule names (``ops/schedules.py:49``)
ALLREDUCE_SCHEDULES = ("psum", "two_stage", "ring", "pallas_ring")

#: schedules of the flat reduce-scatter / all-gather pair ("lax": a
#: plain reduction or copy over the stacked axis; "pallas_ring": the ring
#: collectives of ops/collectives)
FLAT_SCHEDULES = ("lax", "pallas_ring")

#: payload-size buckets of the per-bucket schedule table
#: (``Communicator.set_bucket_strategy``); edges are upper bounds in bytes
SIZE_BUCKETS = ("small", "large")
SIZE_BUCKET_EDGES = (256 << 10,)


def size_bucket(nbytes: int) -> int:
    """Bucket index for a payload of ``nbytes`` (0-based, ascending)."""
    for i, edge in enumerate(SIZE_BUCKET_EDGES):
        if nbytes < edge:
            return i
    return len(SIZE_BUCKET_EDGES)


def _pad_identity(op: str, dtype: torch.dtype):
    """Identity element of the fold for ``dtype`` (an inf pad would
    overflow an int buffer; a zero pad would corrupt min/max)."""
    if op in ("sum", "mean"):
        return 0
    if dtype.is_floating_point:
        return math.inf if op == "min" else -math.inf
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _flatten_pad(a: torch.Tensor, n: int, op: str):
    """Each rank's value of the stacked ``a`` ``[N, *shape]`` flattened
    and padded with the op's identity to ``[N, n, chunk]``; returns it
    with the unpadded size."""
    flat = a.reshape(a.shape[0], -1)
    size = flat.shape[1]
    chunk = max(1, math.ceil(size / n))
    pad = n * chunk - size
    if pad:
        flat = torch.cat([flat, torch.full((a.shape[0], pad),
                                           _pad_identity(op, flat.dtype),
                                           dtype=flat.dtype,
                                           device=flat.device)], dim=1)
    return flat.reshape(a.shape[0], n, chunk), size


_FOLD = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _ring_all_reduce_leaf(a: torch.Tensor, axis_name: str, op: str):
    """The reference's ``ppermute`` ring (``:110``), hop by hop: n-1
    reduce-scatter steps in which rank ``r`` folds the chunk received
    from ``r-1`` into its own (``fold(cur, got)``), then n-1 all-gather
    steps that carry the reduced chunks around."""
    n = coll.peer_size(axis_name)
    if n == 1:
        return a
    fold = _FOLD[op]
    parts, size = _flatten_pad(a, n, op)
    g = coll.group_view(parts, axis_name).clone()   # [G, n(rank), n, chunk]
    r = torch.arange(n, device=a.device)
    for s in range(n - 1):
        send_i, recv_i = (r - s) % n, (r - s - 1) % n
        got = torch.roll(g[:, r, send_i], 1, dims=1)
        g[:, r, recv_i] = fold(g[:, r, recv_i], got)
    for s in range(n - 1):
        send_i, recv_i = (r + 1 - s) % n, (r - s) % n
        g[:, r, recv_i] = torch.roll(g[:, r, send_i], 1, dims=1)
    out = coll.ungroup(g, axis_name).reshape(a.shape[0], -1)
    return out[:, :size].reshape(a.shape)


def _psum_scatter(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)`` on the stacked axis: ``[N, m*c]``
    to ``[N, c]``, rank ``j`` of each group keeping chunk ``j`` of the
    group's sum."""
    m = coll.peer_size(axis_name)
    if m == 1:
        return x
    g = coll.group_view(x, axis_name)                 # [G, m, m*c]
    red = g.sum(1, dtype=g.dtype).reshape(g.shape[0], m, -1)
    return coll.ungroup(red, axis_name)


def _all_gather_tiled(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` on the stacked axis: ``[N, c]`` to
    ``[N, m*c]``."""
    m = coll.peer_size(axis_name)
    if m == 1:
        return x
    g = coll.group_view(x, axis_name)                 # [G, m, c]
    full = g.reshape(g.shape[0], 1, -1).expand(g.shape[0], m, -1)
    return coll.ungroup(full, axis_name)


def _two_stage_all_reduce_leaf(a: torch.Tensor, axis_name: str, op: str):
    """Reduce-scatter + all-gather (``:149``); min/max take the ring."""
    n = coll.peer_size(axis_name)
    if n == 1:
        return a
    if op in ("min", "max"):
        return _ring_all_reduce_leaf(a, axis_name, op)
    parts, size = _flatten_pad(a, n, op)
    mine = _psum_scatter(parts.reshape(a.shape[0], -1), axis_name)
    out = _all_gather_tiled(mine, axis_name)
    return out[:, :size].reshape(a.shape)


def _pallas_ring_all_reduce_leaf(a: torch.Tensor, axis_name: str, op: str):
    """Ring reduce-scatter + ring all-gather through
    :mod:`kungfu_tpu_torch.ops.collectives` (``:165``); sum only, so
    min/max take the plain ring."""
    if op in ("min", "max"):
        return _ring_all_reduce_leaf(a, axis_name, op)
    from kungfu_tpu_torch.ops.collectives import ring_all_reduce

    return ring_all_reduce(a, axis_name)


def all_reduce_scheduled(x, axis: Axis, op: str = "sum",
                         schedule: str = "psum"):
    """Allreduce a stacked tensor or tree across ``axis`` with an explicit
    schedule; every schedule returns the same values.  A tuple ``axis``
    (outer to inner, e.g. ``(kf_host, kf_local)``) reduces its inner
    non-trivial axes with a plain sum first and runs the schedule on the
    first non-trivial one (``:468-486``)."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    if schedule not in ALLREDUCE_SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; one of {ALLREDUCE_SCHEDULES}")
    if schedule == "psum":
        return all_reduce(x, axis, op=op)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    sizes = [coll.peer_size(ax) for ax in axes]
    if math.prod(sizes) == 1:
        return x
    coll.check_stacked(x)
    sched_leaf = {
        "ring": _ring_all_reduce_leaf,
        "two_stage": _two_stage_all_reduce_leaf,
        "pallas_ring": _pallas_ring_all_reduce_leaf,
    }[schedule]
    base = "sum" if op == "mean" else op
    real = [ax for ax, s in zip(axes, sizes) if s > 1]

    def leaf(a):
        for ax in real[1:]:  # inner stages: one plain reduction
            a = coll.all_reduce(a, ax, op=base)
        a = sched_leaf(a, real[0], base)
        if op == "mean":
            a = a / math.prod(sizes)
        return a

    return tree_map(leaf, x)


# -- bucketed reduce-scatter / all-gather (ZeRO weight-update sharding) ----

def bucket_widths(chunk: int, n: int, itemsize: int,
                  bucket_bytes: int) -> List[int]:
    """Per-bucket column widths partitioning ``chunk`` so each bucket's
    collective operand (``[n, width]`` flattened) is about
    ``bucket_bytes``; at least one bucket, the last takes the rest."""
    if chunk <= 0:
        return [chunk] if chunk else []
    per_bucket = max(1, bucket_bytes // max(1, n * itemsize))
    widths = []
    off = 0
    while off < chunk:
        w = min(per_bucket, chunk - off)
        widths.append(w)
        off += w
    return widths


def _check_flat_schedule(schedule: str) -> None:
    if schedule not in FLAT_SCHEDULES:
        raise ValueError(
            f"unknown flat schedule {schedule!r}; one of {FLAT_SCHEDULES}")


def _axes_size(axes: Sequence[str]) -> int:
    return math.prod(coll.peer_size(ax) for ax in axes)


def _scatter_loop(g, axes, chunk, widths, schedule):
    from kungfu_tpu_torch.ops.collectives import ring_reduce_scatter

    n = _axes_size(axes)
    g3 = g.reshape(g.shape[0], n, chunk)
    parts = []
    off = 0
    for w in widths:
        slab = g3[:, :, off:off + w].reshape(g.shape[0], -1)
        for i, ax in enumerate(axes):
            if schedule == "pallas_ring" and i == 0:
                slab = ring_reduce_scatter(slab, ax)
            else:
                slab = _psum_scatter(slab, ax)
        parts.append(slab)
        off += w
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _gather_loop(shard, axes, widths, schedule):
    from kungfu_tpu_torch.ops.collectives import ring_all_gather

    n = _axes_size(axes)
    rev = tuple(reversed(axes))
    slabs = []
    off = 0
    for w in widths:
        piece = shard[:, off:off + w]
        for i, ax in enumerate(rev):
            if schedule == "pallas_ring" and i == len(rev) - 1:
                piece = ring_all_gather(piece.contiguous(), ax)
            else:
                piece = _all_gather_tiled(piece, ax)
        slabs.append(piece.reshape(shard.shape[0], n, w))
        off += w
    full = slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=2)
    return full.reshape(shard.shape[0], -1)


class _GatherFlat(torch.autograd.Function):
    """The bucket loop of :func:`all_gather_flat` as one op, whose
    backward is the bucket loop of :func:`reduce_scatter_flat`: each
    bucket's gather transposes to that bucket's scatter, and the
    cotangent arrives in one piece (autograd through the loop would
    zero-fill a full-size gradient per bucket slice)."""

    @staticmethod
    def forward(ctx, shard, axes, widths, schedule):
        ctx.args = (coll.current_world(), axes, shard.shape[1], widths,
                    schedule)
        return _gather_loop(shard, axes, widths, schedule)

    @staticmethod
    def backward(ctx, ct):
        world, axes, chunk, widths, schedule = ctx.args
        with coll.use_world(world):
            return (_scatter_loop(ct.contiguous(), axes, chunk, widths,
                                  schedule), None, None, None)


def reduce_scatter_flat(g: torch.Tensor, axes: Sequence[str], chunk: int,
                        widths: Optional[Sequence[int]] = None,
                        serial: bool = False, schedule: str = "lax"):
    """Bucketed reduce-scatter of each rank's flat mesh-major buffer:
    ``g`` stacked ``[N, n*chunk]`` to ``[N, chunk]``, rank ``r`` keeping
    chunk ``r`` of the sum (``axes``: the non-trivial mesh axes, outer
    first; empty means one rank and the buffer is the chunk).

    ``schedule="pallas_ring"`` scatters each bucket over the outer axis
    through the ring reduce-scatter and the inner axes with a plain sum
    (``:305-309``); the geometry is the same either way.  ``serial`` is
    accepted for the reference's signature: it orders the reference's
    bucket collectives in its compiled program and is a value identity;
    here the buckets already run one after another, so it changes
    nothing."""
    del serial
    _check_flat_schedule(schedule)
    axes = tuple(axes)
    if not axes:
        return g[:, :chunk]
    widths = tuple(widths) if widths else (chunk,)
    return _scatter_loop(g, axes, chunk, widths, schedule)


def all_gather_flat(shard: torch.Tensor, axes: Sequence[str],
                    widths: Optional[Sequence[int]] = None,
                    prefetch: bool = False, schedule: str = "lax"):
    """Bucketed all-gather, the inverse layout of
    :func:`reduce_scatter_flat`: ``shard`` stacked ``[N, chunk]`` to the
    mesh-major ``[N, n*chunk]`` on every rank.  ``schedule="pallas_ring"``
    gathers each bucket over the inner axes with a plain copy, then over
    the outer axis through the ring all-gather (``:361-365``); gathering
    is pure data movement, so every schedule gives the same bits.
    ``prefetch`` is accepted for the reference's signature (a value
    identity there that bounds the buckets in flight) and changes
    nothing here.  Differentiable: the backward is the bucket loop of
    :func:`reduce_scatter_flat`, so a ZeRO-3 gradient arrives
    reduce-scattered."""
    del prefetch
    _check_flat_schedule(schedule)
    axes = tuple(axes)
    if not axes:
        return shard
    widths = tuple(widths) if widths else (shard.shape[1],)
    if torch.is_grad_enabled() and shard.requires_grad:
        return _GatherFlat.apply(shard, axes, widths, schedule)
    return _gather_loop(shard, axes, widths, schedule)

