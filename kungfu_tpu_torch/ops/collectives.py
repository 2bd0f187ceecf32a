"""Ring reduce-scatter and all-gather over stacked co-resident ranks.

Port of the public half of ``kungfu_tpu/ops/pallas/collectives.py``.  A
ring collective runs over one axis of the current
:func:`~kungfu_tpu_torch.ops.collective.rank_world`; its input is
stacked on the leading rank axis like every collective of the port:

* :func:`ring_reduce_scatter` takes each rank's mesh-major ``[k*chunk]``
  flat buffer (stacked ``[n, k*chunk]``) and leaves rank ``r`` of each
  ring of ``k`` ranks with chunk ``r`` of the sum (``[n, chunk]``);
* :func:`ring_all_gather` is the inverse movement, ``[n, chunk]`` to
  ``[n, k*chunk]``;
* :func:`ring_all_reduce` is the two in turn, on any shape.

Each fold follows the reference's ring order, so the result is the
reference's ``impl="lax"`` (and Pallas) result bit for bit: chunk ``c``
is ``((x[c+s][c] + x[c+2s][c]) + ...) + x[c][c]`` with ``s = +1`` for the
clockwise band (elements ``[0, cut)``) and ``-1`` for the
counter-clockwise one (``[cut, chunk)``); ``cut`` comes from the
reference's tile geometry (:func:`band_cut`) and is ``chunk`` unless
``bidirectional`` and the chunk is long enough to split.  bf16 rounds at
every step, as the reference does.

``impl`` picks the implementation, default ``KF_PALLAS_COLLECTIVES``
(:data:`kungfu_tpu_torch.utils.envs.COLLECTIVES_ENV`, read at import):
``auto`` launches the hand-written CUDA kernels
(:mod:`kungfu_tpu_torch.ops.cuda.collectives`) on CUDA tensors and runs
the plain versions below on CPU tensors; ``pallas`` always launches the
kernels (a CPU tensor raises: the port has no interpreter); ``lax`` runs
the plain versions.  A CUDA tensor under ``auto`` or ``pallas`` launches
the kernel or raises.

Over a world that spans processes each process passes and receives its
own ranks' rows.  The kernels then read every rank's row where it lies,
in the peers' symmetric buffers (:meth:`~kungfu_tpu_torch.comm.world.
ProcessSpan.publish`), and one launch a ring writes this process's
outputs; the plain versions gather the rows and fold as one process does
(:func:`~kungfu_tpu_torch.ops.collective.lift`).  Either way a process's
rows are bit for bit the one-process world's.

Both collectives are differentiable as a pair, as the reference's
custom-vjp pair: the backward of the all-gather is the ring
reduce-scatter of the cotangent, and the reverse.  The backward runs in
the forward's world, so over a span it launches the kernel across the
processes too (``kf_ring_rs`` under the all-gather, ``kf_ring_ag`` under
the reduce-scatter), never :func:`~kungfu_tpu_torch.ops.collective.
lift`.  Every call adds its
per-rank wire bytes, in the reference's ring convention
(:func:`ring_wire_bytes`), to :data:`ring_bytes`.
"""

from __future__ import annotations

from typing import Optional

import torch

from kungfu_tpu_torch.ops import collective as coll
from kungfu_tpu_torch.utils import envs

_LANE = 128

#: per-rank wire bytes of the ring collectives since the last
#: :func:`reset_ring_bytes` (the reference's ``_COLLECTIVE_COST``
#: convention: a reduce-scatter of an ``s``-byte buffer moves
#: ``(k-1)/k * s``, an all-gather of an ``s``-byte shard ``(k-1) * s``)
ring_bytes = {"reduce_scatter": 0.0, "all_gather": 0.0}


def reset_ring_bytes() -> None:
    for key in ring_bytes:
        ring_bytes[key] = 0.0


# -- geometry (copied from kungfu_tpu/ops/pallas/collectives.py:119-145) ---

def _sublane(dtype: torch.dtype) -> int:
    """Minimum second-to-last tile dim of the reference's TPU tiling for
    ``dtype`` (4-byte 8, 2-byte 16, 1-byte 32)."""
    size = torch.empty((), dtype=dtype).element_size()
    if size >= 4:
        return 8
    if size == 2:
        return 16
    return 32


def _tile_rows(chunk: int, dtype: torch.dtype) -> int:
    """Rows of the reference's padded ``[rows, 128]`` chunk tile."""
    sub = _sublane(dtype)
    rows = -(-chunk // _LANE)
    return max(sub, -(-rows // sub) * sub)


def _band_rows(rows: int, dtype: torch.dtype) -> int:
    """Clockwise band height of the bidirectional row split (0: too
    short to split, the ring runs one way)."""
    sub = _sublane(dtype)
    if rows < 2 * sub:
        return 0
    return -(-(rows // 2) // sub) * sub


def band_cut(chunk: int, dtype: torch.dtype, bidirectional: bool) -> int:
    """End of the clockwise band in elements: ``chunk`` (one direction)
    unless ``bidirectional`` splits the chunk's tile rows."""
    band = _band_rows(_tile_rows(chunk, dtype), dtype) if bidirectional \
        else 0
    return min(chunk, band * _LANE) if band else chunk


def ring_wire_bytes(nbytes: int, n: int, kind: str = "reduce_scatter") -> float:
    """Per-rank wire bytes of one ring collective over a per-rank payload
    of ``nbytes`` (``kungfu_tpu/ops/pallas/collectives.py:168``): a
    reduce-scatter moves ``(n-1)/n * nbytes``, an all-gather
    ``(n-1) * nbytes`` (its payload being the shard), an all-reduce the
    sum of both.  Two directions move the same bytes."""
    if kind == "reduce_scatter":
        return (n - 1) / n * nbytes
    if kind == "all_gather":
        return (n - 1) * nbytes
    if kind == "all_reduce":
        return 2.0 * (n - 1) / n * nbytes
    raise ValueError(f"unknown kind {kind!r}")


# -- plain versions: the reference's order-matched emulation ---------------

def _bands(chunk: int, cut: int):
    return [(sign, lo, hi) for sign, lo, hi in ((+1, 0, cut), (-1, cut, chunk))
            if hi > lo]


def ring_reduce_scatter_reference(parts: torch.Tensor,
                                  cut: Optional[int] = None) -> torch.Tensor:
    """Plain version of the reduce-scatter kernel for one ring: ``parts``
    ``[k, k*chunk]`` (row ``r``: rank ``r``'s flat buffer) to ``[k, chunk]``
    (row ``r``: the sum of chunk ``r``), hop by hop as ``_rs_dir_emul``
    (``kungfu_tpu/ops/pallas/collectives.py:198``) folds it: each rank
    seeds with its chunk ``r - sign``, and at step ``s`` adds the
    partial received from rank ``r - sign`` to its chunk
    ``r - sign*(s+2)``, received operand first."""
    k = parts.shape[0]
    chunk = parts.shape[1] // k
    x = parts.reshape(k, k, chunk)
    out = torch.empty((k, chunk), dtype=parts.dtype, device=parts.device)
    r = torch.arange(k, device=parts.device)
    for sign, lo, hi in _bands(chunk, chunk if cut is None else cut):
        band = x[:, :, lo:hi]
        acc = band[r, (r - sign) % k]
        for s in range(k - 1):
            acc = torch.roll(acc, sign, 0) + band[r, (r - sign * (s + 2)) % k]
        out[:, lo:hi] = acc
    return out


def ring_all_gather_reference(shards: torch.Tensor,
                              cut: Optional[int] = None) -> torch.Tensor:
    """Plain version of the all-gather kernel for one ring: ``shards``
    ``[k, chunk]`` to ``[k, k*chunk]``, hop by hop as ``_ag_dir_emul``
    (``:210``) moves it: at step ``s`` rank ``r`` forwards what it holds
    and files what it receives under rank ``r - sign*(s+1)``."""
    k, chunk = shards.shape
    out = torch.empty((k, k, chunk), dtype=shards.dtype, device=shards.device)
    r = torch.arange(k, device=shards.device)
    for sign, lo, hi in _bands(chunk, chunk if cut is None else cut):
        buf = shards[:, lo:hi]
        out[r, r, lo:hi] = buf
        for s in range(k - 1):
            buf = torch.roll(buf, sign, 0)
            out[r, (r - sign * (s + 1)) % k, lo:hi] = buf
    return out.reshape(k, k * chunk)


# -- dispatch --------------------------------------------------------------

def _use_kernel(t: torch.Tensor, impl: Optional[str]) -> bool:
    impl = envs.COLLECTIVES_ENV.impl if impl is None else impl
    if impl not in envs.COLLECTIVE_IMPLS:
        raise ValueError(f"impl {impl!r}: one of {envs.COLLECTIVE_IMPLS} "
                         "(or None)")
    if impl == "lax":
        return False
    if t.device.type == "cuda":
        return True
    if impl == "pallas":
        raise ValueError(
            f"impl='pallas' on a {t.device} tensor: the ring kernels run on "
            "CUDA tensors only (the port has no interpreter); use 'auto' or "
            "'lax' for the plain version")
    return False


def _per_ring(x: torch.Tensor, axis: str, fn) -> torch.Tensor:
    """``fn([k, L]) -> [k, M]`` applied to each ring of ``axis`` in the
    stacked ``x`` ``[n, L]``; the result stacked ``[n, M]``."""
    g = coll.group_view(x, axis)
    outs = [fn(g[i].contiguous()) for i in range(g.shape[0])]
    return coll.ungroup(torch.stack(outs) if len(outs) > 1 else outs[0][None],
                        axis)


def _span_rings(axis: str):
    """Each ring of ``axis`` in a world that spans processes: its global
    ranks in ring order, and the ring indices ``[j0, j0 + count)`` whose
    rows this process holds (``count`` 0 when it holds none)."""
    world = coll.current_world()
    with coll.use_world(world.whole()):
        ids = coll.group_view(torch.arange(world.n).reshape(world.n, 1),
                              axis)[:, :, 0].tolist()
    lo, hi = world.first, world.first + world.rows
    out = []
    for ring in ids:
        local = [j for j, g in enumerate(ring) if lo <= g < hi]
        if local and local != list(range(local[0], local[0] + len(local))):
            raise NotImplementedError(
                f"a ring over {axis!r} holds this process's ranks at ring "
                f"indices {local}, not one run: the ring kernels launch "
                "for a contiguous window of ranks")
        out.append((ring, local[0] if local else 0, len(local)))
    return out


def _span_launch(x: torch.Tensor, axis: str, out: torch.Tensor,
                 launch) -> torch.Tensor:
    """Publish this process's rows of ``x`` and launch ``launch(rows,
    outs, j0)`` once a ring that holds any of them: ``rows`` every rank's
    row in ring order (the peers' mapped in place), ``outs`` this
    process's rows of ``out`` at ring indices ``[j0, j0 + len(outs))``."""
    world = coll.current_world()
    span, rows = world.span, world.rows
    (views,) = span.publish([x])
    for ring, j0, count in _span_rings(axis):
        if count:
            launch([views[g // rows][g % rows] for g in ring],
                   [out[g - world.first] for g in ring[j0:j0 + count]], j0)
    span.drain()  # the reads of the peers' rows end before this returns
    return out


def _rs(flat: torch.Tensor, axis: str, bidirectional: bool,
        use_kernel: bool) -> torch.Tensor:
    k = coll.peer_size(axis)
    chunk = flat.shape[1] // k
    cut = band_cut(chunk, flat.dtype, bidirectional)
    if use_kernel:
        from kungfu_tpu_torch.ops.cuda import collectives as kernels
        fn = lambda p: kernels.reduce_scatter(p, cut)  # noqa: E731
    else:
        fn = lambda p: ring_reduce_scatter_reference(p, cut)  # noqa: E731
    if coll.spanning() and use_kernel:
        out = _span_launch(
            flat, axis, flat.new_empty((flat.shape[0], chunk)),
            lambda rows, outs, j0: kernels.reduce_scatter_rows(
                rows, outs, j0, cut))
    elif coll.spanning():
        out = coll.lift(flat, lambda full: _per_ring(full, axis, fn))
    else:
        out = _per_ring(flat, axis, fn)
    ring_bytes["reduce_scatter"] += ring_wire_bytes(
        flat.shape[1] * flat.element_size(), k, "reduce_scatter")
    return out


def _ag(shard: torch.Tensor, axis: str, bidirectional: bool,
        use_kernel: bool) -> torch.Tensor:
    k = coll.peer_size(axis)
    chunk = shard.shape[1]
    cut = band_cut(chunk, shard.dtype, bidirectional)
    if use_kernel:
        from kungfu_tpu_torch.ops.cuda import collectives as kernels
        fn = lambda s: kernels.all_gather(s, cut)  # noqa: E731
    else:
        fn = lambda s: ring_all_gather_reference(s, cut)  # noqa: E731
    if coll.spanning() and use_kernel:
        out = _span_launch(
            shard, axis, shard.new_empty((shard.shape[0], k * chunk)),
            lambda rows, outs, j0: kernels.all_gather_rows(
                rows, outs, j0, cut))
    elif coll.spanning():
        out = coll.lift(shard, lambda full: _per_ring(full, axis, fn))
    else:
        out = _per_ring(shard, axis, fn)
    ring_bytes["all_gather"] += ring_wire_bytes(
        chunk * shard.element_size(), k, "all_gather")
    return out


class _RingReduceScatter(torch.autograd.Function):
    """Reduce-scatter whose backward is the all-gather of the cotangent
    (``_rs_bwd``, ``:503``)."""

    @staticmethod
    def forward(ctx, flat, axis, bidirectional, use_kernel):
        ctx.args = (coll.current_world(), axis, bidirectional, use_kernel)
        return _rs(flat, axis, bidirectional, use_kernel)

    @staticmethod
    def backward(ctx, ct):
        world, axis, bidi, use_kernel = ctx.args
        with coll.use_world(world):
            return _ag(ct.contiguous(), axis, bidi, use_kernel), None, None, None


class _RingAllGather(torch.autograd.Function):
    """All-gather whose backward is the reduce-scatter of the cotangent
    (``_ag_bwd``, ``:524``): ZeRO-3's gradient arrives scattered."""

    @staticmethod
    def forward(ctx, shard, axis, bidirectional, use_kernel):
        ctx.args = (coll.current_world(), axis, bidirectional, use_kernel)
        return _ag(shard, axis, bidirectional, use_kernel)

    @staticmethod
    def backward(ctx, ct):
        world, axis, bidi, use_kernel = ctx.args
        with coll.use_world(world):
            return _rs(ct.contiguous(), axis, bidi, use_kernel), None, None, None


# -- public API ------------------------------------------------------------

def ring_reduce_scatter(flat: torch.Tensor, axis: str, *,
                        bidirectional: bool = False,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Ring reduce-scatter (sum) over ``axis`` of each rank's mesh-major
    ``[k*chunk]`` flat buffer, stacked ``[n, k*chunk]``; returns the
    stacked ``[n, chunk]`` (rank ``r`` of each ring owns chunk ``r``).
    Over one peer the buffer is returned.  Differentiable: the backward
    is the matching ring all-gather."""
    k = coll.peer_size(axis)
    if k == 1:
        return flat
    coll.check_stacked(flat)
    if flat.dim() != 2 or flat.shape[1] % k:
        raise ValueError(f"ring_reduce_scatter wants a stacked flat "
                         f"[n, k*chunk] buffer over k={k}, got shape "
                         f"{tuple(flat.shape)}")
    return _RingReduceScatter.apply(flat.contiguous(), axis,
                                    bool(bidirectional),
                                    _use_kernel(flat, impl))


def ring_all_gather(shard: torch.Tensor, axis: str, *,
                    bidirectional: bool = False,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Ring all-gather over ``axis`` of each rank's ``[chunk]`` shard,
    stacked ``[n, chunk]``; returns the stacked mesh-major ``[n, k*chunk]``
    concatenation (pure data movement, bitwise).  Over one peer the shard
    is returned.  Differentiable: the backward is the matching ring
    reduce-scatter."""
    k = coll.peer_size(axis)
    if k == 1:
        return shard
    coll.check_stacked(shard)
    if shard.dim() != 2:
        raise ValueError(f"ring_all_gather wants a stacked [n, chunk] shard, "
                         f"got shape {tuple(shard.shape)}")
    return _RingAllGather.apply(shard.contiguous(), axis, bool(bidirectional),
                                _use_kernel(shard, impl))


def ring_all_reduce(x: torch.Tensor, axis: str, *,
                    bidirectional: bool = False,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Ring all-reduce (sum) of a stacked ``[n, *shape]`` tensor: each
    rank's value flattened and zero-padded to ``[k, chunk]``, then the
    reduce-scatter and the all-gather in turn (the ``pallas_ring`` arm of
    :func:`~kungfu_tpu_torch.ops.schedules.all_reduce_scheduled`)."""
    k = coll.peer_size(axis)
    if k == 1:
        return x
    from kungfu_tpu_torch.ops.schedules import _flatten_pad

    parts, size = _flatten_pad(x, k, "sum")
    flat = parts.reshape(parts.shape[0], -1)
    shard = ring_reduce_scatter(flat, axis, bidirectional=bidirectional,
                                impl=impl)
    full = ring_all_gather(shard, axis, bidirectional=bidirectional,
                           impl=impl)
    return full[:, :size].reshape(x.shape)
