"""Tensor parallelism: Megatron-style column/row sharded products.

Port of ``kungfu_tpu/parallel/tp.py``.  Activations are replicated over
the ``tp`` axis; weights are sharded on one side of the contraction.
Exact gradients with replicated-activation compute need Megatron's
paired pseudo-collectives (*f* and *g*):

* :func:`tp_region_enter` — identity forward, sum over ``tp`` backward:
  where a replicated activation enters a tp-sharded block, the partial
  cotangents of the ranks are summed back into the full gradient;
* :func:`tp_region_exit` — sum over ``tp`` forward, identity backward:
  the row-parallel output reduction (each rank holds a partial product).

The reference's ``custom_vjp`` pair becomes a pair of
``torch.autograd.Function``\\ s over the stacked ranks of the current
:func:`~kungfu_tpu_torch.ops.collective.rank_world` (captured in the
forward: the backward may run on autograd's own thread).  In a world
every value is stacked ``[n, ...]``: :func:`column_dense` and
:func:`row_dense` then take weights ``[n, in, out]`` and biases
``[n, out]`` and run one product batched over the ranks.  Outside a
world they are the plain ``x @ w (+ b)``.
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch.ops import collective as coll


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.args = (coll.current_world(), axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        world, axis = ctx.args
        with coll.use_world(world):
            return coll.all_reduce(g, axis, op="sum"), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return coll.all_reduce(x, axis, op="sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_region_enter(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Identity forward; the backward sums the cotangent over ``axis``."""
    if coll.peer_size(axis) == 1:
        return x
    return _Enter.apply(x, axis)


def tp_region_exit(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum over ``axis`` forward; identity backward."""
    if coll.peer_size(axis) == 1:
        return x
    return _Exit.apply(x, axis)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype) if dtype is not None else t


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on one rank, or batched over the stacked ranks: ``x``
    ``[n, ..., in]``, ``w`` ``[n, in, out]``."""
    if coll.current_world() is None:
        return x @ w
    n = x.shape[0]
    y = torch.matmul(x.reshape(n, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if coll.current_world() is None:
        return y + b
    return y + b.reshape(b.shape[0], *(1,) * (y.dim() - 2), b.shape[-1])


def column_dense(p, x, dtype=None):
    """``x @ w_shard``: the weight sharded on the OUTPUT dim, the result
    the local feature shard.  ``p = {"w": [in, out/tp], "b": [out/tp]?}``
    (stacked ``[n, ...]`` in a world)."""
    y = _matmul(x, _cast(p["w"], dtype))
    if "b" in p:
        y = _bias(y, _cast(p["b"], dtype))
    return y


def row_dense(p, x, axis: str, dtype=None):
    """``x_shard @ w_shard`` summed over ``axis``: the weight sharded on
    the INPUT dim, the input the local feature shard, the output reduced
    and replicated.  The bias is replicated and added once, after the
    reduction."""
    y = tp_region_exit(_matmul(x, _cast(p["w"], dtype)), axis)
    if "b" in p:
        y = _bias(y, _cast(p["b"], dtype))
    return y
