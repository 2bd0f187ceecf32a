"""Mixture-of-experts with expert parallelism over a mesh axis.

Port of ``kungfu_tpu/parallel/moe.py``: switch-style top-1 routing with
capacity dropping, experts sharded one group per ``ep`` rank, tokens
moved to their expert's owner and back by
:func:`~kungfu_tpu_torch.ops.collective.all_to_all` over the axis.  The
all-to-all's gradient is the inverse all-to-all, so the expert weights'
gradients gather every rank's tokens with no sync over ``ep``
(:meth:`~kungfu_tpu_torch.parallel.train.ShardedTrainer.sync_grads`
keeps that bookkeeping).

Shapes: in a rank world every value is stacked over the ranks, tokens
``[n, ..., D]``, each rank owning ``E_local = E / ep`` experts stacked as
``w_in [n, E_local, D, F]`` and ``w_out [n, E_local, F, D]``, the gate
``[n, D, E]``; outside a world one rank's tokens ``[..., D]`` and
unstacked params.  The experts' products are plain batched products, as
the reference's einsums are outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.ops import collective as coll


def moe_init(gen: torch.Generator, n_experts_local: int, d_model: int,
             d_ff: int, n_experts_global: int):
    """f32 params drawn on the CPU from ``gen`` (the draws cannot match
    ``jax.random``; parity goes through :mod:`kungfu_tpu_torch.interop`)."""
    return {
        "gate": nn.dense_init(gen, d_model, n_experts_global, use_bias=False),
        "w_in": _glorot3(gen, (n_experts_local, d_model, d_ff)),
        "w_out": _glorot3(gen, (n_experts_local, d_ff, d_model)),
    }


def _glorot3(gen: torch.Generator, shape) -> torch.Tensor:
    """The reference's ``glorot_uniform`` of a stacked 3-D shape: fans
    from the last two dims, each times the leading dim."""
    e, fan_in, fan_out = shape
    limit = (6.0 / (e * fan_in + e * fan_out)) ** 0.5
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit,
                                                            generator=gen)


def moe_apply(params, x: torch.Tensor, axis: Optional[str],
              n_experts_global: int, capacity_factor: float = 1.25,
              dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: ``[..., D]`` local tokens (stacked ``[n, ..., D]`` in a world)
    -> ``(y, aux)``: y shaped as x, aux the switch load-balancing term
    ``E * sum_e f_e * p_e`` (a scalar, or ``[n]`` in a world).

    ``axis=None`` runs every expert locally (no EP), the single-rank
    reference of the tests."""
    if coll.current_world() is None:
        with coll.rank_world([("moe_rank", 1)]):
            y, aux = moe_apply({k: _stack1(v) for k, v in params.items()},
                               x[None], None, n_experts_global,
                               capacity_factor, dtype)
        return y[0], aux[0]
    N = x.shape[0]
    D = x.shape[-1]
    xt = x.reshape(N, -1, D)
    T = xt.shape[1]
    E = n_experts_global
    ep = 1 if axis is None else coll.peer_size(axis)

    logits = torch.matmul(xt.float(), params["gate"]["w"].float())  # [n,T,E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.max(dim=-1)                                # [n,T]

    cap = int(max(1, -(-T * capacity_factor // E)))
    onehot = torch.nn.functional.one_hot(expert, E).float()         # [n,T,E]
    pos = torch.cumsum(onehot, dim=1) * onehot  # 1-based slot per token
    keep = (pos > 0) & (pos <= cap)
    slot = torch.where(keep, pos - 1, 0).long()
    dispatch = (onehot * keep)[..., None] * torch.nn.functional.one_hot(
        slot.amax(dim=-1), cap).float()[:, :, None, :]            # [n,T,E,C]
    combine = dispatch * gate[..., None, None]

    # load-balance aux, on the full pre-drop distribution
    frac_tokens = onehot.mean(dim=1)
    frac_probs = probs.mean(dim=1)
    aux = E * (frac_tokens * frac_probs).sum(dim=-1)                # [n]

    expert_in = torch.einsum("ntec,ntd->necd", dispatch, xt.float())
    if axis is not None and ep > 1:
        # [E, C, D] -> each rank keeps its E_local experts, gathering
        # every rank's C slots for them: [E_local, ep*C, D]
        expert_in = coll.all_to_all(expert_in, axis, split_axis=0,
                                    concat_axis=1)
    cd = dtype or x.dtype
    h = torch.matmul(expert_in.to(cd), params["w_in"].to(cd))     # [n,e,g,F]
    h = nn.gelu(h)
    expert_out = torch.matmul(h, params["w_out"].to(cd)).float()
    if axis is not None and ep > 1:
        expert_out = coll.all_to_all(expert_out, axis, split_axis=1,
                                     concat_axis=0)
    y = torch.einsum("ntec,necd->ntd", combine, expert_out)
    return y.reshape(x.shape).to(x.dtype), aux


def _stack1(p):
    if isinstance(p, dict):
        return {k: _stack1(v) for k, v in p.items()}
    return p[None]
