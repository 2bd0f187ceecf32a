"""Functional layers on tensors: dense, layernorm, embedding, gelu,
dropout.

Port of the transformer's subset of ``kungfu_tpu/models/nn.py`` (conv
and batch norm come with the ResNet slice).  Same conventions: a layer
is an ``*_init`` returning a dict of f32 parameters and an ``*_apply``
taking it; ``dtype`` is the compute dtype the f32 parameters are cast to
inside the call.  Dense weights keep the reference's ``[in, out]``
layout (``y = x @ w``), so weights cross from the JAX tree unchanged.
Initializers draw on the CPU from an explicit ``torch.Generator`` (the
draws cannot match ``jax.random``; parity goes through
:mod:`kungfu_tpu_torch.interop`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# -- initializers --------------------------------------------------------
def glorot_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=gen)


def normal(gen: torch.Generator, shape, stddev: float = 0.02) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).normal_(
        0.0, stddev, generator=gen)


# -- dense ---------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True) -> Params:
    p = {"w": glorot_uniform(gen, (in_dim, out_dim))}
    if use_bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32)
    return p


def dense_apply(p: Params, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w (+ b)``; f32 params cast to ``dtype`` first.  Without a
    dtype the operands are promoted as jnp does (bf16 @ f32 -> f32)."""
    w = p["w"]
    if dtype is None:
        dtype = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dtype) @ w.to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


# -- norms ---------------------------------------------------------------
def layernorm_init(dim: int) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32),
            "bias": torch.zeros((dim,), dtype=torch.float32)}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """LayerNorm computed in f32, returned in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# -- embedding -----------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, dim: int) -> Params:
    return {"table": normal(gen, (vocab, dim))}


def take_index(idx: torch.Tensor, n: int):
    """``(safe, ok)`` for indices into an axis of size ``n`` with
    ``jnp.take``'s default semantics: ``ok`` marks ``[-n, n)``, ``safe``
    wraps ``[-n, -1]`` and clamps the rest into range, so a gather with
    it needs no host sync and trips no device assert; the caller fills
    NaN where ``ok`` is false."""
    idx = idx.long()
    ok = (idx >= -n) & (idx < n)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1), ok


def embedding_apply(p: Params, ids: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row gather (``jnp.take`` on axis 0): ids in ``[-V, -1]`` wrap, ids
    outside ``[-V, V)`` give NaN rows.  Gathering before the cast gives
    the same values as casting the table first."""
    table = p["table"]
    safe, ok = take_index(ids, table.shape[0])
    rows = torch.where(ok[..., None], table[safe], float("nan"))
    return rows.to(dtype) if dtype is not None else rows


# -- misc ----------------------------------------------------------------
def dropout(gen: torch.Generator, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout (``nn.dropout`` of the reference), the keep mask
    drawn from ``gen``, which must live on ``x``'s device.  The draws
    cannot match ``jax.random``: parity holds at ``rate=0`` only."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
