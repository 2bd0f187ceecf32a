"""Functional layers on tensors: dense, conv, batch norm, layernorm,
rmsnorm, embedding, gelu, dropout.

Port of ``kungfu_tpu/models/nn.py``.  Same conventions: a layer is an
``*_init`` returning a dict of f32 parameters and an ``*_apply`` taking
it; ``dtype`` is the compute dtype the f32 parameters are cast to inside
the call.  Dense weights keep the reference's ``[in, out]`` layout
(``y = x @ w``), conv weights its HWIO and activations its NHWC, so
weights cross from the JAX tree unchanged.  Initializers draw on the
CPU from an explicit ``torch.Generator`` (the draws cannot match
``jax.random``; parity goes through :mod:`kungfu_tpu_torch.interop`).

Convolutions run through ``F.conv2d`` on a permuted view: a contiguous
NHWC tensor permuted to NCHW is already ``channels_last``, so cuDNN
reads and writes the NHWC buffers without a layout copy.  XLA's
``"SAME"`` padding is asymmetric (``lo = total // 2``, the odd pixel
at the end); where it is, the input is padded explicitly and the
convolution runs unpadded.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from kungfu_tpu_torch.ops.collective import all_reduce, current_world
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, torch.Tensor]
Padding = Union[str, Sequence[Tuple[int, int]]]


# -- initializers --------------------------------------------------------
def glorot_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=gen)


def he_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Normal with std ``sqrt(2 / fan_in)``, ``fan_in`` the product of
    every axis but the last (HWI of an HWIO kernel)."""
    std = math.sqrt(2.0 / math.prod(shape[:-1]))
    return torch.empty(shape, dtype=torch.float32).normal_(
        0.0, 1.0, generator=gen) * std


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


# -- conv (NHWC) ---------------------------------------------------------
def conv_init(gen: torch.Generator, in_ch: int, out_ch: int,
              kernel: Tuple[int, int], use_bias: bool = False) -> Params:
    p = {"w": he_normal(gen, tuple(kernel) + (in_ch, out_ch))}
    if use_bias:
        p["b"] = torch.zeros((out_ch,), dtype=torch.float32)
    return p


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ``(lo, hi)`` with
    the odd pixel at the end (a 3x3/s2 window on an even axis pads
    ``(0, 1)``)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def window_pads(padding: Padding, hw: Tuple[int, int], k: Tuple[int, int],
                stride: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((h_lo, h_hi), (w_lo, w_hi))`` for ``"SAME"``, ``"VALID"`` or
    explicit pairs, as ``lax.conv_general_dilated`` and
    ``lax.reduce_window`` read them."""
    if isinstance(padding, str):
        if padding == "SAME":
            return (same_pads(hw[0], k[0], stride),
                    same_pads(hw[1], k[1], stride))
        if padding == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"padding {padding!r}: 'SAME', 'VALID' or pairs")
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` as an NCHW view (``channels_last`` when ``x`` is
    contiguous: no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _spatial(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` on ``x`` ``[*lead, H, W, C]`` with the leading axes folded
    into one batch axis (a stacked ``[n, N, H, W, C]`` activation runs
    as ``[n * N, H, W, C]``)."""
    lead = x.shape[:-3]
    y = fn(x.reshape((-1,) + tuple(x.shape[-3:])))
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def _pad_hw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (h0, h1), (w0, w1) = pads
    return F.pad(x, (0, 0, w0, w1, h0, h1), value=value)


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int,
            pads) -> torch.Tensor:
    """NHWC ``x`` with HWIO ``w``; symmetric pads go to cuDNN, others
    are applied first."""
    (h0, h1), (w0, w1) = pads
    if h0 == h1 and w0 == w1:
        pad = (h0, w0)
    else:
        x, pad = _pad_hw(x, pads), (0, 0)
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride,
                          padding=pad))


def _cast(t: torch.Tensor, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, torch.dtype]:
    """(``t`` in the compute dtype, that dtype): ``dtype``, or ``x``'s
    and ``t``'s promoted as jnp promotes them."""
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, t.dtype)
    return t.to(dt), dt


def conv_apply(p: Params, x: torch.Tensor, stride: int = 1,
               padding: Padding = "SAME",
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lax.conv_general_dilated`` NHWC x HWIO -> NHWC, with XLA's
    padding (``"SAME"``, ``"VALID"`` or explicit pairs); leading axes
    beyond N are folded into the batch."""
    w, dt = _cast(p["w"], x, dtype)
    kh, kw = w.shape[:2]
    pads = window_pads(padding, tuple(x.shape[-3:-1]), (kh, kw), stride)
    y = _spatial(x.to(dt), lambda a: _conv2d(a, w, stride, pads))
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def conv_stem_s2d_apply(p: Params, x: torch.Tensor,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The 7x7/stride-2 SAME conv as a 4x4/stride-1 conv on the 2x2
    space-to-depth input (``[N, H/2, W/2, 4C]``): the reference's stem
    rearrangement, the same linear map up to float reassociation.  The
    parameter stays the ``[7, 7, C, F]`` kernel; the a = 7 taps are
    zero-padded, so the 4x4 kernel is ``W'[u, v, (di, dj, c), f] =
    W[2u+di, 2v+dj, c, f]`` over pads ``((1, 2), (1, 2))``.  Odd H/W, a
    kernel other than 7x7 or a channel mismatch falls back to
    :func:`conv_apply`."""
    kh, kw, c, f = p["w"].shape
    h, w_, xc = x.shape[-3:]
    if (kh, kw) != (7, 7) or h % 2 or w_ % 2 or xc != c:
        return conv_apply(p, x, stride=2, dtype=dtype)
    wgt, dt = _cast(p["w"], x, dtype)
    lead = tuple(x.shape[:-3])
    x = x.to(dt).reshape((-1, h // 2, 2, w_ // 2, 2, c))
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h // 2, w_ // 2, 4 * c)
    w8 = F.pad(wgt, (0, 0, 0, 0, 0, 1, 0, 1))
    w4 = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    y = _conv2d(x, w4.reshape(4, 4, 4 * c, f), 1, ((1, 2), (1, 2)))
    y = y.reshape(lead + tuple(y.shape[1:]))
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: Padding = "VALID") -> torch.Tensor:
    """``lax.reduce_window(x, -inf, max, (1, k, k, 1), (1, s, s, 1),
    padding)`` on NHWC: the pad holds ``-inf`` and may be asymmetric, so
    it is applied first and the pool runs unpadded."""
    pads = window_pads(padding, tuple(x.shape[-3:-1]), (window, window),
                       stride)

    def pool(a):
        if any(pads[0] + pads[1]):
            a = _pad_hw(a, pads, value=-math.inf)
        return _nhwc(F.max_pool2d(_nchw(a), window, stride))

    return _spatial(x, pool)


# -- norms ---------------------------------------------------------------
def batchnorm_init(ch: int) -> Params:
    """Trainable affine params; running stats live in a separate state
    tree (:func:`batchnorm_state_init`) so optimizers never see them."""
    return {"scale": torch.ones((ch,), dtype=torch.float32),
            "bias": torch.zeros((ch,), dtype=torch.float32)}


def batchnorm_state_init(ch: int) -> Params:
    return {"mean": torch.zeros((ch,), dtype=torch.float32),
            "var": torch.ones((ch,), dtype=torch.float32)}


def bn_compute_dtype(x_dtype: torch.dtype) -> torch.dtype:
    """The normalize chain's dtype: ``x``'s, or f32 under
    ``KF_TPU_BN_COMPUTE=f32`` (read at every call, as the reference
    reads it)."""
    return (torch.float32 if os.environ.get("KF_TPU_BN_COMPUTE") == "f32"
            else x_dtype)


def batchnorm_apply(p: Params, stats: Params, x: torch.Tensor, train: bool,
                    momentum: float = 0.9, eps: float = 1e-5,
                    axis_name=None,
                    compute_dtype: Optional[torch.dtype] = None):
    """Returns ``(y, new_stats)``.  In train mode the batch statistics
    over every axis but the channels; the running stats move by
    ``momentum``.  The moments and running stats are always f32 (``mean``
    and ``m2 = mean(x^2)``, then ``var = m2 - mean^2``); the normalize
    chain runs in ``compute_dtype`` (default :func:`bn_compute_dtype`) in
    the reference's op order, ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias``.

    Sync-BN (``axis_name``) follows the port's lockstep convention:
    inside a :func:`~kungfu_tpu_torch.ops.collective.rank_world` the
    activation is stacked ``[n, N, H, W, C]``, each rank's raw moments
    ``[n, C]`` are mean-allreduced over ``axis_name`` before the
    variance is formed (a mean of per-rank variances would drop the
    spread of the rank means), and the new stats come back stacked
    ``[n, C]``.  ``dp_train_step`` runs its ranks one after another
    (ROADMAP C8), so a loss it differentiates cannot hold this
    collective: sync-BN runs where the ranks step in lockstep, as
    ``ShardedTrainer``'s forward does.  Outside a world ``axis_name``
    names an axis of one peer and the batch statistics are local."""
    stacked = axis_name is not None and current_world() is not None
    xf = x.float()
    # per-channel vectors broadcast over [N, H, W] (and over the rank
    # axis, or per rank when stacked [n, C])
    spread = (lambda v: v.reshape((v.shape[0],) + (1,) * (x.dim() - 2)
                                  + (v.shape[-1],))
              if stacked and v.dim() == 2 else v)
    if train:
        axes = tuple(range(1 if stacked else 0, x.dim() - 1))
        mean = xf.mean(dim=axes)
        m2 = xf.square().mean(dim=axes)
        if stacked:
            mean = all_reduce(mean, axis_name, op="mean")
            m2 = all_reduce(m2, axis_name, op="mean")
        var = m2 - mean.square()
        new_stats = {
            "mean": momentum * stats["mean"] + (1 - momentum) * mean,
            "var": momentum * stats["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    cd = compute_dtype if compute_dtype is not None else \
        bn_compute_dtype(x.dtype)
    inv = (torch.rsqrt(spread(var) + eps) * spread(p["scale"])).to(cd)
    xc = x if x.dtype == cd else xf.to(cd)
    y = (xc - spread(mean).to(cd)) * inv + spread(p["bias"]).to(cd)
    return y.to(x.dtype), new_stats


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


def rmsnorm_init(dim: int) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """RMSNorm computed in f32, returned in the input dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


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


#: ``kind`` of a :func:`init_from_spec` entry -> its draw
_DRAWS = {
    "he": he_normal,
    "glorot": glorot_uniform,
    "ones": lambda gen, shape: torch.ones(shape, dtype=torch.float32),
    "zeros": lambda gen, shape: torch.zeros(shape, dtype=torch.float32),
}


def init_from_spec(spec, generator: torch.Generator,
                   device: torch.device) -> dict:
    """The nested tree of a model's ``[(path "a/b/c", shape, kind)]``
    spec: each leaf drawn on the CPU from ``generator`` in spec order,
    then moved to ``device``."""
    tree: dict = {}
    for path, shape, kind in spec:
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _DRAWS[kind](generator, tuple(shape)).to(device)
    return tree


def num_params(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


def cast_floats(tree, dtype: torch.dtype):
    """Cast the floating leaves (for bf16 checkpoints and transfers)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)
