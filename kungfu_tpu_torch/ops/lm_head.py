"""Fused LM head + softmax cross-entropy — logits never reach device memory.

Port of the public half of ``kungfu_tpu/ops/pallas/lm_head.py``:
:func:`lm_head_nll` and the custom VJP behind it (``_lmh``, ``_lmh_fwd``,
``_lmh_bwd``), as a ``torch.autograd.Function``.  The forward emits the
per-token NLL and keeps ``(h, w, targets, lse)`` as residuals — O(N·D +
D·V), not O(N·V) — and, on the card, the split of ``w`` into two bf16
terms that its kernel took, so that the backward does not split again;
the backward recomputes the logits tile by tile for ``dh`` and ``dW``.
The kernels and their plain versions live in
:mod:`kungfu_tpu_torch.ops.cuda.lm_head`: a CUDA tensor launches the
kernels (or raises), a CPU tensor takes the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from kungfu_tpu_torch.ops.cuda import lm_head as kernels


class _LMHead(torch.autograd.Function):
    """Per-row NLL with residuals ``(h, w, targets, lse)`` and the split of
    ``w`` (``(W_hi, W_lo)``, or None); the backward returns ``dh`` in h's
    dtype and ``dW`` in w's, and nothing for the targets.  lse is a
    residual, not an output: it is not differentiated, as in the
    reference's VJP."""

    @staticmethod
    def forward(ctx, h, w, targets):
        loss, lse, split = kernels.forward(h, w, targets)
        hi, lo = split if split is not None else (None, None)
        ctx.save_for_backward(h, w, targets, lse, hi, lo)
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, w, targets, lse, hi, lo = ctx.saved_tensors
        split = None if hi is None else (hi, lo)
        return (*kernels.backward(h, w, targets, lse, g, split), None)


def lm_head_nll(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                block_n: Optional[int] = None,
                block_v: Optional[int] = None) -> torch.Tensor:
    """Per-token NLL of ``softmax(h @ w)`` against int ``targets``, with the
    LM-head product fused into the cross-entropy forward and backward.

    ``h``: ``[..., D]`` features (after the final norm), ``w``: ``[D, V]``
    head weights (the JAX layout), ``targets``: ``[...]`` int.  Returns
    f32 ``[...]``, differentiable in ``h`` and ``w``; matches
    ``-log_softmax(h @ w)[target]`` with f32 products and accumulation.
    ``block_n`` and ``block_v`` are the reference's TPU tile sizes,
    accepted for signature parity and ignored: the kernels size their
    own tiles for the card."""
    del block_n, block_v
    lead = h.shape[:-1]
    if targets.shape != lead:
        raise ValueError(f"targets {tuple(targets.shape)} do not match "
                         f"h {tuple(h.shape)}")
    out = _LMHead.apply(h.reshape(-1, h.shape[-1]), w,
                        targets.reshape(-1).to(torch.int32))
    return out.reshape(lead)
