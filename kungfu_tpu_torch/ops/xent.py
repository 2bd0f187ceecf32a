"""Softmax cross-entropy for the LM head: the fused op and its routing.

Port of the dispatch half of ``kungfu_tpu/ops/pallas/xent.py``:
:func:`softmax_cross_entropy` (the fused op, differentiable in the
logits), :func:`token_nll` (the mean next-token NLL and the single owner
of the ``KF_TPU_XENT`` switch), :func:`_route_fused` and
:func:`route_fused_lm_head`.  The kernels and their plain versions live
in :mod:`kungfu_tpu_torch.ops.triton.xent`.

Routing on the card: ``fused`` always takes the kernels; ``plain`` (alias
``xla``) is ``log_softmax`` + gather; ``auto`` is ``plain``.  The
reference's ``auto`` routes per shape on a TPU only, with crossovers
measured on a v5e (:data:`XENT_FWD_MIN_ELEMENTS`,
:data:`XENT_TRAIN_XLA_BUDGET_MB`); no H100 sweep has set a crossover yet,
so those thresholds are kept for :func:`_route_fused` but steer nothing
here.
"""

from __future__ import annotations

import os

import torch
from torch.autograd.function import once_differentiable

from kungfu_tpu_torch.models.nn import take_index
from kungfu_tpu_torch.ops.triton import xent as kernels
from kungfu_tpu_torch.utils import envs

#: the reference's per-shape routing thresholds (TPU v5e measurements)
XENT_FWD_MIN_ELEMENTS = 1 << 22
XENT_TRAIN_XLA_BUDGET_MB = 2048


class _Knobs(envs.LaunchKnobs):
    """The ``KF_TPU_XENT`` / ``KF_XENT_XLA_BUDGET_MB`` /
    ``KF_XENT_FWD_MIN_ELEMENTS`` knobs (launch-set: a mid-run change of
    the environment re-routes nothing until ``XENT_ENV.reload()``).  A
    value outside the modes raises."""

    def _read(self) -> None:
        mode = os.environ.get(envs.XENT, "auto").lower()
        if mode == "xla":
            mode = "plain"  # the reference's long-standing alias
        if mode not in ("fused", "plain", "auto"):
            raise ValueError(
                f"{envs.XENT}={mode!r}: one of fused | plain | xla | auto")
        self.mode = mode
        self.budget_mb = int(os.environ.get(
            envs.XENT_XLA_BUDGET_MB, str(XENT_TRAIN_XLA_BUDGET_MB)))
        self.fwd_min_elements = int(os.environ.get(
            envs.XENT_FWD_MIN_ELEMENTS, str(XENT_FWD_MIN_ELEMENTS)))


XENT_ENV = _Knobs()


def _route_fused(n: int, v: int, itemsize: int, training: bool) -> bool:
    """The reference's per-shape rule: True = take the fused kernel."""
    if training:
        return n * v * (itemsize + 4) > (XENT_ENV.budget_mb << 20)
    return n * v >= XENT_ENV.fwd_min_elements


def route_fused_lm_head(n_tokens: int, vocab: int) -> bool:
    """The reference's rule for the fused LM head: the training branch of
    :func:`_route_fused` over f32 logits."""
    return _route_fused(n_tokens, vocab, 4, training=True)


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        loss, lse = kernels.forward(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        return kernels.backward(logits, targets, lse, g), None


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL ``-log_softmax(logits)[target]`` (f32) for logits
    ``[..., V]`` and int targets ``[...]``; differentiable in the logits.
    The kernels on CUDA tensors, their plain versions on CPU ones."""
    v = logits.shape[-1]
    lead = logits.shape[:-1]
    if targets.shape != lead:
        raise ValueError(f"targets {tuple(targets.shape)} do not match "
                         f"logits {tuple(logits.shape)}")
    return _Xent.apply(logits.reshape(-1, v), targets.reshape(-1)).reshape(lead)


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              training: bool = True) -> torch.Tensor:
    """Mean next-token NLL with the ``KF_TPU_XENT`` dispatch (``fused`` |
    ``plain`` | ``auto``); ``training`` is the reference's routing hint,
    which steers nothing while ``auto`` means ``plain`` (module doc).
    The plain branch picks the target as ``jnp.take_along_axis`` does:
    a target in ``[-V, -1]`` wraps, one outside ``[-V, V)`` gives NaN."""
    del training
    if XENT_ENV.mode == "fused":
        return softmax_cross_entropy(logits, targets).mean()
    logp = torch.log_softmax(logits, dim=-1)
    safe, ok = take_index(targets, logits.shape[-1])
    nll = -logp.gather(-1, safe[..., None]).squeeze(-1)
    return torch.where(ok, nll, float("nan")).mean()
