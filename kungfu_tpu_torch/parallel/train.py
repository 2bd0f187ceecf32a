"""The data-parallel training step, world-1 subset.

Port of ``kungfu_tpu/parallel/train.py:662 dp_train_step``.  The step is
functional, as the reference's jitted one is: ``step(params, opt_state,
batch) -> (params, opt_state, loss)`` takes trees of tensors, detaches
the parameter leaves, takes ``torch.autograd.grad`` of ``loss_fn`` over
them, and returns new trees (the inputs are not modified).  ``tx`` does
the gradient collective (``synchronous_sgd`` over ``comm.axis``).

At world size 1 every collective is the identity
(:mod:`kungfu_tpu_torch.ops.collective`).  What needs a larger world or
another layout raises, naming the slice that brings it: ``zero_stage``
and ``replicated_params=False`` (data-parallel/ZeRO, port slice 4), a
``plan`` with tp/pp/sp axes (the full parallel plan, port slice 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from kungfu_tpu_torch.monitor.pulse import PulseMonitor
from kungfu_tpu_torch.ops.collective import all_reduce, group_all_reduce
from kungfu_tpu_torch.ops.monitor import _sq_norm
from kungfu_tpu_torch.optimizers._transform import apply_updates
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                         tree_unflatten)


def _value_and_grad(fn, params):
    """``(fn(params), grads, detached params)``: ``fn``'s first output (or
    its only one) is the scalar differentiated."""
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    out = fn(tree_unflatten(treedef, leaves))
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, leaves)]
    return (out, tree_unflatten(treedef, grads),
            tree_unflatten(treedef, [l.detach() for l in leaves]))


def _refuse(zero_stage, plan, replicated_params: bool) -> None:
    if plan is not None:
        if plan.tp != 1 or plan.pp != 1 or plan.sp != 1:
            raise NotImplementedError(
                f"dp_train_step is the dp-only entrypoint; a plan with "
                f"tp={plan.tp} pp={plan.pp} sp={plan.sp} comes with the full "
                "parallel plan (port slice 5)")
        if zero_stage is not None and zero_stage != plan.zero_stage:
            raise ValueError(f"zero_stage={zero_stage} disagrees with "
                             f"plan.zero_stage={plan.zero_stage}")
        if not plan.zero_stage and plan.collective_schedule != "psum":
            raise ValueError(
                f"dp_train_step's replicated step has no "
                f"{plan.collective_schedule!r} arm")
        zero_stage = plan.zero_stage or None
    if zero_stage is not None:
        raise NotImplementedError(
            f"zero_stage={zero_stage}: the ZeRO steps come with the "
            "data-parallel/ZeRO slice (port slice 4)")
    if not replicated_params:
        raise NotImplementedError(
            "replicated_params=False (per-replica stacked params for "
            "SMA/AdaptiveSGD) comes with the data-parallel slice (port "
            "slice 4)")


def dp_train_step(loss_fn, tx, comm, replicated_params: bool = True,
                  has_aux: bool = False, donate: bool = False,
                  zero_stage: Optional[int] = None, plan=None):
    """Pure data-parallel training step over a
    :class:`~kungfu_tpu_torch.comm.device.Communicator`.

    ``loss_fn(params, batch) -> scalar`` (or, with ``has_aux=True``,
    ``loss_fn(params, aux, batch) -> (loss, new_aux)`` and
    ``step(params, aux, opt_state, batch) -> (params, aux, opt_state,
    loss)``).  ``donate`` is accepted for the reference's signature: the
    port's step allocates new trees and the caller frees the old ones by
    dropping them.  With ``KF_PULSE_EVERY`` > 0 (default 10) every
    ``every``-th step also publishes the gradient-norm pulse
    (:class:`~kungfu_tpu_torch.monitor.pulse.PulseMonitor`, exposed as
    ``step.pulse``); the noise scale is ``None`` at world size 1."""
    del donate
    _refuse(zero_stage, plan, replicated_params)
    axis = comm.axis

    def body(params, aux, opt_state, batch, pulse: bool):
        if has_aux:
            (loss, new_aux), grads, params = _value_and_grad(
                lambda p: loss_fn(p, aux, batch), params)
            # replicas average floating aux state, as they do gradients
            new_aux = tree_map(
                lambda a: (all_reduce(a.detach(), axis, op="mean")
                           if a.is_floating_point() else a), new_aux)
        else:
            loss, grads, params = _value_and_grad(
                lambda p: loss_fn(p, batch), params)
            new_aux = aux
        stats = None
        if pulse:
            # small-batch side: per-rank square norm, meaned over peers;
            # large-batch side: the mean gradient's square norm
            stats = (all_reduce(_sq_norm(grads), axis, op="mean"),
                     _sq_norm(group_all_reduce(grads, axis, op="mean")))
        updates, new_state = tx.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        return (new_params, new_aux, new_state,
                all_reduce(loss.detach(), axis, op="mean"), stats)

    if has_aux:
        def step4(params, aux, opt_state, batch):
            return body(params, aux, opt_state, batch, False)[:4]

        return step4

    mon = PulseMonitor.from_env()

    def step(params, opt_state, batch):
        sample = mon is not None and mon.should_sample()
        p, _, s, loss, stats = body(params, None, opt_state, batch, sample)
        if sample:
            gl, gg = (float(x) for x in stats)
            n = int(comm.size)
            leaves = tree_leaves(batch)
            b_small = (max(1, int(leaves[0].shape[0]) // n)
                       if (leaves and n) else 1)
            mon.update(gl, gg, b_small, n,
                       group_norms={"flat": max(0.0, gg) ** 0.5})
        return p, s, loss

    step.pulse = mon
    return step
