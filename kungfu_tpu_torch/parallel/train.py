"""The data-parallel training step over co-resident stacked ranks.

Port of ``kungfu_tpu/parallel/train.py:52 ParallelPlan`` (trimmed to the
axes and the ZeRO stage), ``:662 dp_train_step`` and ``:864
stack_for_replicas``.  The step is functional, as the reference's jitted
one is: ``step(params, opt_state, batch) -> (params, opt_state, loss)``
takes trees of tensors and returns new trees (the inputs are not
modified).

The reference runs the step body under ``shard_map``, one copy per
device.  The port runs it for the communicator's ``n`` ranks in one
process: rank ``r`` takes rows ``[r*B/n, (r+1)*B/n)`` of every batch
leaf (as ``P(axes)`` splits the batch), and the ranks' forwards and
backwards run one after another.  Their gradients are stacked on a
leading rank axis ``[n, ...]`` and ``tx`` reduces them inside
:meth:`Communicator.world
<kungfu_tpu_torch.comm.device.Communicator.world>`.  With replicated
params (S-SGD, the monitors) a replicated output (the params, the loss)
is returned once (:func:`~kungfu_tpu_torch.ops.collective.replicated`);
with ``replicated_params=False`` (SMA, AdaptiveSGD) the params, the
optimizer state and the aux state are stacked ``[n, ...]``
(:func:`stack_for_replicas`), rank ``r`` differentiates its own row and
the updates stay stacked.

``zero_stage`` (or a plan with one) routes to
:func:`kungfu_tpu_torch.parallel.zero.zero_train_step`.  A plan with
tp/pp/sp axes (the full parallel plan) raises, naming it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from kungfu_tpu_torch.monitor.pulse import PulseMonitor
from kungfu_tpu_torch.ops.collective import (all_reduce, group_all_reduce,
                                             replicated)
from kungfu_tpu_torch.ops.monitor import _sq_norm, rank_sq_norms
from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES
from kungfu_tpu_torch.optimizers._transform import apply_updates
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                         tree_unflatten)


@dataclass(frozen=True)
class ParallelPlan:
    """The parallelism configuration the data-parallel entry points
    consume: every axis degree, the ZeRO stage and the allreduce arm
    (the reference's pipeline fields come with the full plan)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    #: 0 = replicated optimizer; 1/2/3 route the ZeRO family
    zero_stage: int = 0
    #: allreduce decomposition arm (ops.schedules.ALLREDUCE_SCHEDULES)
    collective_schedule: str = "psum"

    def __post_init__(self):
        for name, v in (("dp", self.dp), ("tp", self.tp),
                        ("pp", self.pp), ("sp", self.sp)):
            if v < 1:
                raise ValueError(f"{name}={v} must be >= 1")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage={self.zero_stage} not in 0..3")
        if self.collective_schedule not in ALLREDUCE_SCHEDULES:
            raise ValueError(
                f"collective_schedule={self.collective_schedule!r}; one of "
                f"{ALLREDUCE_SCHEDULES}")

    @property
    def size(self) -> int:
        """Device count of the in-mesh form (dp*pp*sp*tp)."""
        return self.dp * self.pp * self.sp * self.tp


def split_batch(batch, n: int) -> List:
    """Rank ``r``'s shard of every batch leaf: rows ``[r*B/n, (r+1)*B/n)``
    (views); a 0-d leaf goes to every rank whole, as ``P()``."""
    leaves, treedef = tree_flatten(batch)
    for l in leaves:
        if l.dim() and l.shape[0] % n:
            raise ValueError(f"batch leading axis {l.shape[0]} is not "
                             f"divisible by the {n} ranks")

    def shard(l, r):
        if not l.dim():
            return l
        m = l.shape[0] // n
        return l[r * m:(r + 1) * m]

    return [tree_unflatten(treedef, [shard(l, r) for l in leaves])
            for r in range(n)]


def per_rank_grads(fn: Callable, params, shards: Sequence,
                   sink: Callable, stacked: bool = False) -> tuple:
    """Each rank's forward and backward in turn: ``fn(params, shard_r)``
    (its first output is the scalar loss), then ``sink(r, grads)`` with
    rank ``r``'s gradients as a list in ``tree_flatten`` order, before
    the next rank runs.  With ``stacked`` every params leaf is ``[n,
    ...]`` and rank ``r`` differentiates a detached view of its own row
    ``r``, so its gradients are that row's; otherwise the ranks share
    one tree.  Returns the detached outputs, one per rank, and the
    detached params."""
    leaves, treedef = tree_flatten(params)
    shared = None if stacked else [l.detach().requires_grad_(True)
                                   for l in leaves]
    outs = []
    for r, shard in enumerate(shards):
        own = ([l[r].detach().requires_grad_(True) for l in leaves]
               if stacked else shared)
        out = fn(tree_unflatten(treedef, own), shard)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, own, allow_unused=True)
        sink(r, [torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, own)])
        outs.append(tree_map(lambda t: t.detach(), out))
    return outs, tree_unflatten(treedef, [l.detach() for l in leaves])


def stack_ranks(rows: Sequence):
    """Stack per-rank trees on a new leading rank axis (a view when there
    is one rank)."""
    if len(rows) == 1:
        return tree_map(lambda a: a[None], rows[0])
    return tree_map(lambda *a: torch.stack(a), *rows)


def stack_for_replicas(tree, n: int):
    """``tree`` tiled onto a leading replica axis ``[n, ...]`` (copies),
    for ``dp_train_step(replicated_params=False)``: the params, and the
    optimizer state from ``tx.init`` of the unstacked params."""
    return tree_map(
        lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)).contiguous(),
        tree)


def _stacked_grads(fn, params, shards, stacked: bool = False):
    """Per-rank gradients stacked ``[n, ...]`` per leaf; each rank's row
    is copied in as soon as its backward ends."""
    n = len(shards)
    _, treedef = tree_flatten(params)
    store = []

    def sink(r, grads):
        if n == 1:
            store.extend(g[None] for g in grads)
            return
        if not store:
            store.extend(g.new_empty((n,) + tuple(g.shape)) for g in grads)
        for s, g in zip(store, grads):
            s[r].copy_(g)

    outs, params = per_rank_grads(fn, params, shards, sink, stacked)
    return outs, tree_unflatten(treedef, store), params


def _check_plan(zero_stage, plan):
    if plan is not None:
        if plan.tp != 1 or plan.pp != 1 or plan.sp != 1:
            raise NotImplementedError(
                f"dp_train_step is the dp-only entrypoint; a plan with "
                f"tp={plan.tp} pp={plan.pp} sp={plan.sp} comes with the full "
                "parallel plan, which is not ported yet (ROADMAP A4)")
        if zero_stage is not None and zero_stage != plan.zero_stage:
            raise ValueError(f"zero_stage={zero_stage} disagrees with "
                             f"plan.zero_stage={plan.zero_stage}")
        if not plan.zero_stage and plan.collective_schedule != "psum":
            raise ValueError(
                f"dp_train_step's replicated step has no "
                f"{plan.collective_schedule!r} arm")
        zero_stage = plan.zero_stage or None
    return zero_stage


def dp_train_step(loss_fn, tx, comm, replicated_params: bool = True,
                  has_aux: bool = False, donate: bool = False,
                  zero_stage: Optional[int] = None, plan=None):
    """Pure data-parallel training step over a
    :class:`~kungfu_tpu_torch.comm.device.Communicator` of ``n`` ranks.

    ``loss_fn(params, batch) -> scalar`` runs per rank on its batch
    shard (or, with ``has_aux=True``, ``loss_fn(params, aux, batch) ->
    (loss, new_aux)`` and ``step(params, aux, opt_state, batch) ->
    (params, aux, opt_state, loss)``; the floating aux leaves are
    averaged over the ranks).  ``tx`` is any
    :mod:`kungfu_tpu_torch.optimizers` transform over ``comm.axis``; it
    does the gradient or weight collective.  ``donate`` is accepted for
    the reference's signature: the port's step allocates new trees and
    the caller frees the old ones by dropping them.

    ``replicated_params=False`` (SMA, AdaptiveSGD: each replica owns
    diverging weights) takes ``params``, ``opt_state`` and, with
    ``has_aux``, ``aux`` stacked on a leading ``comm.size`` axis
    (:func:`stack_for_replicas`) and returns them stacked; rank ``r``
    trains row ``r``, and the pulse monitor stays off.

    ``zero_stage`` (1/2/3), or ``plan.zero_stage``, returns
    :func:`~kungfu_tpu_torch.parallel.zero.zero_train_step` with ``tx``
    as the inner elementwise transform; a plan's ``pallas_ring`` arm
    becomes its bucket schedule.

    With ``KF_PULSE_EVERY`` > 0 (default 10) every ``every``-th step
    also publishes the gradient-norm pulse
    (:class:`~kungfu_tpu_torch.monitor.pulse.PulseMonitor`, exposed as
    ``step.pulse``); the noise scale is ``None`` at one rank."""
    del donate
    zero_stage = _check_plan(zero_stage, plan)
    if zero_stage is not None:
        if has_aux or not replicated_params:
            raise ValueError(
                "a ZeRO stage composes with the plain replicated-params, "
                "no-aux step only (the sharded update is elementwise over "
                "the fused flat buffer)")
        from kungfu_tpu_torch.parallel.zero import zero_train_step

        zsched = ("pallas_ring" if plan is not None
                  and plan.collective_schedule == "pallas_ring" else "lax")
        return zero_train_step(loss_fn, tx, comm, stage=zero_stage,
                               schedule=zsched)
    axis, n = comm.axis, comm.size
    stacked = not replicated_params

    def body(params, aux, opt_state, batch, pulse: bool):
        shards = split_batch(batch, n)
        if has_aux:
            # each rank passes its own aux row when the aux is stacked
            rows = ([tree_map(lambda a: a[r], aux) for r in range(n)]
                    if stacked else [aux] * n)
            outs, grads, params = _stacked_grads(
                lambda p, ab: loss_fn(p, ab[0], ab[1]), params,
                list(zip(rows, shards)), stacked)
            losses = torch.stack([o[0] for o in outs])
            aux_rows = stack_ranks([o[1] for o in outs])
        else:
            outs, grads, params = _stacked_grads(loss_fn, params, shards,
                                                 stacked)
            losses = torch.stack(outs)
        with comm.world():
            new_aux = aux
            if has_aux:
                # replicas average floating aux state, as they do gradients
                new_aux = tree_map(
                    lambda a: (all_reduce(a, axis, op="mean")
                               if a.is_floating_point() else a), aux_rows)
                if not stacked:
                    new_aux = replicated(new_aux)
            stats = None
            if pulse:
                # small-batch side: each rank's square norm, meaned over
                # the ranks; large-batch side: the mean gradient's
                stats = (replicated(all_reduce(rank_sq_norms(grads), axis,
                                               op="mean")),
                         _sq_norm(replicated(group_all_reduce(
                             grads, axis, op="mean"))))
            updates, new_state = tx.update(grads, opt_state, params)
            if not stacked:
                # a tx that does not reduce leaves the updates stacked:
                # the replicated params take rank 0's, as P() takes
                # device 0's
                updates = tree_map(
                    lambda u, p: (replicated(u) if u.dim() == p.dim() + 1
                                  else u), updates, params)
            new_params = apply_updates(params, updates)
            loss = replicated(all_reduce(losses, axis, op="mean"))
        return new_params, new_aux, new_state, loss, stats

    if has_aux:
        def step4(params, aux, opt_state, batch):
            return body(params, aux, opt_state, batch, False)[:4]

        return step4

    # diverged replicas (SMA, AdaptiveSGD) are no small/large-batch
    # pair: only the replicated step samples the pulse
    mon = PulseMonitor.from_env() if replicated_params else None

    def step(params, opt_state, batch):
        sample = mon is not None and mon.should_sample()
        p, _, s, loss, stats = body(params, None, opt_state, batch, sample)
        if sample:
            gl, gg = (float(x) for x in stats)
            leaves = tree_leaves(batch)
            b_small = (max(1, int(leaves[0].shape[0]) // n)
                       if (leaves and n) else 1)
            mon.update(gl, gg, b_small, n,
                       group_norms={"flat": max(0.0, gg) ** 0.5})
        return p, s, loss

    step.pulse = mon
    return step
