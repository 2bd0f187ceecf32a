"""Weight-update sharding (ZeRO stages 1, 2 and 3) over co-resident
stacked ranks.

Port of ``kungfu_tpu/parallel/zero.py``: ``zero1_train_step``,
``_ZeroGeometry``, ``ZeroStep``, ``zero_train_step``,
``zero_comm_bytes`` and the optimizer-state byte counts.  For an
elementwise inner transform the sharded update is the replicated update
restricted to the shard, so every stage matches ``dp_train_step`` over
``synchronous_sgd`` to float tolerance:

========  ==========================  ==================  ============
stage     gradient collective         params at rest      opt state
========  ==========================  ==================  ============
1         all-reduce                  replicated          1/n sharded
2         bucketed reduce-scatter     replicated          1/n sharded
3         the backward of the         1/n sharded         1/n sharded
          in-step bucketed all-gather
========  ==========================  ==================  ============

The sharded geometry is the reference's at every stage: the param tree
fused into one flat buffer of ``padded = n * ceil(total / n)`` elements,
rank ``r`` owning the contiguous ``[r*chunk, (r+1)*chunk)`` (mesh-major,
outer axis first).  Per-rank values are stacked on the leading rank
axis, as everywhere in the port: a shard is ``[n, chunk]``, the
optimizer state's vector leaves are ``[n, chunk]`` and its scalars
(Adam's ``count``) are one 0-d tensor every rank shares.

Each rank's forward and backward run in turn on its batch shard
(:func:`~kungfu_tpu_torch.parallel.train.per_rank_grads`), writing its
flat gradient into row ``r`` of one ``[n, padded]`` buffer.  Stage 1
all-reduces it (no ring kernel, as in the reference); stage 2 scatters
it bucket by bucket through :func:`~kungfu_tpu_torch.ops.schedules.
reduce_scatter_flat` (the ring reduce-scatter kernel under
``schedule="pallas_ring"``).  The regather of the updated params at
stages 1 and 2 is the reference's partitioner all-gather, and here a
plain view of the shards.  Stage 3 gathers the params through
:func:`~kungfu_tpu_torch.ops.schedules.all_gather_flat` inside the step,
and its gradient arrives through the gather's backward, scattered.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kungfu_tpu_torch.monitor.pulse import PulseMonitor
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.ops.collective import all_reduce, replicated
from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.ops.schedules import (FLAT_SCHEDULES, all_gather_flat,
                                            bucket_widths, reduce_scatter_flat)
from kungfu_tpu_torch.optimizers._transform import apply_updates
from kungfu_tpu_torch.parallel.train import per_rank_grads, split_batch
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map


def opt_state_bytes(opt_state) -> int:
    """Total bytes across an optimizer-state tree (all ranks)."""
    return sum(l.numel() * l.element_size() for l in tree_leaves(opt_state))


def opt_state_bytes_per_device(opt_state, n: int = 1) -> int:
    """One rank's optimizer-state bytes.  ``n`` > 1 reads the tree as a
    ZeRO state: every leaf with a leading axis is stacked over the ``n``
    ranks and each holds one row; a 0-d leaf is held whole by every
    rank.  ``n = 1`` counts a replicated state, held whole."""
    total = 0
    for l in tree_leaves(opt_state):
        nbytes = l.numel() * l.element_size()
        total += nbytes // n if l.dim() else nbytes
    return total


def record_opt_state_gauge(opt_state, n: int = 1) -> int:
    """Publish one rank's optimizer-state bytes as the
    ``kf_opt_state_bytes`` gauge; returns them."""
    nbytes = opt_state_bytes_per_device(opt_state, n)
    REGISTRY.gauge("kf_opt_state_bytes").set(nbytes)
    return nbytes


def zero_comm_bytes(total_params: int, n: int, stage: int,
                    itemsize: int = 4) -> dict:
    """Analytic per-rank wire bytes per training step (ring convention):
    ``grad_bytes`` (all-reduce at stage 1, reduce-scatter at stages
    2/3), ``param_bytes`` (the per-step parameter all-gather) and their
    ``total_bytes``."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    padded = math.ceil(total_params / n) * n
    rs = (n - 1) / n * padded * itemsize
    grad = 2.0 * rs if stage == 1 else rs
    return {"grad_bytes": grad, "param_bytes": rs, "total_bytes": grad + rs,
            "padded_params": padded}


class _ZeroGeometry:
    """The flat-buffer geometry of one param structure over one mesh."""

    def __init__(self, params, comm, bucket_bytes: int):
        self.n = comm.size
        self.axes = comm.axis
        sizes = {"kf_host": comm.num_hosts, "kf_local": comm.local_size}
        _, self.spec = fuse(tree_map(
            lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
            params))
        self.total = sum(self.spec.sizes)
        self.chunk = math.ceil(self.total / self.n)
        self.padded = self.chunk * self.n
        self.flat_dtype = self.spec.fused_dtype
        self.itemsize = torch.empty((), dtype=self.flat_dtype).element_size()
        #: outer axis first, so rank r's chunk sits at r * chunk
        self.scatter_axes = [ax for ax in self.axes if sizes[ax] > 1]
        self.widths = bucket_widths(self.chunk, self.n, self.itemsize,
                                    bucket_bytes)

    def flat_of(self, tree) -> torch.Tensor:
        """The tree fused and zero-padded to ``[padded]``."""
        b, _ = fuse(tree)
        b = b.to(self.flat_dtype)
        if self.padded > self.total:
            b = torch.cat([b, b.new_zeros(self.padded - self.total)])
        return b

    def shards_of(self, tree) -> torch.Tensor:
        """Every rank's chunk of the flat tree, stacked ``[n, chunk]``."""
        return self.flat_of(tree).view(self.n, self.chunk)

    def tree_of(self, flat: torch.Tensor):
        """The param tree from a ``[padded]`` flat buffer."""
        return defuse(flat[:self.total], self.spec)

    def fill(self, row: torch.Tensor, grads) -> None:
        """Write one rank's gradient leaves into its flat row, in fuse
        order (the padding stays zero)."""
        off = 0
        for g in grads:
            row[off:off + g.numel()].copy_(g.reshape(-1))
            off += g.numel()


class ZeroStep:
    """A staged weight-update-sharded training step.

    Stages 1/2 keep ``step(params, opt_shard, batch)`` with params
    replicated in and out, and unpack as ``step, init_opt =
    zero_train_step(...)``.  Stage 3 keeps the params sharded between
    steps: :meth:`init_params` carves the stacked ``[n, chunk]`` shard,
    ``step(p_shard, opt_shard, batch)`` trains it, and
    :meth:`gather_params` reassembles the tree.  Stages 1/2 publish the
    gradient pulse every ``KF_PULSE_EVERY`` steps (:attr:`pulse`)."""

    def __init__(self, loss_fn, inner, comm, stage: int, average: bool,
                 bucket_bytes: int, schedule: str = "lax"):
        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage must be 1, 2 or 3, got {stage}")
        if schedule not in FLAT_SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; one of {FLAT_SCHEDULES}")
        self.stage = stage
        self.comm = comm
        self._loss_fn = loss_fn
        self._inner = inner
        self._average = average
        self._bucket_bytes = int(bucket_bytes)
        self._schedule = schedule
        self._cache = {}
        self._g3 = None  # stage 3's geometry, set by init_params
        self.pulse = PulseMonitor.from_env() if stage in (1, 2) else None

    def __iter__(self):
        return iter((self.step, self.init_opt))

    def __call__(self, params, opt_shard, batch):
        return self.step(params, opt_shard, batch)

    # -- public API -------------------------------------------------------
    def step(self, params, opt_shard, batch):
        if self.stage == 3:
            return self._step3(self._require_g3(), params, opt_shard, batch)
        mon = self.pulse
        sample = mon is not None and mon.should_sample()
        p, opt_shard, loss, stats = self._step12(
            self._get(params), params, opt_shard, batch, sample)
        if sample:
            n = self.comm.size
            gl, gg = (float(x) for x in stats)
            leaves = tree_leaves(batch)
            b_small = (int(leaves[0].shape[0]) // n) if leaves else 1
            mon.update(gl, gg, max(1, b_small), n,
                       group_norms={"flat": math.sqrt(max(0.0, gg))})
        return p, opt_shard, loss

    def init_opt(self, params):
        """The inner transform's state over every rank's flat shard."""
        geo = self._get(params)
        out = self._inner.init(geo.shards_of(params))
        record_opt_state_gauge(out, geo.n)
        return out

    def init_params(self, params):
        """Stage 3: carve the param tree into the stacked ``[n, chunk]``
        shard the step trains on.  Stages 1/2: identity."""
        if self.stage != 3:
            return params
        geo = self._get(params)
        self._g3 = geo
        return geo.shards_of(params)

    def gather_params(self, p):
        """Stage 3: the param tree from the stacked shard.  Stages 1/2:
        identity (the params are already replicated)."""
        if self.stage != 3:
            return p
        return self._require_g3().tree_of(p.reshape(-1))

    def comm_bytes(self, params) -> dict:
        """Analytic per-rank wire bytes per step for this model on this
        mesh (:func:`zero_comm_bytes`)."""
        geo = self._get(params)
        return zero_comm_bytes(geo.total, geo.n, self.stage, geo.itemsize)

    # -- internals --------------------------------------------------------
    def _require_g3(self) -> _ZeroGeometry:
        if self._g3 is None:
            raise RuntimeError(
                "stage-3 step called before init_params (the parameter "
                "shard carve defines the step's geometry)")
        return self._g3

    def _get(self, params) -> _ZeroGeometry:
        leaves, treedef = tree_flatten(params)
        key = (repr(treedef),
               tuple((tuple(l.shape), str(l.dtype)) for l in leaves))
        if key not in self._cache:
            self._cache[key] = _ZeroGeometry(params, self.comm,
                                             self._bucket_bytes)
        return self._cache[key]

    def _update(self, geo, g_shard, opt_shard, p_shard):
        if self._average:
            g_shard = g_shard / geo.n
        updates, opt_shard = self._inner.update(g_shard, opt_shard, p_shard)
        return apply_updates(p_shard, updates), opt_shard

    def _step12(self, geo, params, opt_shard, batch, with_pulse: bool):
        n, chunk = geo.n, geo.chunk
        first = tree_leaves(params)[0]
        g = torch.zeros((n, geo.padded), dtype=geo.flat_dtype,
                        device=first.device)
        outs, params = per_rank_grads(
            self._loss_fn, params, split_batch(batch, n),
            lambda r, grads: geo.fill(g[r], grads))
        losses = torch.stack(outs)
        stats = None
        with self.comm.world():
            gl = (g.float() ** 2).sum(1) if with_pulse else None
            if self.stage == 1:
                # the classic ZeRO-1 path: every rank sees the full
                # reduced gradient, then keeps its own chunk
                for ax in geo.scatter_axes:
                    g = all_reduce(g, ax)
                rank = torch.arange(n, device=g.device)
                g_shard = g.view(n, n, chunk)[rank, rank]
                if with_pulse:
                    for ax in geo.scatter_axes:
                        gl = all_reduce(gl, ax, op="mean")
                    # g is the summed gradient: |mean|^2 = |sum|^2 / n^2
                    stats = (gl, (g.float() ** 2).sum(1) / float(n * n))
            else:
                g_shard = reduce_scatter_flat(g, geo.scatter_axes, chunk,
                                              geo.widths,
                                              schedule=self._schedule)
                if with_pulse:
                    # the shards tile the summed buffer, so the sum of
                    # their square norms is |sum|^2: one reduction of the
                    # (local, shard) pair
                    pair = torch.stack(
                        [gl, (g_shard.float() ** 2).sum(1)], dim=1)
                    for ax in geo.scatter_axes:
                        pair = all_reduce(pair, ax)
                    stats = (pair[:, 0] / float(n), pair[:, 1] / float(n * n))
            del g
            p_shard, opt_shard = self._update(
                geo, g_shard, opt_shard, geo.shards_of(params))
            loss = replicated(all_reduce(losses, geo.axes, op="mean"))
            if stats is not None:
                stats = replicated(stats)
        return geo.tree_of(p_shard.reshape(-1)), opt_shard, loss, stats

    def _step3(self, geo, p_shard, opt_shard, batch):
        shards = split_batch(batch, geo.n)
        p_loc = p_shard.detach().requires_grad_(True)
        with self.comm.world():
            # the bucket-wise all-gather inside the step: the full params
            # exist only in flight, and the backward of each bucket's
            # gather is that bucket's reduce-scatter
            full = all_gather_flat(p_loc, geo.scatter_axes, geo.widths,
                                   prefetch=True, schedule=self._schedule)
            # unbind's backward stacks the ranks' cotangents in one copy
            losses = [self._loss_fn(geo.tree_of(row), shard)
                      for row, shard in zip(full.unbind(0), shards)]
            (g_shard,) = torch.autograd.grad(sum(losses), [p_loc])
            del full
            p_new, opt_shard = self._update(geo, g_shard, opt_shard,
                                            p_loc.detach())
            loss = replicated(all_reduce(
                torch.stack([l.detach() for l in losses]), geo.axes,
                op="mean"))
        return p_new, opt_shard, loss


def zero_train_step(loss_fn, inner, comm, stage: Optional[int] = None,
                    average: bool = True, donate: bool = False,
                    bucket_bytes: int = 4 << 20,
                    schedule: Optional[str] = None, plan=None) -> ZeroStep:
    """Build a staged ZeRO data-parallel training step over ``comm``.

    ``stage``: 1 = all-reduce grads + sharded update, 2 (default) =
    bucketed reduce-scatter grads, 3 = stage 2 plus params sharded
    between steps and gathered bucket by bucket inside the step.
    ``bucket_bytes`` sizes the buckets (``[n, width]`` operands of about
    that many bytes).  ``schedule`` is ``"lax"`` (default: a plain
    reduction and copy over the rank axis) or ``"pallas_ring"`` (the
    ring kernels); the geometry is the same either way.  ``plan``
    supplies ``stage`` and maps its ``collective_schedule`` onto the
    bucket schedules; an explicit argument that disagrees raises.
    ``donate`` is accepted for the reference's signature."""
    del donate
    if plan is not None:
        if plan.tp != 1 or plan.pp != 1 or plan.sp != 1:
            raise ValueError(
                f"zero_train_step shards over ONE dp axis but the plan "
                f"carries tp={plan.tp} pp={plan.pp} sp={plan.sp}")
        if not plan.zero_stage:
            raise ValueError("plan.zero_stage is 0 — use dp_train_step")
        if stage is not None and stage != plan.zero_stage:
            raise ValueError(
                f"stage={stage} disagrees with plan.zero_stage="
                f"{plan.zero_stage} — set it in the plan")
        plan_sched = ("pallas_ring"
                      if plan.collective_schedule == "pallas_ring" else "lax")
        if schedule is not None and schedule != plan_sched:
            raise ValueError(
                f"schedule={schedule!r} disagrees with "
                f"plan.collective_schedule={plan.collective_schedule!r} — "
                "set it in the plan")
        stage, schedule = plan.zero_stage, plan_sched
    return ZeroStep(loss_fn, inner, comm, 2 if stage is None else stage,
                    average, bucket_bytes,
                    "lax" if schedule is None else schedule)


def zero1_train_step(loss_fn, inner, comm, average: bool = True,
                     donate: bool = False):
    """The ZeRO-1 step as ``(step, init_opt)``: the all-reduce path of
    :class:`ZeroStep` at stage 1."""
    del donate
    return tuple(ZeroStep(loss_fn, inner, comm, 1, average, 4 << 20))
