"""Weight-update sharding (ZeRO stages 1, 2 and 3) over co-resident
stacked ranks.

Port of ``kungfu_tpu/parallel/zero.py``: ``zero1_train_step``,
``_ZeroGeometry``, ``ZeroStep``, ``zero_train_step``,
``zero_comm_bytes``, the optimizer-state byte counts, and the elastic
movement of the sharded state (``zero1_reshard``, ``zero1_snapshot``/
``zero1_restore`` and their ``zero_*`` aliases, ``reshard_plan``,
``zero_reshard_p2p``).  The host bucket pipelines
(``host_bucket_pipeline``, ``host_bucket_all_gather``) come with the
host collective engine.  For an
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

import numpy as np
import torch

from kungfu_tpu_torch.monitor.pulse import PulseMonitor
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.ops.collective import all_reduce, replicated
from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.ops.schedules import (FLAT_SCHEDULES, all_gather_flat,
                                            bucket_widths, reduce_scatter_flat)
from kungfu_tpu_torch.optimizers._transform import apply_updates
from kungfu_tpu_torch.parallel.train import per_rank_grads, split_batch
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                         tree_unflatten)


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


# ==========================================================================
# elastic state movement: re-carving the [n, chunk] rows for a new world
# ==========================================================================
#
# Every stage shares the flat chunk geometry, so these move any stage's
# state, the stage-3 parameter shard included.  A state's vector leaves
# are told apart by that geometry: a 2-D ``[n, ceil(total / n)]`` leaf
# holds rank r's chunk in row r; a 0-d leaf (Adam's ``count``) is
# replicated; any other leaf (a stacked ``[n]`` scalar) moves as it is.
# Re-carving is data movement only, so every path here is bitwise.


def _param_total(params) -> int:
    """The true (unpadded) element count of the param tree."""
    return sum(l.numel() for l in tree_leaves(params))


def _vector_indices(leaves, total: int) -> list:
    """Indices of the ``[n, chunk]`` leaves; a 2-D leaf of another
    geometry was built for another param tree and raises."""
    out = []
    for i, l in enumerate(leaves):
        if l.dim() != 2:
            continue
        rows, cols = l.shape
        if rows < 1 or cols != math.ceil(total / rows):
            raise ValueError(
                f"optimizer state leaf {i} of shape {tuple(l.shape)} is not "
                f"a [n, ceil({total} / n)] carve: params fuse to {total} — "
                "a re-carve needs the SAME param tree the state was built "
                "from")
        out.append(i)
    return out


def _world_of(leaves, vec_idx) -> Optional[int]:
    """The rank count of the vector leaves (all must agree)."""
    ns = {leaves[i].shape[0] for i in vec_idx}
    if len(ns) > 1:
        raise ValueError(f"state leaves are carved for different world "
                         f"sizes {sorted(ns)}")
    return ns.pop() if ns else None


def _repad(full: torch.Tensor, total: int, new_padded: int) -> torch.Tensor:
    """A flat state vector unpadded to the true parameter count and
    re-padded with zeros for a new chunk geometry, on ``full``'s
    device; shared by reshard and restore so their geometry (and its
    misuse diagnostic) cannot drift."""
    if full.numel() < total:
        raise ValueError(
            f"optimizer state vector has {full.numel()} elements but "
            f"params fuse to {total} — zero1 reshard/restore needs the "
            "SAME param tree the state was built from")
    buf = full.new_zeros(new_padded)
    buf[:total] = full.reshape(-1)[:total]
    return buf


def _place_sharded(new_comm, full: Optional[torch.Tensor] = None,
                   my_chunk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A flat state vector as rows on ``new_comm``'s device: the full
    padded buffer as the ``[n, chunk]`` stack of every rank's chunk, or
    one rank's own chunk (one rank per process) as its ``[1, chunk]``
    row."""
    dev = new_comm.device
    if full is not None:
        n = new_comm.size
        return full.reshape(n, full.numel() // n).to(dev)
    return my_chunk.reshape(1, -1).to(dev)


def zero1_reshard(opt_shard, params, new_comm, peer=None, snapshot=None):
    """Re-place a ZeRO optimizer state (or a stage-3 param shard) onto a
    new communicator epoch of ``new_comm.size`` ranks.

    Each vector leaf is unpadded to the true parameter count (from
    ``params``), re-padded to the new chunk geometry and laid out as
    ``[new_n, new_chunk]`` rows on ``new_comm``'s device; scalar leaves
    move as they are.  Values are preserved exactly, so training
    continues as if the optimizer had always run at the new size.

    With a ``snapshot`` (:func:`zero1_snapshot`'s blob, taken over the
    old membership before the resize), or with a ``peer`` (a member of
    a host-plane world receiving rank 0's blob), the state is rebuilt
    through :func:`zero1_restore` instead: ``opt_shard`` then supplies
    only the structure (a joiner passes its fresh ``init_opt(params)``).
    """
    total = _param_total(params)
    n = new_comm.size
    chunk = math.ceil(total / n)
    leaves, treedef = tree_flatten(opt_shard)
    if snapshot is not None or peer is not None:
        # the structure only: a host-plane member holds its own rank's row
        rows = 1 if peer is not None else n
        fresh = [torch.empty((rows, chunk), dtype=l.dtype, device="meta")
                 if l.dim() == 2 else l for l in leaves]
        return zero1_restore(snapshot, tree_unflatten(treedef, fresh),
                             params, peer, new_comm)
    vec_idx = _vector_indices(leaves, total)
    out = [_place_sharded(new_comm, full=_repad(l, total, chunk * n))
           if i in vec_idx else l.to(new_comm.device)
           for i, l in enumerate(leaves)]
    return tree_unflatten(treedef, out)


def _to_numpy(t: torch.Tensor):
    return t.detach().cpu().numpy()


def _member(peer):
    """(channel, member index, member count) of ``peer``, or a lone
    member without one."""
    chan = getattr(peer, "channel", None) if peer is not None else None
    if chan is None:
        return None, 0, 1
    return chan, peer.rank(), len(peer.cluster.workers)


def zero1_snapshot(opt_shard, peer=None):
    """Host snapshot of a ZeRO state at the end of a membership epoch,
    in the reference's npz layout: key ``l{i}_o{offset}`` for each
    rank's chunk of vector leaf ``i`` at its flat offset, ``s{i}`` for
    every other leaf.

    Without a channel every row is local and the blob is assembled in
    place.  Over ``peer``'s host channel each member holds the rows of
    its own ranks (one row per process in a host-plane world) at row
    offset ``peer.rank() * rows``; the members' parts are gathered to
    rank 0, which returns the blob (the others ``None``).  Rank 0 must
    survive the resize: it holds the only copy.
    """
    import io

    chan, member, _ = _member(peer)
    leaves, _ = tree_flatten(opt_shard)
    parts, scalars = {}, {}
    for i, leaf in enumerate(leaves):
        if leaf.dim() != 2:
            scalars[f"s{i}"] = _to_numpy(leaf)
            continue
        rows, chunk = leaf.shape
        host = _to_numpy(leaf)
        for r in range(rows):
            parts[f"l{i}_o{(member * rows + r) * chunk}"] = host[r]

    def pack(d):
        bio = io.BytesIO()
        np.savez(bio, **d)
        return bio.getvalue()

    if chan is None:
        return pack({**parts, **scalars})
    name = f"kf.z1snap.v{peer.cluster_version}"
    gathered = chan.gather_bytes(pack(parts), peer.cluster.workers, name)
    if member != 0:
        return None
    merged = {}
    for blob in gathered:
        with np.load(io.BytesIO(blob)) as z:
            for k in z.files:
                merged[k] = z[k]
    merged.update(scalars)  # replicated: rank 0's copy is everyone's
    return pack(merged)


def zero1_restore(snapshot, fresh_opt_shard, params, peer=None,
                  new_comm=None):
    """Rebuild a ZeRO state for a new epoch from a :func:`zero1_snapshot`
    blob.

    ``fresh_opt_shard`` (``init_opt(params)`` of the new epoch's step)
    supplies the structure and the new geometry: a ``[rows, chunk]``
    vector leaf is this member's rows of a world of ``members * rows``
    ranks (``members`` = 1 without a channel).  Its values are
    overwritten.  Over ``peer``'s channel rank 0 passes the blob and the
    others ``None``; they receive it by broadcast.  The result lies on
    ``new_comm``'s device (else on the host)."""
    import io

    chan, member, members = _member(peer)
    if chan is not None:
        if member == 0 and snapshot is None:
            # fail before the broadcast, or every other member would
            # wait in recv until its timeout
            raise ValueError(
                "zero1_restore: rank 0 must supply the snapshot blob")
        name = f"kf.z1rest.v{peer.cluster_version}"
        snapshot = chan.broadcast_bytes(snapshot, peer.cluster.workers, name)
    if snapshot is None:
        raise ValueError("zero1_restore: no snapshot (rank 0 must supply it)")
    total = _param_total(params)
    dev = new_comm.device if new_comm is not None else torch.device("cpu")
    leaves, treedef = tree_flatten(fresh_opt_shard)
    by_leaf = {}
    with np.load(io.BytesIO(snapshot)) as z:
        for k in z.files:
            if k.startswith("s"):
                by_leaf[("s", int(k[1:]))] = z[k]
            else:
                li, off = k[1:].split("_o")
                by_leaf.setdefault(("l", int(li)), []).append(
                    (int(off), z[k]))
    out = []
    for i, leaf in enumerate(leaves):
        if leaf.dim() != 2:
            val = by_leaf.get(("s", i))
            out.append(leaf if val is None else
                       torch.from_numpy(val.copy()).to(dev))
            continue
        chunks = sorted(by_leaf.get(("l", i), []), key=lambda c: c[0])
        if not chunks:
            raise ValueError(f"snapshot holds no chunks for state leaf {i}")
        # the chunks must tile [0, covered) with no interior gap: a
        # count check misses a hole whenever the old padding is at least
        # one chunk wide, silently restoring zeros into momentum
        expected = 0
        for off, c in chunks:
            if off != expected:
                raise ValueError(
                    f"snapshot leaf {i}: chunk gap at offset {expected} "
                    f"(next chunk starts at {off}) — a contributing "
                    "member's chunks are missing")
            expected = off + c.shape[0]
        full = torch.from_numpy(np.concatenate([c for _, c in chunks]))
        rows, chunk = leaf.shape
        buf = _repad(full, total, members * rows * chunk)
        mine = buf.view(members * rows, chunk)[member * rows:(member + 1) * rows]
        out.append(mine.contiguous().to(dev))
    return tree_unflatten(treedef, out)


# the snapshot/restore/reshard trio moves any stage's state; the aliases
# make call sites say what they mean (reference :1062-1064)
zero_snapshot = zero1_snapshot
zero_restore = zero1_restore
zero_reshard = zero1_reshard


def reshard_plan(total: int, old_n: int, new_n: int):
    """The segment-exchange plan of an ``old_n -> new_n`` re-carve of a
    flat ``total``-element state vector: ``[(old_rank, new_rank, start,
    length)]`` in global flat offsets, covering exactly ``[0, total)``
    (padding is zeros on both sides and never moves).  Every rank
    computes the same plan, so the exchange needs no leader: each rank
    moves only the ``O(total/n)`` elements it owns or will own."""
    if old_n < 1 or new_n < 1:
        raise ValueError(f"world sizes must be >= 1 ({old_n} -> {new_n})")
    oc = math.ceil(total / old_n)
    nc = math.ceil(total / new_n)
    segs = []
    for r in range(new_n):
        lo, hi = r * nc, min((r + 1) * nc, total)
        if lo >= hi:
            continue  # new rank holds pure padding
        for o in range(lo // oc, (hi - 1) // oc + 1):
            s = max(lo, o * oc)
            e = min(hi, (o + 1) * oc, total)
            if s < e:
                segs.append((o, r, s, e - s))
    return segs


def zero_reshard_p2p(opt_shard, params, new_comm, peer=None,
                     new_workers=None, old_n: Optional[int] = None,
                     tag: str = "0"):
    """Peer-to-peer re-carve of a ZeRO state: every old member sends
    exactly the segments of its chunk that the new geometry assigns
    elsewhere, every new member assembles its chunk from them, by
    :func:`reshard_plan`.  No gather to a leader, no full-state blob.

    Without a channel every old row is local: the plan is replayed on
    the rows (the same data movement as the wire path, minus the wire)
    into ``[new_comm.size, new_chunk]`` rows on ``new_comm``'s device.

    Over ``peer``'s host channel each member holds its own rank's row
    (vector leaves ``[1, old_chunk]``) of the OLD membership
    ``peer.cluster.workers``; it returns its ``[1, new_chunk]`` row of
    the new world ``new_workers`` of ``new_comm.size`` ranks, or
    ``None`` for a leaver.  A joiner passes its fresh
    ``init_opt(params)`` for structure and receives the replicated
    leaves from old rank 0.  ``tag`` (the agreed new cluster version)
    must match on every participant.
    """
    from kungfu_tpu_torch.comm.host import tensor_buffer
    from kungfu_tpu_torch.elastic.reshard import _recv_or_fail

    total = _param_total(params)
    new_n = new_comm.size
    new_chunk = math.ceil(total / new_n)
    leaves, treedef = tree_flatten(opt_shard)
    dev = new_comm.device
    chan = getattr(peer, "channel", None) if peer is not None else None

    if chan is None:
        vec_idx = _vector_indices(leaves, total)
        if old_n is None:
            old_n = _world_of(leaves, vec_idx) or new_n
        plan = reshard_plan(total, old_n, new_n)
        out = []
        for i, leaf in enumerate(leaves):
            if i not in vec_idx:
                out.append(leaf.to(dev))
                continue
            full = leaf.reshape(-1)
            buf = full.new_zeros(new_chunk * new_n)
            for (_, _, s, ln) in plan:
                buf[s:s + ln] = full[s:s + ln]
            out.append(_place_sharded(new_comm, full=buf))
        return tree_unflatten(treedef, out)

    # -- host-channel exchange --------------------------------------------
    import io

    if new_workers is None:
        raise ValueError("zero_reshard_p2p over a channel needs the agreed "
                         "new worker list")
    old_workers = peer.cluster.workers
    if old_n is None:
        old_n = len(old_workers)
    me = peer.config.self_id
    my_old, my_new = old_workers.rank(me), new_workers.rank(me)
    plan = reshard_plan(total, old_n, new_n)
    old_chunk = math.ceil(total / old_n)
    vec_idx = [i for i, l in enumerate(leaves) if l.dim() == 2]
    for i in vec_idx:
        if my_old is not None and tuple(leaves[i].shape) != (1, old_chunk):
            raise NotImplementedError(
                "zero_reshard_p2p over a channel takes one rank per "
                f"process, its [1, {old_chunk}] row; leaf {i} has shape "
                f"{tuple(leaves[i].shape)}")
    mine = {i: leaves[i].detach().reshape(-1).cpu().contiguous()
            for i in vec_idx} if my_old is not None else {}
    off = (my_old or 0) * old_chunk

    def seg_name(i, s):
        return f"kf.zrs.{tag}.l{i}.o{s}"

    # 1) serve: every segment my old chunk owns, destined elsewhere
    if my_old is not None:
        for (o, r, s, ln) in plan:
            if o != my_old or new_workers[r] == me:
                continue
            for i in vec_idx:
                chan.send(new_workers[r], seg_name(i, s),
                          tensor_buffer(mine[i][s - off:s - off + ln]))
        if my_old == 0:
            # the replicated leaves for pure joiners (no owner: any
            # surviving copy is the copy)
            bio = io.BytesIO()
            np.savez(bio, **{f"s{i}": _to_numpy(l)
                             for i, l in enumerate(leaves)
                             if i not in vec_idx})
            for w in new_workers:
                if old_workers.rank(w) is None:
                    chan.send(w, f"kf.zrs.{tag}.scalars", bio.getvalue())
    if my_new is None:
        return None  # leaver: served its segments, holds nothing now

    # 2) assemble my new chunk
    scalars = None
    if my_old is None:
        with np.load(io.BytesIO(_recv_or_fail(
                chan, old_workers[0], 0, "zero-reshard",
                f"kf.zrs.{tag}.scalars"))) as z:
            scalars = {k: z[k] for k in z.files}
    lo = my_new * new_chunk
    out = []
    for i, leaf in enumerate(leaves):
        if i not in vec_idx:
            val = (torch.from_numpy(scalars[f"s{i}"].copy())
                   if scalars is not None else leaf)
            out.append(val.to(dev))
            continue
        buf = torch.zeros(new_chunk, dtype=leaf.dtype)
        for (o, r, s, ln) in plan:
            if r != my_new:
                continue
            if o == my_old:
                buf[s - lo:s - lo + ln] = mine[i][s - off:s - off + ln]
            else:
                _recv_or_fail(chan, old_workers[o], o, "zero-reshard",
                              seg_name(i, s), buf[s - lo:s - lo + ln])
        out.append(_place_sharded(new_comm, my_chunk=buf))
    return tree_unflatten(treedef, out)
