"""Elastic re-sharding of ZeRO state from the committed step boundary
(port of ``kungfu_tpu/elastic/reshard.py``).

A ZeRO state has geometry: rank r holds the contiguous
``ceil(total / n)`` chunk of every flat state vector, in the port row r
of a ``[n, chunk]`` leaf.  A membership change (a scheduled resize, or a
shrink to the survivors after a peer died) changes ``n``, and the state
must be re-carved from the last committed step:

* :class:`ZeroBoundary` holds a host copy of the state as of that step:
  the full flat vectors when one controller holds every rank (full
  mode: the port's co-resident worlds), or one rank's chunk when each
  process holds its own (chunk mode, :meth:`ZeroBoundary.commit_local`),
  plus the replicated leaves and the geometry ``(step, total, old_n)``;
* :meth:`ZeroBoundary.replicate_ring` mirrors each rank's chunk on its
  ring predecessor over the host channel, so a dead rank's chunk
  survives there;
* :meth:`ZeroBoundary.recarve` moves the segments of
  :func:`~kungfu_tpu_torch.parallel.zero.reshard_plan`, which every rank
  computes alike: leaderless, ``O(total/n)`` bytes a rank;
* :meth:`ZeroBoundary.place` (and :func:`place_stacked` for the ranks
  of one controller) lays the new carve out as ``[new_n, new_chunk]``
  rows on the new communicator's device.

The re-carve is bitwise: segments move untouched and padding is zeros
on both sides, so training after it continues exactly as a fixed-size
world restored from the same boundary would.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from kungfu_tpu_torch.checkpoint import StepSnapshot, host_copy
from kungfu_tpu_torch.comm.faults import PeerFailureError
from kungfu_tpu_torch.comm.host import tensor_buffer
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.parallel.zero import (_param_total, _place_sharded,
                                            _vector_indices, _world_of,
                                            reshard_plan)
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten


def _recv_or_fail(chan, addr, old_rank: int, op: str, name: str, buf=None):
    """Receive one re-carve frame (into ``buf``, a host tensor, when one
    is given), turning a raw channel timeout into the typed
    :class:`PeerFailureError` the recovery contract promises: the
    exchange runs inside the recovery path, whose callers catch
    ``PeerFailureError`` to re-enter recovery after a second death."""
    try:
        if buf is None:
            return chan.recv(addr, name)
        if not chan.recv_into(addr, name, tensor_buffer(buf)):
            got = len(chan.recv(addr, name))
            raise ValueError(
                f"recarve segment {name}: expected {buf.numel()} elements "
                f"({buf.numel() * buf.element_size()} bytes), got {got} "
                "bytes")
        return buf
    except PeerFailureError:
        raise
    except (TimeoutError, OSError) as e:
        raise PeerFailureError(old_rank, peer=addr, op=op,
                               phase=f"recv {name!r}", cause=e) from e


def _chunk_leaves(leaves, chunk: Optional[int] = None) -> set:
    """Indices of a per-rank tree's chunk leaves (any leaf with an axis:
    one rank's tree holds no stacked scalars); with ``chunk`` each must
    hold exactly that many elements."""
    idx = set()
    for i, l in enumerate(leaves):
        if l.dim() < 1:
            continue
        if chunk is not None and l.numel() != chunk:
            raise ValueError(
                f"state leaf {i} has shape {tuple(l.shape)}, expected one "
                f"({chunk},) chunk")
        idx.add(i)
    return idx


class ZeroBoundary:
    """Host-side committed boundary of a ZeRO-sharded optimizer state.

    Commit once per applied step (a host copy of the state); after a
    membership change :meth:`recarve` rebuilds it for the new world size
    and :meth:`place` puts it on the new communicator.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._step: Optional[int] = None
        self._treedef = None
        self._total: Optional[int] = None
        self._old_n: Optional[int] = None
        self._my_old: Optional[int] = None
        self._chunk: Optional[int] = None
        #: vector leaves: {leaf index: flat host chunk or full vector}
        self._vec: Dict[int, torch.Tensor] = {}
        self._full_mode = True
        #: every other leaf: {leaf index: host copy}
        self._scal: Dict[int, torch.Tensor] = {}
        #: ring-buddy mirror of the successor's chunks (chunk mode)
        self._buddy: Dict[int, torch.Tensor] = {}
        self._buddy_of: Optional[int] = None
        #: ring distance of the buddy exchange (1 = adjacent successor;
        #: a multislice world uses ranks_per_slice, so every mirror lands
        #: in another slice)
        self._buddy_stride: int = 1
        #: vector leaf dtypes (kept even when a joiner holds no data)
        self._vec_dtypes: Dict[int, torch.dtype] = {}

    def _set(self, step, treedef, total, old_n, my_old, chunk, vec, scal,
             full_mode, dtypes=None) -> None:
        with self._lock:
            self._step = int(step)
            self._treedef = treedef
            self._total = int(total)
            self._old_n = int(old_n)
            self._my_old = my_old
            self._chunk = chunk
            self._vec = vec
            self._scal = scal
            self._full_mode = full_mode
            self._vec_dtypes = dtypes if dtypes is not None else {
                i: a.dtype for i, a in vec.items()}
            # a fresh commit invalidates any buddy mirror of older state
            self._buddy = {}
            self._buddy_of = None
            self._buddy_stride = 1

    # -- commit -----------------------------------------------------------
    def commit(self, step: int, opt_shard, params) -> None:
        """Record the ZeRO state (``[n, chunk]`` vector leaves, every
        rank's row: full mode) as of completed step ``step``.

        ``params`` supplies the true (unpadded) parameter count: the
        re-carve must not move old padding into a smaller new padded
        total.  Every leaf is copied to the host, so later steps cannot
        change the boundary."""
        leaves, treedef = tree_flatten(opt_shard)
        total = _param_total(params)
        vec_idx = _vector_indices(leaves, total)
        old_n = _world_of(leaves, vec_idx) or 1
        vec = {i: host_copy(leaves[i]).reshape(-1) for i in vec_idx}
        scal = {i: host_copy(l) for i, l in enumerate(leaves)
                if i not in vec}
        self._set(step, treedef, total, old_n, 0, math.ceil(total / old_n),
                  vec, scal, True)

    def commit_local(self, step: int, opt_chunk_tree, total: int,
                     old_n: int, my_old: int) -> None:
        """Chunk-mode commit: this process holds rank ``my_old``'s state
        over its own ``ceil(total/old_n)`` chunk (its row of the stacked
        state, or a host-plane worker's own).  Chunk leaves must hold
        exactly one chunk; 0-d leaves are replicated."""
        leaves, treedef = tree_flatten(opt_chunk_tree)
        chunk = math.ceil(total / old_n) if old_n else int(total)
        vec_idx = _chunk_leaves(leaves, chunk)
        vec = {i: host_copy(leaves[i]).reshape(-1) for i in vec_idx}
        scal = {i: host_copy(l) for i, l in enumerate(leaves)
                if i not in vec_idx}
        self._set(step, treedef, total, old_n, int(my_old), chunk, vec,
                  scal, False)

    def join(self, fresh_opt_shard, params, old_n: int) -> None:
        """Joiner bootstrap: a worker entering an existing world holds no
        committed chunk but takes part in the next :meth:`recarve` as a
        pure receiver.  ``fresh_opt_shard`` (one rank's fresh state)
        supplies the structure and leaf dtypes; ``old_n`` is the
        incumbent world size the exchange re-carves from."""
        leaves, treedef = tree_flatten(fresh_opt_shard)
        vec_idx = _chunk_leaves(leaves)
        scal = {i: host_copy(l) for i, l in enumerate(leaves)
                if i not in vec_idx}
        # step -1: no local progress; adopted from the serving side
        self._set(-1, treedef, _param_total(params), old_n, None, None, {},
                  scal, False, {i: leaves[i].dtype for i in vec_idx})

    def chunks(self) -> Tuple[int, Dict[int, torch.Tensor],
                              Dict[int, torch.Tensor]]:
        """(step, vector chunks, other leaves) of the current carve."""
        with self._lock:
            return self._step, dict(self._vec), dict(self._scal)

    def export_carve(self):
        """One-lock snapshot of this rank's own committed carve:
        ``(step, total, old_n, my_old, chunk, full_mode, vec, scal)``.
        The buddy mirror is left out: its owner exports those bytes."""
        with self._lock:
            return (self._step, self._total, self._old_n, self._my_old,
                    self._chunk, self._full_mode, dict(self._vec),
                    dict(self._scal))

    def step(self) -> Optional[int]:
        with self._lock:
            return self._step

    @property
    def old_n(self) -> Optional[int]:
        with self._lock:
            return self._old_n

    # -- ring-buddy redundancy (chunk mode) -------------------------------
    def replicate_ring(self, chan, workers, tag: str = "0",
                       stride: int = 1) -> int:
        """Mirror this rank's committed chunks onto the rank ``stride``
        positions behind it and adopt the chunks of the rank ``stride``
        ahead, so any single dead rank's chunk survives ``stride``
        positions away.  ``tag`` and ``stride`` must match on every rank
        (they are part of the exchange).  Returns the bytes this rank
        sent (0 in full mode, where nothing can be lost)."""
        with self._lock:
            if self._step is None:
                raise ValueError("replicate_ring before any commit")
            if self._full_mode:
                return 0
            vec = dict(self._vec)
            my_old, n = self._my_old, self._old_n
        if n is None or n < 2:
            return 0
        stride = int(stride)
        if not 1 <= stride < n:
            raise ValueError(
                f"buddy stride {stride} must be in [1, {n}) — a stride "
                "of the whole ring mirrors a rank onto itself")
        pred = workers[(my_old - stride) % n]
        succ_rank = (my_old + stride) % n
        # the reference's mark and fields; nbytes counts the raw chunk
        # bytes this rank sends (the reference's, its npz blob's)
        timeline.event("shrink", "buddy-replicate", rank=my_old,
                       nbytes=sum(a.numel() * a.element_size()
                                  for a in vec.values()), stride=stride)
        sent = 0
        for i, a in vec.items():
            chan.send(pred, f"kf.zbuddy.{tag}.v{i}", tensor_buffer(a))
            sent += a.numel() * a.element_size()
        buddy = {i: _recv_or_fail(chan, workers[succ_rank], succ_rank,
                                  "zero-buddy", f"kf.zbuddy.{tag}.v{i}",
                                  torch.empty_like(a))
                 for i, a in vec.items()}
        with self._lock:
            self._buddy = buddy
            self._buddy_of = succ_rank
            self._buddy_stride = stride
        return sent

    # -- re-carve ---------------------------------------------------------
    def recarve(self, new_n: int, peer=None, old_workers=None,
                new_workers=None, tag: str = "0",
                dead: Optional[Sequence[int]] = None,
                expect_step: Optional[int] = None) -> None:
        """Re-shard the committed state in place for a ``new_n``-rank
        world, leaderless: every participant computes the same
        :func:`~kungfu_tpu_torch.parallel.zero.reshard_plan` and moves
        only the segments it owns or will own.

        Full mode needs no peers.  Chunk mode exchanges segments over
        ``peer``'s host channel between ``old_workers`` (the membership
        the boundary was committed under) and ``new_workers``.  ``dead``
        names OLD ranks that cannot serve; their segments come from the
        ring-buddy mirror on their predecessor (:meth:`replicate_ring`),
        and without one this raises.  Old ranks absent from
        ``new_workers`` but not dead are leavers: they serve their
        segments and drop their shard.  Every participant passes the
        same ``dead`` set: it is part of the plan.

        ``expect_step`` is the cluster-agreed committed step: a boundary
        committed at another step raises rather than blend optimizer
        states of two steps (escalate to the checkpoint restart).
        """
        with self._lock:
            if self._step is None:
                raise ValueError("recarve before any commit")
            total, old_n = self._total, self._old_n
            full_mode, step = self._full_mode, self._step
        if (expect_step is not None and step >= 0
                and step != int(expect_step)):
            raise ValueError(
                f"boundary committed at step {step} but the cluster agreed "
                f"to replay from step {expect_step} — a re-carve would "
                "blend optimizer states from different steps; escalate to "
                "the checkpoint restart")
        if new_n < 1:
            raise ValueError(f"new_n must be >= 1, got {new_n}")
        plan = reshard_plan(total, old_n, new_n)
        new_chunk = math.ceil(total / new_n)
        timeline.event("shrink", "zero-recarve", old_n=old_n, new_n=new_n,
                       total=total, segments=len(plan))
        if full_mode:
            # local slicing only: keep [0, total), zero the padding
            with self._lock:
                for i, full in self._vec.items():
                    if full.numel() < total:
                        raise ValueError(
                            f"state vector {i} has {full.numel()} elements "
                            f"but params fuse to {total} — boundary was "
                            "committed against a different param tree")
                    buf = torch.empty(new_chunk * new_n, dtype=full.dtype,
                                      pin_memory=full.is_pinned())
                    buf[:total] = full[:total]
                    buf[total:] = 0
                    self._vec[i] = buf
                self._old_n = new_n
                self._my_old = 0
                self._chunk = new_chunk
            return
        self._recarve_channel(plan, new_n, new_chunk, peer, old_workers,
                              new_workers, tag, dead)

    def _recarve_channel(self, plan, new_n, new_chunk, peer, old_workers,
                         new_workers, tag, dead=None):
        if peer is None or old_workers is None or new_workers is None:
            raise ValueError(
                "chunk-mode recarve needs peer + old_workers + new_workers")
        chan = peer.channel
        with self._lock:
            my_old, old_n = self._my_old, self._old_n
            chunk, step = self._chunk, self._step
            vec = dict(self._vec)
            dtypes = dict(self._vec_dtypes)
            buddy, buddy_of = dict(self._buddy), self._buddy_of
            stride = self._buddy_stride
        me = peer.config.self_id
        # the plan comes from the boundary's recorded epoch while the
        # addressing uses old_workers: a stale boundary would serve wrong
        # bytes under matching names, so fail before any bytes move
        if len(old_workers) != old_n:
            raise ValueError(
                f"boundary was committed under {old_n} ranks but "
                f"old_workers has {len(old_workers)} members — stale "
                "boundary or wrong membership epoch")
        if my_old is not None and old_workers.rank(me) != my_old:
            raise ValueError(
                f"boundary records this rank as old rank {my_old} but "
                f"old_workers places it at {old_workers.rank(me)} — stale "
                "boundary or wrong membership epoch")
        my_new = new_workers.rank(me)
        dead = {int(d) for d in (dead or ())}
        # every old rank still able to answer: survivors and planned
        # leavers (alive, detaching only after this)
        alive = {r for r in range(old_n) if r not in dead}

        def server_of(o: int) -> Optional[int]:
            """Old rank whose host serves old rank ``o``'s segments."""
            if o in alive:
                return o
            pred = (o - stride) % old_n
            return pred if pred in alive else None  # from its mirror

        for o in dead:
            serv = server_of(o)
            if serv is None:
                raise ValueError(
                    f"old rank {o} is dead and so is its buddy predecessor "
                    f"{(o - stride) % old_n} (stride {stride}) — chunk "
                    "unrecoverable (buddy redundancy covers one failure "
                    "domain; escalate to the checkpoint restart)")
            if serv == my_old and buddy_of != o:
                raise ValueError(
                    f"old rank {o} is dead and this rank holds no buddy "
                    "mirror of its chunk (replicate_ring was never run on "
                    "this boundary) — chunk unrecoverable")

        def seg_name(i: int, s: int) -> str:
            return f"kf.zrc.{tag}.l{i}.o{s}"

        def local_source(o: int) -> Optional[Dict[int, torch.Tensor]]:
            if o == my_old:
                return vec
            if o == buddy_of and buddy:
                return buddy
            return None

        # 1) serve every segment this host is responsible for
        offs = {}
        if my_old is not None:
            offs[my_old] = my_old * chunk
        if buddy_of is not None:
            offs[buddy_of] = buddy_of * chunk
        for (o, r, s, ln) in plan:
            if my_old is None or server_of(o) != my_old:
                continue
            src = local_source(o)
            if src is None:
                raise AssertionError(
                    f"server {my_old} has no data for old rank {o}")
            dst = new_workers[r]
            if dst == me:
                continue
            off = offs[o]
            for i, data in src.items():
                chan.send(dst, seg_name(i, s),
                          tensor_buffer(data[s - off:s - off + ln]))
        # the replicated leaves and the boundary step for pure joiners,
        # in StepSnapshot's wire form, served by the lowest surviving old
        # rank (replicated leaves have no owner: any copy is the copy)
        serving_scal = min(alive) if alive else None
        if my_old is not None and my_old == serving_scal:
            with self._lock:
                scal = dict(self._scal)
            snap = StepSnapshot()
            snap.commit(step, scal)
            blob = snap.serialize()
            for w in new_workers:
                if old_workers.rank(w) is None:
                    chan.send(w, f"kf.zrc.{tag}.scalars", blob)

        if my_new is None:
            # leaver: served its segments; drop the now-stale shard
            with self._lock:
                self._vec = {}
            return

        # 2) assemble my new chunk
        if my_old is None:
            if serving_scal is None:
                raise ValueError("no surviving old member to receive from")
            blob = _recv_or_fail(chan, old_workers[serving_scal],
                                 serving_scal, "zero-recarve",
                                 f"kf.zrc.{tag}.scalars")
            with self._lock:
                template = dict(self._scal)
            snap = StepSnapshot()
            snap.commit(-1, template)
            step, scal, _ = snap.adopt(blob)
            with self._lock:
                self._scal = scal
                self._step = step
        lo = my_new * new_chunk
        new_vec = {i: torch.zeros(new_chunk, dtype=dt)
                   for i, dt in dtypes.items()}
        for (o, r, s, ln) in plan:
            if r != my_new:
                continue
            src = (local_source(o)
                   if my_old is not None and server_of(o) == my_old
                   else None)
            if src is not None:
                off = offs[o]
                for i, data in src.items():
                    new_vec[i][s - lo:s - lo + ln] = data[s - off:s - off + ln]
                continue
            serv = server_of(o)
            for i in new_vec:
                _recv_or_fail(chan, old_workers[serv], serv, "zero-recarve",
                              seg_name(i, s), new_vec[i][s - lo:s - lo + ln])
        with self._lock:
            self._vec = new_vec
            self._old_n = new_n
            self._my_old = my_new
            self._chunk = new_chunk
            self._buddy = {}
            self._buddy_of = None
            self._buddy_stride = 1

    # -- placement --------------------------------------------------------
    def place(self, new_comm):
        """The state tree on ``new_comm``'s device from the (re-carved)
        boundary: in full mode every rank's ``[new_n, new_chunk]`` rows,
        in chunk mode this rank's ``[1, new_chunk]`` row (use
        :func:`place_stacked` to stack the rows of co-resident ranks);
        the other leaves copied as they are.  Call after :meth:`recarve`
        with ``new_comm.size == new_n``."""
        with self._lock:
            if self._treedef is None:
                raise ValueError("place before any commit")
            if self._old_n != new_comm.size:
                raise ValueError(
                    f"boundary is carved for {self._old_n} ranks but the "
                    f"communicator has {new_comm.size} — recarve first")
            out = []
            for i in range(len(self._vec_dtypes) + len(self._scal)):
                if i in self._vec:
                    kw = ({"full": self._vec[i]} if self._full_mode
                          else {"my_chunk": self._vec[i]})
                    out.append(_place_sharded(new_comm, **kw))
                else:
                    out.append(self._scal[i].to(new_comm.device, copy=True))
            return tree_unflatten(self._treedef, out)


def place_stacked(boundaries: Sequence[ZeroBoundary], new_comm):
    """The ``[new_n, new_chunk]`` state of ``new_comm``'s co-resident
    ranks from their chunk-mode boundaries, one per new rank in rank
    order (after each has re-carved): the rows of their :meth:`place`,
    stacked, and the replicated leaves from new rank 0."""
    if len(boundaries) != new_comm.size:
        raise ValueError(f"{len(boundaries)} boundaries for a world of "
                         f"{new_comm.size} ranks")
    for r, b in enumerate(boundaries):
        with b._lock:
            if b._full_mode or b._my_old != r:
                raise ValueError(
                    f"boundary {r} holds new rank {b._my_old}'s chunk "
                    f"(full mode {b._full_mode}); pass one chunk-mode "
                    "boundary per new rank, in rank order")
    rows = [tree_flatten(b.place(new_comm))[0] for b in boundaries]
    first, treedef = tree_flatten(boundaries[0].place(new_comm))
    vec_idx = set(boundaries[0]._vec_dtypes)
    return tree_unflatten(treedef, [
        torch.cat([leaves[i] for leaves in rows]) if i in vec_idx else l
        for i, l in enumerate(first)])


def recarve_after_shrink(peer, boundary: ZeroBoundary, old_workers,
                         expect_step: Optional[int] = None) -> None:
    """Shrink-recovery hook: re-carve ``boundary`` across the survivors.

    Call after the shrink succeeded (``peer.cluster.workers`` is already
    the survivor list); ``old_workers`` is the membership the boundary
    was committed under.  Every old rank absent from the survivors is
    confirmed dead, not a leaver: its chunks come from the ring-buddy
    mirrors.  ``expect_step`` is the agreed replay step."""
    new_workers = peer.cluster.workers
    dead = [r for r, w in enumerate(old_workers)
            if new_workers.rank(w) is None]
    boundary.recarve(
        len(new_workers), peer=peer, old_workers=old_workers,
        new_workers=new_workers, tag=f"v{peer.cluster_version}",
        dead=dead, expect_step=expect_step,
    )
