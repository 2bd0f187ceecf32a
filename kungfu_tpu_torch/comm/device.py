"""The device-plane communicator over stacked ranks.

Port of ``kungfu_tpu/comm/device.py:116 Communicator``.  Its eager
collectives take values **stacked** on a leading peer axis
(``out[i] = reduce_j x[j]``).  The ranks share one card
(``devices=["cuda:0"] * n``), where the ring kernels run every rank's
program in one launch, or the host (``devices=["cpu"] * n``).

Single-controller, one process holds all ``n`` ranks.  Multi-controller
(the reference's ``_multiproc``), the ranks live in several worker
processes on the one card: a :class:`~kungfu_tpu_torch.comm.world.
ProcessSpan` (``span=``) names them, each process holds
:attr:`Communicator.addressable_n` ranks from
:attr:`Communicator.first_rank`, and every eager collective takes and
returns those rows (the reference's addressable slice), crossing
processes through the span's symmetric buffers.  Every collective gives
each process the rows the one-process communicator of ``n`` ranks gives
them, bit for bit.  Ranks on distinct cards (peer pointers over NVLink)
come with the multi-card slice.

The mesh is the reference's 2-D ``(kf_host, kf_local)``: ``local_size``
ranks per host, ``local_*`` collectives over the intra-host axis,
``cross_*`` over the inter-host one, the rest over both.  Inside a
training step the collectives of :mod:`kungfu_tpu_torch.ops` read the
rank world that :meth:`Communicator.world` enters, as the reference's
read ``shard_map``'s axis environment.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

import torch

from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.ops import collective as coll
from kungfu_tpu_torch.ops.schedules import (ALLREDUCE_SCHEDULES, SIZE_BUCKETS,
                                            all_gather_flat,
                                            all_reduce_scheduled,
                                            bucket_widths, reduce_scatter_flat,
                                            size_bucket)
from kungfu_tpu_torch.utils.device import resolve_device
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

_log = get_logger("kungfu_tpu_torch.comm")

HOST_AXIS = "kf_host"
LOCAL_AXIS = "kf_local"
GLOBAL_AXES = (HOST_AXIS, LOCAL_AXIS)

_REDUCE_OPS = ("sum", "min", "max", "prod", "mean")


def _traced_collective(name: str, op: str, n: int, version: int, fn,
                       device: torch.device, nbytes: Optional[int] = None,
                       sched: Optional[str] = None, hook=None):
    """Run an eager collective under a ``device`` timeline span
    (reference ``comm/device.py:67``).  Launches return before the card
    has run them, so a span or a latency measurement that did not wait
    would time the launch: with tracing on or a latency ``hook``
    installed, the card's queue is drained before the window opens (so
    the window holds this collective alone) and again before it closes.
    ``nbytes`` and ``sched`` stamp the span, and ``hook(nbytes, sched,
    seconds)`` receives the measured execution time.  With neither, the
    call is ``fn()`` and nothing waits."""
    if not timeline.enabled() and hook is None:
        return fn()
    attrs = {"op": op, "n": n, "version": version,
             "trace": timeline.collective_trace_id(
                 version, timeline.current_step(), op, name)}
    if nbytes is not None:
        attrs["nbytes"] = nbytes
    if sched is not None:
        attrs["sched"] = sched
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with timeline.span("device", name, **attrs):
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
    if hook is not None and nbytes is not None and sched is not None:
        try:
            hook(nbytes, sched, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - observers must not break comm
            _log.warning("latency hook failed: %s", e)
    return out


def _one_device(devices: Sequence) -> List[torch.device]:
    """Resolve ``devices`` (default one ``cuda``); every rank must sit on
    the same card, or all on the host."""
    names = list(devices) if devices else [None]
    raw = {str(torch.device("cuda" if d is None else d)) for d in names}
    cards = {d.replace("cuda:0", "cuda") for d in raw}
    if len(cards) > 1:
        raise NotImplementedError(
            f"ranks on distinct devices {sorted(raw)}: the ranks of one "
            "communicator share one card (or the host) until the "
            "multi-card slice brings peer pointers over NVLink")
    return [resolve_device(d) for d in names]


class Communicator:
    """One mesh epoch of ``len(devices)`` co-resident ranks, laid out
    ``(num_hosts, local_size)``.  Immutable, as the reference's."""

    def __init__(self, devices: Optional[Sequence] = None,
                 local_size: Optional[int] = None, strategy: str = "psum",
                 version: int = 0,
                 on_strategy_change: Optional[Callable[[str], None]] = None,
                 span=None):
        self._on_strategy_change = on_strategy_change
        #: this process's devices, one a rank it holds
        self.devices = _one_device(devices)
        self._local_n = len(self.devices)
        #: the ProcessSpan of a multi-controller mesh (None: one process)
        self.span = span
        self._multiproc = span is not None
        if span is not None and span.rows != self._local_n:
            raise ValueError(f"{self._local_n} devices for a span whose "
                             f"processes hold {span.rows} rank(s) each")
        n = span.n if span is not None else self._local_n
        local = n if local_size is None else int(local_size)
        if local < 1 or n % local:
            raise ValueError(f"{n} devices not divisible by "
                             f"local_size={local_size}")
        self.version = version
        self._n, self._local, self._hosts = n, local, n // local
        self.axis = GLOBAL_AXES
        self._bucket_strategy: dict = {}
        self._latency_hook: Optional[Callable] = None
        #: seconds per allreduce of each schedule, as the last
        #: :meth:`autotune_strategy` agreed them
        self.autotune_times: dict = {}
        self.set_strategy(strategy)

    # -- metadata ----------------------------------------------------------
    @property
    def size(self) -> int:
        return self._n

    @property
    def local_size(self) -> int:
        return self._local

    @property
    def num_hosts(self) -> int:
        return self._hosts

    @property
    def addressable_n(self) -> int:
        """The ranks this process holds: the leading axis of every eager
        collective's input and output (``size`` with one controller)."""
        return self._local_n

    @property
    def first_rank(self) -> int:
        """The first rank this process holds (0 with one controller)."""
        return 0 if self.span is None else self.span.first

    @property
    def rank(self) -> int:
        """The controller's first rank: one process holds every rank's
        value (0), or a multi-controller process holds
        :attr:`addressable_n` from here."""
        return self.first_rank

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def world(self):
        """The rank world of this mesh (``(kf_host, num_hosts),
        (kf_local, local_size)``), entered around a step's collectives."""
        return coll.rank_world([(HOST_AXIS, self._hosts),
                                (LOCAL_AXIS, self._local)], span=self.span)

    def first_slot_of_process(self, proc: int) -> int:
        """The first rank (flat slot) held by process ``proc`` (its world
        slot, the reference's ``jax.process_index``): the root a
        :meth:`broadcast_value` takes to broadcast that process's value.
        The mesh is carved in worker-rank order, so a process's ranks are
        contiguous."""
        slots = [0] if self.span is None else self.span.slots
        if proc not in slots:
            raise ValueError(
                f"process {proc} owns no device in this communicator")
        return slots.index(proc) * self._local_n

    def __repr__(self):
        where = (f"on {self.device}" if self.span is None else
                 f"over {self.span.procs} processes on {self.device}, "
                 f"ranks [{self.first_rank}, "
                 f"{self.first_rank + self._local_n}) here")
        return (f"Communicator(v{self.version}, {self._n} ranks as "
                f"{self._hosts}x{self._local} {where})")

    # -- strategy ----------------------------------------------------------
    @property
    def strategy(self) -> str:
        """Active allreduce schedule (:mod:`kungfu_tpu_torch.ops.schedules`)."""
        return self._strategy

    def set_strategy(self, name: str) -> None:
        if name not in ALLREDUCE_SCHEDULES:
            raise ValueError(
                f"unknown strategy {name!r}; one of {ALLREDUCE_SCHEDULES}")
        self._strategy = name
        if self._on_strategy_change is not None:
            # an owning Peer records the choice, so the next mesh epoch
            # is built with it even if this one is being retired
            self._on_strategy_change(name)

    def set_bucket_strategy(self, bucket: int, name: Optional[str]) -> None:
        """Install ``name`` as the schedule of one payload-size bucket
        (:data:`~kungfu_tpu_torch.ops.schedules.SIZE_BUCKETS`); ``None``
        clears the override."""
        if not 0 <= bucket < len(SIZE_BUCKETS):
            raise ValueError(
                f"bucket {bucket} out of range [0, {len(SIZE_BUCKETS)})")
        if name is None:
            self._bucket_strategy.pop(bucket, None)
            return
        if name not in ALLREDUCE_SCHEDULES:
            raise ValueError(
                f"unknown strategy {name!r}; one of {ALLREDUCE_SCHEDULES}")
        self._bucket_strategy[bucket] = name

    def strategy_for_bucket(self, bucket: int) -> str:
        """Active schedule of one payload bucket (the global strategy
        where no override is installed)."""
        return self._bucket_strategy.get(bucket, self._strategy)

    def strategy_for(self, nbytes: int) -> str:
        """Active schedule for a payload of ``nbytes``."""
        return self.strategy_for_bucket(size_bucket(nbytes))

    def bucket_strategies(self) -> dict:
        """Installed per-bucket overrides, ``{bucket_index: name}``."""
        return dict(self._bucket_strategy)

    def bucket_summary(self) -> str:
        """The installed bucket table as ``"small=psum,large=ring"``
        (``""`` when none is installed)."""
        return ",".join(f"{SIZE_BUCKETS[b]}={n}"
                        for b, n in sorted(self._bucket_strategy.items()))

    def set_latency_hook(self, fn: Optional[Callable]) -> None:
        """Install ``fn(nbytes, sched, seconds)`` to receive the execution
        time of every eager :meth:`all_reduce` (the device bandit's
        feed); the measurement drains the card's queue around the
        collective.  ``None`` restores the path that does not wait."""
        self._latency_hook = fn

    def autotune_strategy(self, nbytes: int = 4 << 20, trials: int = 3) -> str:
        """Time every schedule of ``ALLREDUCE_SCHEDULES`` on an f32
        buffer of ``nbytes`` per rank on this mesh and install the
        fastest (reference ``comm/device.py:283``).  A winning time that
        is not a credible measurement keeps the incumbent.  Call it at
        the same point on every controller: the times are agreed over
        the mesh (:meth:`_agree`) before the choice."""
        x = torch.randn((self._local_n, max(1, nbytes // 4)),
                        generator=torch.Generator().manual_seed(0)
                        ).to(self.device)
        prev = self._strategy
        try:
            times = self._time_schedules(x, max(1, trials))
            if all(t is None for t in times):
                raise RuntimeError(
                    "autotune: no allreduce schedule could be timed on "
                    "this mesh (see preceding warnings)")
            # 1e9 marks a schedule that did not run; it loses to any
            # real time
            agreed = self._agree(
                [t if t is not None and math.isfinite(t) else 1e9
                 for t in times], op="mean")
        finally:
            self._strategy = prev
            # the probe's buffer never recurs in training: let it go now
            del x
        idx = min(range(len(agreed)), key=agreed.__getitem__)
        win_t = agreed[idx]
        if not math.isfinite(win_t) or win_t <= 0.0 or win_t >= 1e8:
            _log.warning("autotune: winning time %r is not a credible "
                         "measurement (times %s); keeping %r", win_t,
                         agreed, self._strategy)
            return self._strategy
        self.autotune_times = dict(zip(ALLREDUCE_SCHEDULES, agreed))
        winner = ALLREDUCE_SCHEDULES[idx]
        _log.info("autotune: %s over %s", winner,
                  {s: round(t * 1e3, 4) for s, t in
                   self.autotune_times.items()})
        self.set_strategy(winner)
        return winner

    def _agree(self, row, op: str) -> List[float]:
        """Reduce a small per-controller vector over the mesh, through the
        plain ``psum`` path with the bucket overrides suspended (the
        machinery under measurement carries no agreement traffic).  One
        process holds every rank, so this is the identity; a
        multi-controller mesh agrees here.  The latency hook is
        suspended too: agreement traffic must not land in the bandit's
        windows."""
        stacked = torch.tensor([float(v) for v in row], dtype=torch.float32,
                               device=self.device).expand(self._local_n,
                                                          len(row))
        prev, prev_buckets = self._strategy, self._bucket_strategy
        prev_hook = self._latency_hook
        self._strategy, self._bucket_strategy = "psum", {}
        self._latency_hook = None
        try:
            return self.all_reduce(stacked, op=op)[0].tolist()
        finally:
            self._strategy, self._bucket_strategy = prev, prev_buckets
            self._latency_hook = prev_hook

    def _time_schedules(self, x, trials: int) -> List[Optional[float]]:
        """Seconds per allreduce of ``x`` for each schedule: one salted
        chain of ``k`` allreduces (each feeding the next) timed at two
        ``k``, their difference over the extra allreduces, so the fixed
        cost of a chain cancels; the candidates are interleaved, with a
        running minimum each, so a burst of load cannot land on one
        schedule alone.  On the card the chain is timed with CUDA events,
        on the host with its clock.  ``None`` for a schedule that
        raised."""
        k_lo, k_hi = 4, 16
        cuda = x.device.type == "cuda"

        def chain(sched, k, salt):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            with self.world():
                y = x + salt
                for _ in range(k):
                    y = all_reduce_scheduled(y, GLOBAL_AXES, op="mean",
                                             schedule=sched)
            if cuda:
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            return time.perf_counter() - t0

        ok = {}
        for sched in ALLREDUCE_SCHEDULES:  # warm up each chain once
            try:
                chain(sched, k_lo, 0.5)
                chain(sched, k_hi, 0.5)
                ok[sched] = True
            except RuntimeError as e:
                _log.warning("autotune: schedule %s failed: %s", sched, e)
        if self._multiproc:
            # a schedule that failed in any process is dropped in all, so
            # every process times the same chains
            agreed = self._agree([1.0 if s in ok else 0.0
                                  for s in ALLREDUCE_SCHEDULES], op="min")
            ok = {s: True for s, v in zip(ALLREDUCE_SCHEDULES, agreed)
                  if v >= 1.0}
        salts = torch.Generator().manual_seed(1234)
        best = {s: [math.inf, math.inf] for s in ok}
        for _ in range(trials):
            for sched in ok:
                for i, k in enumerate((k_lo, k_hi)):
                    salt = float(torch.rand((), generator=salts))
                    best[sched][i] = min(best[sched][i],
                                         chain(sched, k, salt))
        return [max((best[s][1] - best[s][0]) / (k_hi - k_lo), 1e-9)
                if s in ok else None for s in ALLREDUCE_SCHEDULES]

    # -- eager collectives on stacked values --------------------------------
    def _check(self, x) -> None:
        coll.check_stacked(x, self._local_n)

    def _mesh_axes(self) -> List[str]:
        return [ax for ax, size in zip(GLOBAL_AXES, (self._hosts, self._local))
                if size > 1]

    def _reduce_leaf(self, a: torch.Tensor, op: str, axes,
                     schedule: Optional[str]) -> torch.Tensor:
        if op == "prod":
            return coll.all_reduce_prod(a, axes)
        if schedule is None:
            schedule = self.strategy_for(a.numel() * a.element_size())
        return all_reduce_scheduled(a, axes, op=op, schedule=schedule)

    def _axis_reduce(self, x, op: str, axes, schedule: Optional[str] = None):
        """Reduce every leaf over ``axes`` with ``schedule`` (default:
        the schedule of the leaf's payload bucket)."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"op {op!r} not in {_REDUCE_OPS}")
        self._check(x)
        with self.world():
            return tree_map(lambda a: self._reduce_leaf(a, op, axes,
                                                        schedule), x)

    def all_reduce(self, x, op: str = "sum"):
        """Stacked allreduce: ``out[i] = reduce_j x[j]``, each leaf with
        the schedule of its payload bucket (:meth:`strategy_for`).  The
        span and the latency hook are attributed to the largest leaf,
        the one that governs the time."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"op {op!r} not in {_REDUCE_OPS}")
        nbytes = max((a.numel() * a.element_size() for a in tree_leaves(x)),
                     default=0)
        return _traced_collective(
            "device.all_reduce", "all_reduce", self._n, self.version,
            lambda: self._axis_reduce(x, op, GLOBAL_AXES), self.device,
            nbytes=nbytes,
            sched=self.strategy_for(nbytes) if op != "prod" else "psum",
            hook=self._latency_hook)

    def local_all_reduce(self, x, op: str = "sum"):
        """Reduce over the intra-host axis only."""
        return self._axis_reduce(x, op, (LOCAL_AXIS,))

    def cross_all_reduce(self, x, op: str = "sum"):
        """Reduce over the inter-host axis only."""
        return self._axis_reduce(x, op, (HOST_AXIS,))

    def reduce(self, x, root: int = 0, op: str = "sum"):
        """Root-valid reduce: rank ``root``'s row holds the reduction
        (a plain ``psum``, as the reference's), every other row its own
        input."""
        self._check_root(root)
        red = self._axis_reduce(x, op, GLOBAL_AXES, schedule="psum")
        lo = self.first_rank

        def leaf(a, r):
            keep = torch.arange(lo, lo + self._local_n, device=a.device) \
                == root
            return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)),
                               r, a)

        return tree_map(leaf, x, red)

    def broadcast(self, x, root: int = 0):
        """``out[i] = x[root]`` for every rank."""
        self._check_root(root)
        self._check(x)

        def run():
            with self.world():
                return coll.broadcast(x, GLOBAL_AXES, root=root)

        return _traced_collective("device.broadcast", "broadcast", self._n,
                                  self.version, run, self.device)

    def broadcast_value(self, value, root_slot: int = 0):
        """Rank ``root_slot``'s copy of one unstacked value, as every
        rank receives it (reference ``comm/device.py:712``), on the
        communicator's device.  One controller holds every rank's value,
        so this is ``value`` itself; a multi-controller mesh sends the
        one row of the process that holds ``root_slot`` (every process
        passes a value of the same shape and dtype), never ``n`` stacked
        copies."""
        if not 0 <= root_slot < self._n:
            raise ValueError(f"root {root_slot} out of range [0, {self._n})")
        value = torch.as_tensor(value).to(self.device, copy=True)
        if self.span is None:
            return value
        return _traced_collective(
            "device.broadcast_value", "broadcast", self._n, self.version,
            lambda: self.span.broadcast(value, root_slot // self._local_n),
            self.device)

    def local_broadcast(self, x):
        """Each host's local-rank-0 row broadcast to the ranks of its
        host (over the intra-host axis only)."""
        self._check(x)
        with self.world():
            return coll.broadcast(x, (LOCAL_AXIS,), root=0)

    def consensus(self, x) -> bool:
        """True iff every rank's row of every leaf is bit-identical:
        allreduce min equals allreduce max (reference
        ``comm/device.py:955``)."""
        self._check(x)
        ok = True
        for leaf in tree_leaves(x):
            a = torch.as_tensor(leaf)
            if a.dtype == torch.bool:
                a = a.to(torch.int32)
            lo = self._axis_reduce(a, "min", GLOBAL_AXES, schedule="psum")
            hi = self._axis_reduce(a, "max", GLOBAL_AXES, schedule="psum")
            ok = ok and bool(torch.equal(lo, hi))
        return ok

    def consensus_bytes(self, digests: Sequence[bytes]) -> bool:
        """Consensus over one byte string per rank (cluster digests):
        True iff all ``n`` agree, lengths included.  A single byte string
        cannot witness agreement and raises ``TypeError``; cross-process
        consensus is :meth:`kungfu_tpu_torch.peer.Peer.consensus_bytes`."""
        if isinstance(digests, (bytes, bytearray)):
            raise TypeError(
                "consensus_bytes needs one digest per peer (a sequence of "
                f"{self._n}); a single local byte string cannot witness "
                "cross-peer agreement — use Peer.consensus_bytes for "
                "host-plane consensus")
        if len(digests) != self._local_n:
            raise ValueError(f"expected {self._local_n} digests (one per "
                             f"addressable peer slot), got {len(digests)}")
        width = max((len(d) for d in digests), default=0)
        lens = torch.tensor([[len(d)] for d in digests], dtype=torch.int32)
        if width:
            rows = torch.stack([torch.frombuffer(
                bytearray(d.ljust(width, b"\0")), dtype=torch.uint8
            ).to(torch.int32) for d in digests])
            stacked = torch.cat([rows, lens], dim=1)
        else:
            stacked = lens
        return self.consensus(stacked.to(self.device))

    def all_gather(self, x):
        """``out[i] = stack_j x[j]``: every rank sees every row,
        ``[n, n, ...]``."""
        self._check(x)

        def run():
            with self.world():
                return coll.all_gather(x, GLOBAL_AXES)

        return _traced_collective("device.all_gather", "all_gather", self._n,
                                  self.version, run, self.device)

    def gather(self, x, root: int = 0):
        """Every rank receives the stacked copy (:meth:`all_gather`): the
        reference's deliberate divergence from a root-only gather."""
        self._check_root(root)
        return self.all_gather(x)

    def reduce_scatter(self, x, op: str = "sum", bucket_bytes: int = 4 << 20):
        """Stacked reduce-scatter: ``out[i]`` is chunk ``i`` of the
        reduction of the rows, each flattened and zero-padded to
        ``n * chunk``; ``[n, chunk]``.  Bucketed as the ZeRO steps are,
        and through the ring kernel when ``pallas_ring`` is the schedule
        of the payload's bucket."""
        if op not in ("sum", "mean"):
            raise ValueError(f"reduce_scatter supports sum/mean, got {op!r}")
        self._check(x)
        n, rows = self._n, self._local_n

        def leaf(a):
            flat = a.reshape(rows, -1)
            size = flat.shape[1]
            chunk = math.ceil(size / n) if size else 0
            if chunk * n > size:
                flat = torch.cat([flat, flat.new_zeros(rows, chunk * n - size)],
                                 1)
            widths = bucket_widths(chunk, n, a.element_size(), bucket_bytes)
            out = reduce_scatter_flat(flat, self._mesh_axes(), chunk, widths,
                                      schedule=self._flat_schedule(a))
            return out / n if op == "mean" else out

        def run():
            with self.world():
                return tree_map(leaf, x)

        return _traced_collective("device.reduce_scatter", "reduce_scatter",
                                  self._n, self.version, run, self.device)

    def all_gather_shard(self, x, bucket_bytes: int = 4 << 20):
        """Inverse of :meth:`reduce_scatter`: each rank's ``[chunk]`` row
        gathered in rank order, ``[n, n * chunk]`` (every row alike),
        bucketed the same way."""
        self._check(x)
        n = self._n

        def leaf(a):
            flat = a.reshape(self._local_n, -1)
            widths = bucket_widths(flat.shape[1], n, a.element_size(),
                                   bucket_bytes)
            return all_gather_flat(flat, self._mesh_axes(), widths,
                                   schedule=self._flat_schedule(a))

        def run():
            with self.world():
                return tree_map(leaf, x)

        return _traced_collective("device.all_gather_shard", "all_gather",
                                  self._n, self.version, run, self.device)

    def _flat_schedule(self, a: torch.Tensor) -> str:
        nbytes = a.numel() * a.element_size()
        return ("pallas_ring" if self.strategy_for(nbytes) == "pallas_ring"
                else "lax")

    def group_all_reduce(self, tensors: List, op: str = "sum",
                         fuse: bool = True):
        """Allreduce a list of stacked tensors, fused into one buffer
        (``fuse=True``) for a single collective."""
        if not fuse:
            return [self.all_reduce(t, op) for t in tensors]
        from kungfu_tpu_torch.ops.fuse import defuse, fuse as fuse_

        flat, spec = fuse_(tensors, batch_axes=1)
        return defuse(self.all_reduce(flat, op), spec)

    def barrier(self) -> None:
        """A one-element allreduce, then the card's queue drains."""
        out = self.all_reduce(torch.ones((self._local_n, 1),
                                         dtype=torch.int32,
                                         device=self.device))
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)

    def close(self) -> None:
        """Let the epoch's symmetric buffers go (a multi-controller mesh
        being retired); the communicator takes no collective after."""
        if self.span is not None:
            self.span.close()

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self._n:
            raise ValueError(f"root {root} out of range [0, {self._n})")
