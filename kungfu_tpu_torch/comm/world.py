"""The process world: one communicator across worker processes on one card.

The counterpart of the reference's multi-controller device world
(``kungfu_tpu/peer.py:239 _init_jax_distributed`` and ``:293
_carve_active_devices``).  Under the TPU backend every worker of a job
joins one ``jax.distributed`` world, and a communicator's mesh is carved
over the active workers' devices.  The port's worker processes share one
card, so the world is a set of processes that can open each other's
device buffers:

* :class:`ProcessWorld` is booted once per process over every slot of
  the world (the provisioned world's slots, or a fixed world's initial
  workers): each slot's process, backend, card and rank count are
  exchanged over the host channel and checked to share one card.
* :meth:`ProcessWorld.span` hands a communicator epoch its active
  processes in worker-rank order, as a :class:`ProcessSpan`.
* A :class:`ProcessSpan` owns the epoch's **symmetric buffers**: each
  process allocates one buffer, publishes a handle to it tagged with the
  cluster version, and maps every peer's.  On the card the buffer is a
  ``cudaMalloc`` of its own, exported and mapped through CUDA IPC
  (:mod:`kungfu_tpu_torch.ops.cuda.collectives`); on the host it is POSIX
  shared memory (``multiprocessing.shared_memory``) with the same
  protocol.
* The fence: a process copies its ranks' rows into its buffer, drains its
  stream, and meets the others at a host-channel barrier; only then does
  anyone read a peer's rows, and each reader drains its stream again
  before it returns.  The buffer has two slots used in turn, so a
  process may write its next rows while a slower peer still reads the
  last ones: a slot is written again only after the barrier that follows
  every read of it.  Nothing spins inside a kernel.
* Release: a process unmaps the peers' buffers, meets the others, and
  only then frees its own, so no buffer is freed while a peer maps it.

Process ``q`` of a span holds the stacked rows of ranks ``[q * rows,
(q + 1) * rows)``; every process holds the same number of rows.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from typing import List, Optional, Sequence

import torch

from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("kungfu_tpu_torch.world")

#: byte alignment of each leaf in a symmetric buffer slot
_ALIGN = 256
#: the least slot size, and the granule a slot grows by
_GRANULE = 1 << 20


def _card_of(device: torch.device) -> str:
    """The identity of the card (or host) a process's ranks live on."""
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return f"cuda:{getattr(props, 'uuid', props.name)}"
    return f"host:{socket.gethostname()}"


class ProcessWorld:
    """The worker processes of one device world, booted once.

    ``slots`` lists every process of the world in slot order (the
    provisioned ``KF_WORLD_PEERS``, or a fixed world's initial workers);
    this process is ``self_id`` and holds ``rows`` stacked ranks on
    ``device``.  :meth:`boot` exchanges every slot's description over
    ``channel`` (all slots must call it) and refuses a world whose
    processes do not share one card and one rank count."""

    def __init__(self, channel, slots: PeerList, self_id, device,
                 rows: int = 1):
        if slots.rank(self_id) is None:
            raise ValueError(f"{self_id} is not a slot of the world {slots}")
        if rows < 1:
            raise ValueError(f"rows {rows} < 1")
        self.channel = channel
        self.slots = slots
        self.self_id = self_id
        self.device = torch.device(device)
        self.rows = int(rows)
        #: one description a slot, in slot order, after :meth:`boot`
        self.described: Optional[List[dict]] = None
        #: names this world's shared-memory segments apart
        self.token = ""
        #: seconds the boot took
        self.boot_s = 0.0

    def boot(self) -> "ProcessWorld":
        """Exchange every slot's description once (idempotent)."""
        if self.described is not None:
            return self
        t0 = time.perf_counter()
        me = {"pid": os.getpid(), "kind": self.device.type,
              "card": _card_of(self.device), "rows": self.rows,
              "token": uuid.uuid4().hex[:10]}
        blobs = self.channel.allgather_bytes(
            json.dumps(me).encode(), self.slots, name="kf.world.boot")
        described = [json.loads(b.decode()) for b in blobs]
        kinds = {d["kind"] for d in described}
        cards = {d["card"] for d in described}
        rows = {d["rows"] for d in described}
        if len(kinds) > 1:
            raise ValueError(f"world slots on different backends {kinds}")
        if len(cards) > 1:
            raise NotImplementedError(
                f"world slots on distinct cards {sorted(cards)}: a "
                "process-spanning communicator shares one card until the "
                "multi-card slice brings peer pointers over NVLink")
        if len(rows) > 1:
            raise ValueError(f"world slots hold different rank counts "
                             f"{sorted(rows)}: every process must hold the "
                             "same number of ranks")
        self.described = described
        self.token = described[0]["token"]
        self.boot_s = time.perf_counter() - t0
        _log.info("process world up: %d slots on %s, %d rank(s) each "
                  "(%.1f ms)", len(self.slots), self.device, self.rows,
                  self.boot_s * 1e3)
        return self

    def span(self, workers: PeerList, version: int) -> "ProcessSpan":
        """The processes of ``workers`` (the active workers, in rank
        order) as one communicator epoch of the cluster ``version``."""
        self.boot()
        missing = [str(w) for w in workers if self.slots.rank(w) is None]
        if missing:
            raise RuntimeError(
                f"workers {missing} are outside the process world "
                f"({len(self.slots)} slots): a communicator spans only "
                "processes booted into the world")
        return ProcessSpan(self, workers, version)


class _Region:
    """One process's symmetric buffer as seen from this process: its
    bytes as a ``uint8`` tensor, and how to let it go."""

    def __init__(self, tensor: torch.Tensor, release, handle: bytes = b"",
                 unlink=None):
        self.tensor = tensor
        self.handle = handle
        self._release = release
        #: drops the name of a shared-memory segment this process made
        self.unlink = unlink

    def close(self) -> None:
        self.tensor = None
        if self._release is not None:
            release, self._release = self._release, None
            release()


def _cuda_region(nbytes: int, device) -> _Region:
    from kungfu_tpu_torch.ops.cuda import collectives as kernels

    ptr, handle = kernels.sym_alloc(nbytes, device)
    return _Region(kernels.device_bytes(ptr, nbytes, device),
                   lambda: kernels.sym_free(ptr), handle)


def _cuda_open(handle: bytes, nbytes: int, device) -> _Region:
    from kungfu_tpu_torch.ops.cuda import collectives as kernels

    ptr = kernels.sym_open(handle, device)
    return _Region(kernels.device_bytes(ptr, nbytes, device),
                   lambda: kernels.sym_close(ptr))


def _shm_close(shm) -> None:
    try:
        shm.close()
    except BufferError:  # a view is still alive: the mapping goes with it
        _log.debug("shared memory %s still viewed at close", shm.name)


def _shm_attach(name: str, create: bool, nbytes: int = 0):
    from multiprocessing import resource_tracker, shared_memory

    shm = shared_memory.SharedMemory(name=name, create=create, size=nbytes)
    if not create:
        # the creator unlinks the segment once every peer has mapped it
        # (ProcessSpan._grow), and its own tracker cleans up after it if
        # it dies first: an attacher's tracker must not unlink it too
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    return shm


def _shm_region(nbytes: int, name: str) -> _Region:
    shm = _shm_attach(name, True, nbytes)
    return _Region(torch.frombuffer(shm.buf, dtype=torch.uint8, count=nbytes),
                   lambda: _shm_close(shm), name.encode(), shm.unlink)


def _shm_open(handle: bytes, nbytes: int) -> _Region:
    shm = _shm_attach(handle.decode(), False)
    return _Region(torch.frombuffer(shm.buf, dtype=torch.uint8,
                                    count=nbytes),
                   lambda: _shm_close(shm))


class ProcessSpan:
    """One communicator epoch over the processes of ``workers``: this
    process holds the stacked rows of ranks ``[first, first + rows)`` of
    ``n``, and exchanges rows with the others through the epoch's
    symmetric buffers (allocated at the first exchange, grown when a
    larger one comes, closed by :meth:`close`).

    Every process of the span must make the same calls in the same order
    with the same shapes, as every rank of a compiled collective does."""

    def __init__(self, world: ProcessWorld, workers: PeerList, version: int):
        self.world = world
        self.workers = workers
        self.version = int(version)
        self.procs = len(workers)
        self.index = workers.rank(world.self_id)
        if self.index is None:
            raise RuntimeError(f"{world.self_id} is not an active worker of "
                               f"{workers}")
        self.rows = world.rows
        self.n = self.rows * self.procs
        self.first = self.index * self.rows
        #: each process's world slot (its process id), in rank order
        self.slots = [world.slots.rank(w) for w in workers]
        self.device = world.device
        self._cap = 0          # bytes of one slot
        self._gen = 0          # buffer generations so far
        self._regions: List[_Region] = []
        self._slot = 0
        self._seq = 0
        self.closed = False
        #: seconds spent at barriers and opening peers' buffers, and the
        #: exchanges made (read by the chip check and the timeline)
        self.stats = {"barrier_s": 0.0, "open_s": 0.0, "exchanges": 0,
                      "opens": 0}

    def __repr__(self):
        return (f"ProcessSpan(v{self.version}, process {self.index} of "
                f"{self.procs}, ranks [{self.first}, "
                f"{self.first + self.rows}) of {self.n} on {self.device})")

    # -- synchronisation -------------------------------------------------
    def drain(self) -> None:
        """Wait for this process's work on the card (a no-op on the
        host)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def barrier(self) -> None:
        """Meet every process of the span on the host channel."""
        if self.closed:
            raise RuntimeError(f"{self!r} is closed (a retired epoch)")
        t0 = time.perf_counter()
        self.world.channel.barrier(
            self.workers, name=f"kf.span.v{self.version}.{self._seq}")
        self._seq += 1
        self.stats["barrier_s"] += time.perf_counter() - t0

    # -- symmetric buffers -------------------------------------------------
    def _release(self) -> None:
        """Let the buffers go in the order CUDA IPC asks for: this
        process unmaps the peers' buffers (its reads of them have been
        drained), meets the others, and only then frees its own, which
        every peer has unmapped by that barrier.  A process that never
        reaches the barrier (one that died) leaves this process's own
        buffer allocated rather than freed under a mapping."""
        if not self._regions:
            return
        own = self._regions[self.index]
        for q, r in enumerate(self._regions):
            if q != self.index:
                r.close()
        self._regions = []
        self._cap = 0
        try:
            self.barrier()
        except (TimeoutError, ConnectionError, OSError) as e:
            _log.warning("%r: a peer missed the release barrier (%s); this "
                         "process's symmetric buffer stays allocated", self,
                         e)
            return
        own.close()

    def _grow(self, need: int) -> None:
        """Give every process a buffer of two slots of at least ``need``
        bytes each and map every peer's.  All processes grow at the same
        call, since they make the same calls."""
        cap = max(need, 2 * self._cap, _GRANULE)
        cap = -(-cap // _GRANULE) * _GRANULE
        if self._regions:
            # this process's reads of the old buffers end before it unmaps
            self.drain()
            self._release()
        self._gen += 1
        nbytes = 2 * cap
        if self.device.type == "cuda":
            own = _cuda_region(nbytes, self.device)
        else:
            own = _shm_region(nbytes, f"kf{self.world.token}v{self.version}"
                                      f"g{self._gen}p{self.index}")
        try:
            handles = self.world.channel.allgather_bytes(
                own.handle, self.workers,
                name=f"kf.sym.v{self.version}.g{self._gen}")
            t0 = time.perf_counter()
            regions = []
            for q, h in enumerate(handles):
                if q == self.index:
                    regions.append(own)
                elif self.device.type == "cuda":
                    regions.append(_cuda_open(h, nbytes, self.device))
                else:
                    regions.append(_shm_open(h, nbytes))
            self.stats["open_s"] += time.perf_counter() - t0
            self.stats["opens"] += len(handles) - 1
        except BaseException:
            own.close()
            raise
        self._regions = regions
        self._cap = cap
        if own.unlink is not None:
            # every peer has mapped this segment: its name can go now, so
            # a killed process leaves nothing behind
            self.barrier()
            own.unlink()
        _log.info("%r: symmetric buffers of %d bytes (generation %d)",
                  self, nbytes, self._gen)

    @staticmethod
    def _layout(leaves) -> tuple:
        offs, off = [], 0
        for leaf in leaves:
            offs.append(off)
            off += -(-leaf.numel() * leaf.element_size() // _ALIGN) * _ALIGN
        return offs, off

    def publish(self, leaves: Sequence[torch.Tensor], write: bool = True
                ) -> List[List[torch.Tensor]]:
        """Copy this process's leaves (its rows, ``[rows, ...]`` each, or
        one value) into its next buffer slot, drain the stream and meet the others; returns,
        for each leaf, every process's rows in that slot (``[rows, ...]``
        views, this process's own and the peers' mapped ones), in process
        order.  The caller reads them and then calls :meth:`drain` before
        it returns.  ``write=False`` publishes nothing of this process's
        own (a broadcast's non-roots)."""
        if self.closed:
            raise RuntimeError(f"{self!r} is closed (a retired epoch)")
        offs, total = self._layout(leaves)
        if total > self._cap:
            self._grow(total)
        base = self._slot * self._cap
        self._slot ^= 1
        own = self._regions[self.index].tensor
        if write:
            for leaf, off in zip(leaves, offs):
                nb = leaf.numel() * leaf.element_size()
                own[base + off:base + off + nb].view(leaf.dtype).view(
                    leaf.shape).copy_(leaf)
        self.drain()
        self.barrier()
        self.stats["exchanges"] += 1
        out = []
        for leaf, off in zip(leaves, offs):
            nb = leaf.numel() * leaf.element_size()
            out.append([r.tensor[base + off:base + off + nb].view(
                leaf.dtype).view(leaf.shape) for r in self._regions])
        return out

    def gather(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's rows of each leaf: ``[rows, ...]`` here to
        ``[n, ...]`` in rank order, copied out of the symmetric buffers."""
        for leaf in leaves:
            if leaf.dim() == 0 or leaf.shape[0] != self.rows:
                raise ValueError(f"a process-spanning exchange takes this "
                                 f"process's {self.rows} row(s), got shape "
                                 f"{tuple(leaf.shape)}")
        views = self.publish(leaves)
        out = [torch.cat(v, 0) for v in views]
        self.drain()
        return out

    def broadcast(self, value: torch.Tensor, root: int) -> torch.Tensor:
        """Process ``root``'s ``value`` as every process receives it (the
        others pass a tensor of the same shape and dtype, which is not
        read)."""
        (views,) = self.publish([value[None]], write=self.index == root)
        out = views[root][0].clone()
        self.drain()
        return out

    def close(self) -> None:
        """Unmap the peers' buffers, meet the others and free this
        process's (a retired epoch): every process of the span closes it
        at the same membership change, as it makes every other call."""
        if self.closed:
            return
        try:
            self.drain()
            self._release()
        finally:
            self.closed = True
