"""PairAveraging: AD-PSGD asynchronous gossip over the host plane.

Port of ``kungfu_tpu/optimizers/async_sgd.py`` (reference
``async_sgd.py:71-142`` and ``peer_to_peer.cpp``).  Each step a worker
(1) pulls a peer's model from that peer's versioned store, (2) averages
it 0.5/0.5 into its own weights, (3) applies its local gradients with
``inner`` and (4) publishes the new model.  No collective and no global
synchronisation: the pull is a p2p request over the host channel.

The model travels as one fused buffer (:func:`~kungfu_tpu_torch.ops.
fuse.fuse`, the reference's leaf order) in ``fuse_dtype``, as its raw
bytes: a port peer publishes the reference's bytes for the same params,
in f32 and in bf16, so a mixed cluster gossips.

Where the port differs, and why:

* the reference publishes a zero-copy view of its jit output and relies
  on jax arrays being immutable.  The port publishes a host tensor made
  for that step (on the card, a pinned tensor the fused output is copied
  into, the copy finished before the save), which no later step writes;
  the store's window and any peer still reading it keep it alive, and it
  is freed only after both let go;
* the pulled bytes land on the host.  On the card the average reads
  them through an asynchronous copy, so a landing buffer is written
  again only after that copy has finished (:meth:`_fence_h2d`);
* the step is a plain function over the port's ``fuse`` and the
  ``_transform`` optimizers, in place of a jitted program.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.optimizers._transform import apply_updates
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.tree import tree_leaves

_log = get_logger("pair-avg")


def _host_bytes(nbytes: int, pin: bool) -> np.ndarray:
    """A uint8 numpy buffer over a host tensor (pinned when ``pin``); the
    array keeps the tensor alive."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin).numpy()


class PairAveragingOptimizer:
    """Host-driven gossip optimizer.

    Usage::

        opt = PairAveragingOptimizer(sgd(0.1), peer)
        state = opt.init(params)            # publishes + barrier
        params, state = opt.step(params, grads, state)
    """

    def __init__(self, inner, peer=None, name: str = "model",
                 selector: str = "random", fuse_dtype=torch.float32,
                 seed: int = 0):
        if peer is None:
            from kungfu_tpu_torch.python import init as _init

            peer = _init()
        self.inner = inner
        self.peer = peer
        self.name = name
        self.selector = selector
        self.fuse_dtype = fuse_dtype
        self._rng = random.Random(seed + peer.rank())
        self._rr_next = 0
        self._step_count = 0
        self._recv_buf = None  # reused landing buffer of the blocking pull
        self._h2d_done = None  # event after the last pulled model's H2D
        #: cumulative wall seconds / bytes spent inside blob pulls
        self.pull_seconds = 0.0
        self.pull_bytes = 0
        #: steps that averaged with a pulled model / fell back to local
        self.averaged_steps = 0
        self.local_steps = 0

    # -- the step's arithmetic ------------------------------------------
    def _step_fn(self, params, grads, state, other_buf):
        """Average with ``other_buf`` (when a pull landed), apply the
        local gradients, and return the new params, state and their
        fused buffer."""
        if other_buf is not None:
            mine, spec = fuse(params, dtype=self.fuse_dtype)
            params = defuse(0.5 * mine + 0.5 * other_buf, spec)
        updates, state = self.inner.update(grads, state, params)
        params = apply_updates(params, updates)
        out_buf, _ = fuse(params, dtype=self.fuse_dtype)
        return params, state, out_buf

    def _count(self, other) -> None:
        if other is not None:
            self.averaged_steps += 1
        else:
            self.local_steps += 1

    # -- store IO --------------------------------------------------------
    def _host_view(self, fused: torch.Tensor) -> np.ndarray:
        """The fused buffer's bytes in a host tensor no later step
        writes: a CPU result of ``fuse`` is fresh already; a card's is
        copied into a new pinned tensor, the copy finished on return."""
        if fused.device.type != "cpu":
            host = torch.empty(fused.shape, dtype=fused.dtype,
                               pin_memory=True)
            host.copy_(fused)  # pinned destination: returns when done
            fused = host
        return fused.view(torch.uint8).numpy()

    def _serialize(self, params) -> np.ndarray:
        buf, _ = fuse(params, dtype=self.fuse_dtype)
        return self._host_view(buf)

    def _deserialize_buf(self, blob, device: torch.device) -> torch.Tensor:
        """The pulled bytes as a ``fuse_dtype`` tensor on ``device``.  On
        the host it is a view of the landing buffer (the step reads it
        before the buffer can be written again); on the card an
        asynchronous copy whose end :meth:`_fence_h2d` waits for."""
        raw = (np.frombuffer(bytearray(blob), np.uint8)
               if isinstance(blob, (bytes, bytearray, memoryview))
               else np.asarray(blob).view(np.uint8))
        t = torch.from_numpy(raw).view(self.fuse_dtype)
        if device.type == "cpu":
            return t
        out = t.to(device, non_blocking=True)
        self._h2d_done = torch.cuda.Event()
        self._h2d_done.record()
        return out

    def _fence_h2d(self) -> None:
        """Wait until the last pulled model's copy to the card is done,
        before its landing buffer is handed back to be written."""
        if self._h2d_done is not None:
            self._h2d_done.synchronize()
            self._h2d_done = None

    def _model_nbytes(self, params) -> int:
        numel = sum(int(t.numel()) for t in tree_leaves(params))
        return numel * torch.empty((), dtype=self.fuse_dtype).element_size()

    def _publish(self, params) -> None:
        self.peer.save(self.name, self._serialize(params),
                       version=str(self._step_count), copy=False)

    def _publish_buf(self, fused: torch.Tensor) -> None:
        self.peer.save(self.name, self._host_view(fused),
                       version=str(self._step_count), copy=False)

    def _select_peer(self) -> Optional[int]:
        n, me = self.peer.size(), self.peer.rank()
        others = [r for r in range(n) if r != me]
        if not others:
            return None
        if self.selector == "roundrobin":
            target = others[self._rr_next % len(others)]
            self._rr_next += 1
            return target
        return self._rng.choice(others)

    @staticmethod
    def _device(params) -> torch.device:
        return tree_leaves(params)[0].device

    # -- optimizer surface -----------------------------------------------
    def init(self, params):
        """Publish the initial model and barrier, so every peer has
        something to serve before the first pull (reference
        ``async_sgd.py:110-120``)."""
        self._publish(params)
        self.peer.barrier()
        return self.inner.init(params)

    def _pull(self, target):
        """Pull the target's fused model into the reused landing buffer;
        the filled buffer, or None on a miss."""
        self._fence_h2d()
        if self._recv_buf is None:
            self._recv_buf = _host_bytes(
                self._model_nbytes(self._last_params),
                self._device(self._last_params).type == "cuda")
        t0 = time.perf_counter()
        try:
            # misses are tolerated: bound the connect ladder so a dead
            # target costs seconds, not the whole retry budget
            got = self.peer.request_into(target, self.name, self._recv_buf,
                                         send_retries=25)
        except (TimeoutError, ConnectionError, OSError) as e:
            _log.debug("pull from %d failed: %s", target, e)
            return None
        dt = time.perf_counter() - t0
        if got is None:
            return None
        self.pull_seconds += dt
        self.pull_bytes += memoryview(got).nbytes
        return got

    def step(self, params, grads, state):
        """One gossip step; returns ``(new_params, new_state)``."""
        self._last_params = params
        target = self._select_peer()
        other = None
        if target is not None:
            blob = self._pull(target)
            if blob is not None:
                other = self._deserialize_buf(blob, self._device(params))
            else:
                _log.debug("peer %d had no %r yet", target, self.name)
        params, state, fused = self._step_fn(params, grads, state, other)
        self._count(other)
        self._step_count += 1
        self._publish_buf(fused)
        return params, state


class _ModelPuller(threading.Thread):
    """Free-running background model puller with triple-buffered
    landings (reference ``tensorflow/ops/cpu/peer_to_peer.cpp:156-258``).
    Three slots rotate ownership, so a landing is a swap of indices,
    never a model-sized copy:

    * ``writing`` — the slot the in-flight receive fills,
    * ``ready`` — the freshest landed model, waiting to be taken,
    * ``read`` — checked out by the consumer's last :meth:`take`.

    With one writer and one consumer at most one slot is in each state,
    so three suffice.  The read slot is recycled only by the next take,
    and the consumer fences its use of the slot (the copy to the card)
    before that take, so the puller never overwrites bytes still being
    read.  ``pin_memory`` pins the slots, for copies to the card."""

    def __init__(self, peer, name: str, nbytes: int,
                 select: Callable[[], Optional[int]],
                 pull_timeout: float = 10.0, min_interval: float = 0.0,
                 paced: bool = False, pin_memory: bool = False):
        super().__init__(name=f"kf-gossip-pull-{name}", daemon=True)
        self.peer = peer
        self.blob_name = name
        self._select = select
        self._slots = [_host_bytes(nbytes, pin_memory) for _ in range(3)]
        self._free = [0, 1, 2]
        self._ready: Optional[int] = None
        self._read: Optional[int] = None
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self.landed = threading.Event()  #: set on every landing
        self.pull_timeout = pull_timeout
        self.min_interval = min_interval
        #: paced mode: pull only when kicked, at most one in flight (the
        #: reference's one prefetch per step, ``AsyncRequestModel``)
        self.paced = paced
        self._kick = threading.Event()
        #: landing sequence number (0 = nothing landed yet)
        self.seq = 0
        self._take_seq = 0
        self.pull_seconds = 0.0
        self.pull_bytes = 0
        self.misses = 0

    def kick(self) -> None:
        """Request one pull (paced mode); no-op when one is in flight."""
        self._kick.set()

    # -- puller side ------------------------------------------------------
    def run(self) -> None:  # noqa: D102
        while not self._stop_evt.is_set():
            if self.paced:
                if not self._kick.wait(0.1):
                    continue
                self._kick.clear()
            try:
                target = self._select()
            except Exception as e:  # noqa: BLE001 - elastic churn can drop
                # this peer from the worker list for a moment
                _log.debug("peer selection failed: %s", e)
                target = None
            if target is None:
                self._stop_evt.wait(0.05)
                continue
            with self._lock:
                w = self._free.pop()
            t0 = time.perf_counter()
            try:
                # bounded connect ladder: a dead target must fail within
                # about pull_timeout, or close() could not join this thread
                got = self.peer.request_into(
                    target, self.blob_name, self._slots[w],
                    timeout=self.pull_timeout,
                    send_retries=max(1, int(self.pull_timeout / 0.2)),
                )
            except Exception as e:  # noqa: BLE001 - peer churn is normal
                _log.debug("async pull from %d failed: %s", target, e)
                got = None
            dt = time.perf_counter() - t0
            landed = got is not None and memoryview(got).nbytes == \
                self._slots[w].nbytes
            if landed and got is not self._slots[w]:
                # a size-matched blob that took the queued path: one copy
                self._slots[w][:] = np.frombuffer(got, self._slots[w].dtype)
            with self._lock:
                if landed:
                    if self._ready is not None:
                        self._free.append(self._ready)
                    self._ready = w
                    self.seq += 1
                    self.pull_seconds += dt
                    self.pull_bytes += self._slots[w].nbytes
                else:
                    self._free.append(w)
                    self.misses += 1
            if landed:
                self.landed.set()
            if self.min_interval:
                self._stop_evt.wait(self.min_interval)

    # -- consumer side ----------------------------------------------------
    def take(self):
        """``(buf, seq)`` of the freshest landed model, or None when
        nothing has landed yet.  Reuses the previous landing when no new
        one arrived."""
        with self._lock:
            if self._ready is not None:
                if self._read is not None:
                    self._free.append(self._read)
                self._read, self._ready = self._ready, None
                self._take_seq = self.seq
            if self._read is None:
                return None
            return self._slots[self._read], self._take_seq

    def wait_landed(self, timeout: float) -> bool:
        """Block until a landing newer than the last take (bounded)."""
        self.landed.clear()
        with self._lock:
            if self._ready is not None:
                return True
        return self.landed.wait(timeout)

    def close(self, timeout: Optional[float] = None) -> None:
        self._stop_evt.set()
        if self.is_alive():
            # worst case in flight: the connect ladder (~pull_timeout),
            # the registered wait (pull_timeout) and the size-mismatch
            # receive (pull_timeout) in turn
            waited = (timeout if timeout is not None
                      else 3.0 * self.pull_timeout + 5.0)
            self.join(waited)
            if self.is_alive():
                _log.warning(
                    "gossip puller still in flight after %.0fs join; "
                    "channel close will drain it", waited)


class AsyncPairAveragingOptimizer(PairAveragingOptimizer):
    """AD-PSGD with the pull off the critical path (the reference's
    ``AsyncModelAveraging`` / ``AsyncRequestModel``,
    ``tensorflow/ops/cpu/peer_to_peer.cpp:156-258,411-466``): a
    background thread keeps pulling a peer's fused model, and
    :meth:`step` averages with the last landed one without waiting on
    the wire (after a blocking first pull, as the reference's).

    ``max_staleness`` bounds divergence: when one landed model has been
    consumed that many steps in a row, the step waits (bounded by
    ``pull_timeout``) for a fresh landing."""

    def __init__(self, *args, max_staleness: Optional[int] = 16,
                 pull_timeout: float = 10.0, min_interval: float = 0.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.max_staleness = max_staleness
        self._pull_timeout = pull_timeout
        self._min_interval = min_interval
        self._puller: Optional[_ModelPuller] = None
        self._consumed_seq = 0
        self._consumed_same = 0

    def _ensure_puller(self, params) -> None:
        if self._puller is not None:
            return
        self._puller = _ModelPuller(
            self.peer, self.name, self._model_nbytes(params),
            self._select_peer, pull_timeout=self._pull_timeout,
            min_interval=self._min_interval, paced=True,
            pin_memory=self._device(params).type == "cuda",
        )
        self._puller.start()
        self._puller.kick()  # the first pull races the first step

    def init(self, params):
        state = super().init(params)
        self._ensure_puller(params)
        return state

    def _await_landing(self) -> bool:
        """Kick and wait until a landing (bounded by pull_timeout); the
        kick repeats, because the paced puller parks after a miss."""
        deadline = time.monotonic() + self._pull_timeout
        while True:
            self._puller.kick()
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            if self._puller.wait_landed(min(0.5, left)):
                return True

    def step(self, params, grads, state):
        self._last_params = params
        self._ensure_puller(params)
        if self._puller.seq == 0:
            # blocking first pull, like the reference's synchronous
            # request before its prefetch loop starts
            self._await_landing()
        elif (self.max_staleness is not None
              and self._consumed_same >= self.max_staleness):
            _log.debug("staleness bound hit (%d); waiting for a landing",
                       self._consumed_same)
            self._await_landing()
        # the last taken slot goes back to the puller in take(): its copy
        # to the card must be done first
        self._fence_h2d()
        took = self._puller.take()
        # the next pull overlaps this step's compute and publish
        self._puller.kick()
        other = None
        if took is not None:
            buf, seq = took
            self._consumed_same = (self._consumed_same + 1
                                   if seq == self._consumed_seq else 0)
            self._consumed_seq = seq
            other = self._deserialize_buf(buf, self._device(params))
        params, state, fused = self._step_fn(params, grads, state, other)
        self._count(other)
        self._step_count += 1
        self._publish_buf(fused)
        self.pull_seconds = self._puller.pull_seconds
        self.pull_bytes = self._puller.pull_bytes
        return params, state

    def close(self) -> None:
        """Stop the background puller (idempotent)."""
        if self._puller is not None:
            self._fence_h2d()
            self._puller.close()
            self._puller = None
