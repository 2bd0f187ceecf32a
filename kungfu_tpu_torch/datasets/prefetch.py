"""Device prefetch: overlap host->device transfer with compute.

Port of ``kungfu_tpu/datasets/prefetch.py``.  The training loops consume
numpy batches (:class:`~kungfu_tpu_torch.datasets.adaptor.ElasticDataset`,
the loader helpers); every step would otherwise pay the host->device copy
on its critical path.  ``prefetch_to_device`` wraps any batch iterator
and keeps ``size`` batches already resident on the device: a background
thread stages batch N+k while the step computes on batch N.

On the card the worker copies each leaf into pinned host memory and from
there to the device with ``non_blocking=True`` on a side stream of its
own, then records an event on that stream.  Before the consumer gets the
batch, its current stream waits on the event (so the step never reads a
half-copied batch), and every staged tensor is marked used on the
consumer's stream (``record_stream``), so the caching allocator does not
hand the block to the next copy while the step still reads it.  On the
CPU the leaves are copied into fresh tensors.

Iterator exhaustion and worker exceptions propagate to the consumer.  On
resize, drop the prefetcher with the rest of the mesh epoch and wrap the
(re-sharded) iterator again.  The source iterator runs up to ``size``
batches ahead of what the loop used: a loader that tracks consumed
samples has over-counted by the staged batches at a resize; rewind with
``skip(actually_consumed)`` before re-wrapping, or prefetch only within
resize-free spans.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from kungfu_tpu_torch.utils.device import resolve_device
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

_SENTINEL = object()
_ARRAYS = (np.ndarray, np.generic, torch.Tensor, bool, int, float)


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor of the leaf ``a`` in a buffer of its own."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(a))


def _stage(a, dev: torch.device):
    """One leaf on ``dev``; non-array leaves pass through."""
    if not isinstance(a, _ARRAYS):
        return a
    if dev.type == "cpu":
        return _host_tensor(a)
    if isinstance(a, torch.Tensor) and a.device == dev:
        return a
    src = a.detach() if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    return src.pin_memory().to(dev, non_blocking=True)


def prefetch_to_device(it: Iterable, size: int = 2, device=None) -> Iterator:
    """Yield the items of ``it`` with up to ``size`` of them staged on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``).  Each item is a tree (tuple, list, dict) whose
    array leaves become tensors on the device.

    A plain function, not a generator: validation and the transfer thread
    start at the call, so staging overlaps any setup the caller does
    before its loop.  Closing or abandoning the returned iterator stops
    the worker and releases the staged device buffers."""
    if size < 1:
        raise ValueError("size must be >= 1")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def offer(item) -> bool:
        """put() that a consumer shutdown can always unblock."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            stream = torch.cuda.Stream(device=dev) if cuda else None
            for item in it:
                if cuda:
                    with torch.cuda.stream(stream):
                        staged = tree_map(lambda a: _stage(a, dev), item)
                        done = torch.cuda.Event()
                        done.record(stream)
                else:
                    staged, done = tree_map(lambda a: _stage(a, dev), item), None
                if not offer((staged, done)):
                    return
            offer(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            offer(e)

    t = threading.Thread(target=worker, daemon=True, name="kf-prefetch")
    t.start()

    def gen():
        from kungfu_tpu_torch.monitor import timeline

        try:
            while True:
                # the consumer-side wait: the worker always ends the stream
                # (sentinel or exception), so this block ends when the
                # producer does; the `input` span times it (the input
                # stall a step pays: ~0 for a warm queue)
                with timeline.span("input", "prefetch.next"):
                    got = q.get()  # kflint: allow(blocking-io)
                if got is _SENTINEL:
                    return
                if isinstance(got, BaseException):
                    raise got
                staged, done = got
                if done is not None:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(done)
                    for leaf in tree_leaves(staged):
                        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                            leaf.record_stream(consumer)
                yield staged
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(5)

    return gen()
