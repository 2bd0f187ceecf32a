"""Torch collectives over the host collective engine (port of
``kungfu_tpu/torch/ops/collective.py``; reference
``kungfu/torch/ops/collective.py`` and the launch -> handle ->
``wait_all_handles`` flow of ``torch/ops/cuda/collective.cpp:20-90``).

Every function takes an optional ``engine``; by default it is the
process peer's (:mod:`kungfu_tpu_torch.python`), and with no engine (a
single process) every collective is the identity.  A tensor is copied to
the host (a card tensor through a device-to-host copy), reduced there by
the engine and copied back to its own device; nothing goes through NCCL.

Collectives meet by name across ranks, so async submissions are named at
call time (``torch.<kind>.<seq>``): every rank must issue the same
sequence, as in the reference.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Iterable, List, Tuple, Union

import torch

from kungfu_tpu_torch.torch.ops import clib

_seq_lock = threading.Lock()
_seq = [0]


def _next_name(kind: str) -> str:
    with _seq_lock:
        n = _seq[0]
        _seq[0] += 1
    return f"torch.{kind}.{n}"


def _default_engine():
    from kungfu_tpu_torch import python

    try:
        peer = python._peer()
    except RuntimeError:
        return None
    return peer.engine()


def _check_op_dtype(t: torch.Tensor, op: str) -> None:
    if op == "mean" and not t.dtype.is_floating_point:
        raise TypeError(
            f"op='mean' on {t.dtype} would silently truncate; use op='sum'"
        )


def all_reduce(t: torch.Tensor, op: str = "mean", engine=None,
               name: str = "") -> torch.Tensor:
    """Synchronous allreduce; a new tensor of ``t``'s dtype and device."""
    engine = engine if engine is not None else _default_engine()
    _check_op_dtype(t, op)
    if engine is None:
        return t.clone()
    a = clib.to_numpy(t)
    out = engine.all_reduce(a, op=op, name=name or _next_name("ar"))
    return clib.from_numpy(out, t).reshape(t.shape)


Handle = Tuple[Future, torch.Tensor]


def all_reduce_async(t: torch.Tensor, op: str = "mean", engine=None,
                     name: str = "") -> Handle:
    """Launch an allreduce; the handle's result is copied into ``t`` by
    :func:`wait_all_handles` (in place, as the reference's gradient
    sync).  The host copy is taken now, so ``t`` may change meanwhile."""
    engine = engine if engine is not None else _default_engine()
    nm = name or _next_name("ar")
    _check_op_dtype(t, op)
    if engine is None:
        f: Future = Future()
        f.set_result(None)
        return (f, t)
    a = clib.to_numpy(t)
    # the engine's own async pool: never shared across in-process
    # engines, whose waiters could otherwise starve the rank they wait for
    fut = engine.async_pool().submit(engine.all_reduce, a, op, nm)
    return (fut, t)


def wait_all_handles(handles: Iterable[Handle]) -> None:
    """Await async collectives, copying each result into its tensor
    (reference ``wait_all_handles``, ``ops/cuda/helper.cpp``)."""
    for fut, t in handles:
        out = fut.result()
        if out is not None:
            with torch.no_grad():
                t.copy_(clib.from_numpy(out, t).reshape(t.shape))


def broadcast(t: torch.Tensor, root: int = 0, engine=None,
              name: str = "") -> torch.Tensor:
    engine = engine if engine is not None else _default_engine()
    if engine is None:
        return t.clone()
    a = clib.to_numpy(t)
    out = engine.broadcast(a, root=root, name=name or _next_name("bc"))
    return clib.from_numpy(out, t).reshape(t.shape)


def all_gather(t: torch.Tensor, engine=None, name: str = "") -> torch.Tensor:
    """Every rank's tensor stacked on a new leading axis (reference
    ``torch/ops/collective.py:48-52``): shape ``[np, *t.shape]``."""
    engine = engine if engine is not None else _default_engine()
    if engine is None:
        return t.clone().unsqueeze(0)
    a = clib.to_numpy(t)
    out = engine.all_gather(a, name=name or _next_name("ag"))
    return clib.from_numpy(out, t).reshape((-1,) + tuple(t.shape))


def broadcast_parameters(params: Union[dict, Iterable[torch.Tensor]],
                         root: int = 0, engine=None) -> None:
    """Broadcast rank ``root``'s parameters into every rank's tensors in
    place (reference ``torch/ops/collective.py:40-45``).  ``params`` is a
    ``state_dict``-style mapping or an iterable of tensors, in the same
    order on every rank."""
    engine = engine if engine is not None else _default_engine()
    if engine is None:
        return
    items: List[Tuple[str, torch.Tensor]]
    if isinstance(params, dict):
        items = [(str(k), v) for k, v in params.items()]
    else:
        items = [(str(i), p) for i, p in enumerate(params)]
    # one name per key: ranks meet by name, and the per-(src, name) FIFO
    # queues make reuse across rounds safe
    for key, t in items:
        if not torch.is_tensor(t):
            continue
        a = clib.to_numpy(t)
        out = engine.broadcast(a, root=root, name=f"torch.bp.{key}")
        with torch.no_grad():
            t.copy_(clib.from_numpy(out, t).reshape(t.shape))
