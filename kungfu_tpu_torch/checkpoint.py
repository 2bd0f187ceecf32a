"""Checkpoint and resume (trimmed copy of ``kungfu_tpu/checkpoint.py``).

* :class:`StepSnapshot` -- the in-memory replay point of elastic
  training;
* disk checkpoints of a tree of tensors: :func:`save_checkpoint` (an
  atomic numpy ``.npz``, ``ckpt_<step>.npz``, the reference's npz
  backend file for file), :func:`latest_step`,
  :func:`restore_checkpoint`, :func:`prune_checkpoints`, and
  :func:`save_checkpoint_async` with :func:`wait_pending_checkpoints`,
  which write on one ordered background thread after a synchronous host
  snapshot.

The reference's orbax backend is not ported: ``KF_TPU_CKPT_BACKEND=orbax``
and an ``.orbax`` checkpoint raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

_log = get_logger("checkpoint")

#: torch dtype -> the numpy ``dtype.name`` the reference's wire form
#: writes (``bfloat16`` is ml_dtypes' name for it)
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name (the reference's
    ``_np_dtype``, :455; ``bfloat16`` needs no ml_dtypes here)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported leaf dtype {name!r} in a replay "
                         "point") from None


def host_copy(t) -> torch.Tensor:
    """A host copy of ``t`` that shares no memory with it: pinned when
    ``t`` is on the card, so the device-to-host copy runs at the link's
    rate (the caching host allocator reuses freed pinned blocks)."""
    t = torch.as_tensor(t)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return out.copy_(t)


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


class StepSnapshot:
    """The replay point for in-flight recovery: the state as of the last
    committed step boundary, held in host memory.

    The train loop calls :meth:`commit` after each applied step (a host
    copy of the leaves, no file IO); after a membership change the
    workers restore from :meth:`last` and run the next step on the new
    world.  Leaves are copied on commit and again on restore, so neither
    a later step overwriting device buffers nor a caller mutating a
    restored tree can change the held boundary.

    :meth:`serialize` and :meth:`adopt` carry a boundary between workers
    in the reference's wire form (``checkpoint.py:391-412``): a JSON
    header (step, meta, each leaf's numpy dtype name and shape) after a
    ``u32`` length, then the raw leaf bytes.  A bf16 leaf is named
    ``bfloat16``, so a blob written by either package adopts in the
    other.  A 0-d leaf is written with shape ``[1]``, as the reference
    writes it, and read back 0-d where the committed structure holds a
    0-d leaf (the reference's ``adopt`` returns it 1-d).  State sharded
    over ranks (ZeRO) rides
    :class:`~kungfu_tpu_torch.elastic.reshard.ZeroBoundary` instead.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._step: Optional[int] = None
        self._tree = None
        self._meta: Optional[dict] = None

    def commit(self, step: int, tree, meta: Optional[dict] = None) -> None:
        """Record ``tree`` as the committed state after step ``step``."""
        host_tree = tree_map(host_copy, tree)
        with self._lock:
            self._step = step
            self._tree = host_tree
            self._meta = dict(meta) if meta else {}

    def last(self) -> Optional[Tuple[int, Any, dict]]:
        """``(step, tree, meta)`` of the newest committed boundary (the
        tree a copy on the host), or ``None`` before any commit."""
        with self._lock:
            if self._step is None:
                return None
            return (self._step, tree_map(torch.clone, self._tree),
                    dict(self._meta))

    def step(self) -> Optional[int]:
        with self._lock:
            return self._step

    def clear(self) -> None:
        with self._lock:
            self._step = None
            self._tree = None
            self._meta = None

    # -- wire form --------------------------------------------------------
    def serialize(self) -> bytes:
        """The committed boundary in the wire form (``b""`` when empty)."""
        snap = self.last()
        if snap is None:
            return b""
        step, tree, meta = snap
        leaves, _ = tree_flatten(tree)
        for i, t in enumerate(leaves):
            if t.dtype not in _DTYPE_NAMES:
                raise ValueError(f"leaf {i} has dtype {t.dtype}, which the "
                                 "wire form cannot name")
        head = json.dumps({
            "step": step,
            "meta": meta,
            # at least 1-d, as the reference's np.ascontiguousarray
            # writes a 0-d leaf
            "leaves": [{"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape) or [1]} for t in leaves],
        }).encode()
        return b"".join([struct.pack("<I", len(head)), head]
                        + [_raw_bytes(t) for t in leaves])

    def adopt(self, blob: bytes) -> Optional[Tuple[int, Any, dict]]:
        """Replace this snapshot's boundary with a serialized one and
        return it as ``(step, tree, meta)``, rebuilt in THIS snapshot's
        committed structure (a never-committed snapshot raises
        ``ValueError``)."""
        if not blob:
            return None
        (hlen,) = struct.unpack_from("<I", blob)
        off = 4
        head = json.loads(bytes(blob[off:off + hlen]).decode())
        off += hlen
        with self._lock:
            if self._tree is None:
                raise ValueError(
                    "cannot adopt a replay point without a local committed "
                    "structure to rebuild it in")
            held, treedef = tree_flatten(self._tree)
        if len(held) != len(head["leaves"]):
            raise ValueError(
                f"replay point has {len(head['leaves'])} leaves, local "
                f"structure has {len(held)} — peers run different models?")
        leaves = []
        for spec, mine in zip(head["leaves"], held):
            shape = spec["shape"]
            if shape == [1] and mine.dim() == 0:
                shape = []  # a 0-d leaf, written 1-d
            t = torch.empty(shape, dtype=_torch_dtype(spec["dtype"]))
            raw = t.reshape(-1).view(torch.uint8).numpy()
            n = raw.nbytes
            if off + n > len(blob):
                raise ValueError("replay point blob is truncated")
            raw[:] = np.frombuffer(blob, np.uint8, count=n, offset=off)
            leaves.append(t)
            off += n
        tree = tree_unflatten(treedef, leaves)
        self.commit(int(head["step"]), tree, head.get("meta") or {})
        return self.last()


# -- disk checkpoints -------------------------------------------------------
CKPT_BACKEND = "KF_TPU_CKPT_BACKEND"


def _backend() -> str:
    """``KF_TPU_CKPT_BACKEND``: ``auto`` and ``npz`` write npz; the
    reference's ``orbax`` is not ported."""
    mode = os.environ.get(CKPT_BACKEND, "auto").lower()
    if mode == "orbax":
        raise NotImplementedError(
            f"{CKPT_BACKEND}=orbax: the port writes npz checkpoints only")
    return "npz"


def _step_entries(ckpt_dir: str):
    """``[(step, filename)]`` of every checkpoint, in either of the
    reference's formats."""
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("ckpt_"):
            continue
        stem = name[5:]
        for suffix in (".npz", ".orbax"):
            if stem.endswith(suffix):
                try:
                    out.append((int(stem[:-len(suffix)]), name))
                except ValueError:
                    pass
    return out


def _to_npz_safe(t) -> np.ndarray:
    """A host numpy copy of a leaf; bf16 widened to f32 (lossless; the
    restore casts to the like tree's dtype)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return np.array(t.numpy())


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    meta: Optional[dict] = None) -> str:
    """Atomically write ``tree`` (and ``meta``) as checkpoint ``step``;
    returns its path."""
    _backend()
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_npz_safe(l) for i, l in enumerate(leaves)}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta or {}), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _log.info("saved checkpoint %s", path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s, _ in _step_entries(ckpt_dir)]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like_tree, step: Optional[int] = None):
    """The newest (or the given step's) checkpoint in the structure,
    dtypes and devices of ``like_tree``: ``(tree, step, meta)``, or None
    when there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    orbax_path = os.path.join(os.path.abspath(ckpt_dir),
                              f"ckpt_{step:08d}.orbax")
    if os.path.isdir(orbax_path):
        raise NotImplementedError(
            f"checkpoint {orbax_path} was written by the reference's orbax "
            "backend; the port reads npz checkpoints only")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves, treedef = tree_flatten(like_tree)
        restored = []
        for i, like in enumerate(leaves):
            like = torch.as_tensor(like)
            arr = torch.from_numpy(np.array(data[f"leaf_{i}"]))
            restored.append(arr.to(device=like.device, dtype=like.dtype))
    _log.info("restored checkpoint %s (meta=%s)", path, meta)
    return tree_unflatten(treedef, restored), step, meta


# one background writer: checkpoints land in order
_writer_lock = threading.Lock()
_writer: Optional[ThreadPoolExecutor] = None
_pending: list = []


def _get_writer() -> ThreadPoolExecutor:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="kf-ckpt")
        return _writer


def save_checkpoint_async(ckpt_dir: str, step: int, tree,
                          meta: Optional[dict] = None) -> "Future[str]":
    """:func:`save_checkpoint` off the step path: the host snapshot is
    taken here (a copy, so a later step cannot change it), the write
    runs on one ordered background thread.  Returns a future of the
    path; :func:`wait_pending_checkpoints` before anything reports
    progress that relies on it."""
    host_tree = tree_map(lambda t: torch.as_tensor(t).detach().cpu().clone(),
                         tree)
    fut = _get_writer().submit(save_checkpoint, ckpt_dir, step, host_tree,
                               meta)
    with _writer_lock:
        # a failed write stays tracked, so the wait surfaces its error
        _pending[:] = [f for f in _pending
                       if not f.done() or f.exception() is not None]
        _pending.append(fut)
    return fut


def wait_pending_checkpoints(timeout: Optional[float] = None) -> None:
    """Block until every async checkpoint issued so far is durable;
    raises the first write failure after waiting for all of them.
    ``timeout`` is one deadline for all; writes still running when it
    passes stay tracked."""
    with _writer_lock:
        pending = list(_pending)
        _pending.clear()
    deadline = None if timeout is None else time.monotonic() + timeout
    first_err: Optional[BaseException] = None
    for i, f in enumerate(pending):
        left = (None if deadline is None
                else max(0.0, deadline - time.monotonic()))
        try:
            f.result(left)
        except _FutureTimeout:
            with _writer_lock:
                _pending.extend(pending[i:])
            raise
        except BaseException as e:  # noqa: BLE001 - raised after all wait
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    entries = sorted(_step_entries(ckpt_dir))
    for _, name in entries[:-keep]:
        full = os.path.join(ckpt_dir, name)
        if os.path.isdir(full):
            shutil.rmtree(full)
            if os.path.exists(full + ".meta.json"):
                os.unlink(full + ".meta.json")
        else:
            os.unlink(full)
