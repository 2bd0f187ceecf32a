"""The in-memory replay point of elastic training (trimmed copy of
``kungfu_tpu/checkpoint.py``: :class:`StepSnapshot`).

The disk checkpoints of the reference (``save``/``restore``, orbax, the
pruning and async writers) are not ported.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

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
