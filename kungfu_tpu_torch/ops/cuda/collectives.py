"""Ring reduce-scatter and all-gather over co-resident ranks: the
hand-written Hopper kernels of ``csrc/ring.cu``.

They replace ``kungfu_tpu/ops/pallas/collectives.py::_rs_kernel`` and
``::_ag_kernel``.  Each wrapper takes one ring's stacked buffers on one
card (row ``r`` is rank ``r``'s), checks them, and launches one kernel
for all ``k`` ranks.  The reduce-scatter folds each output vector
directly from the ``k`` ranks' rows, in the ring's order (a hop of the
ring is a load on one card); the all-gather passes tiles from rank to
rank through per-block slots and flags in device memory.  Their plain
versions, which compute the same bits, are
:func:`kungfu_tpu_torch.ops.collectives.ring_reduce_scatter_reference`
and :func:`~kungfu_tpu_torch.ops.collectives.ring_all_gather_reference`;
:mod:`kungfu_tpu_torch.ops.collectives` routes between the two.  A CPU
tensor, a failed build or a refused launch raises: nothing falls back.

The reduce-scatter keeps nothing between launches.  The all-gather's
scratch (two tiles and two flags per resident block) is allocated once
per card at first launch and is independent of the buffers' size.  Its
flags are never reset: each launch raises the epoch past every flag
value the one before wrote.  All-gather launches on one card are
serialised on the caller's stream, as the epoch requires.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from kungfu_tpu_torch.ops.cuda import _build

#: launches of the hand-written kernels: +1 per launch, nowhere else
launch_counts = {"ring_rs": 0, "ring_ag": 0}

#: reduce-scatter element codes of ``kf_ring_launch``
_RS_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_lock = threading.Lock()
_built: Optional[_build.Built] = None


class _Scratch:
    """One card's slots, flags and epoch."""

    def __init__(self, lib, device: torch.device):
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            _raise_on(lib, lib.kf_ring_capacity(ctypes.byref(blocks)),
                      "capacity query")
        if blocks.value < 2:
            raise RuntimeError(f"{device} cannot launch the ring kernels "
                               "cooperatively")
        self.blocks = blocks.value
        self.slot = torch.empty(self.blocks * 2 * lib.kf_ring_tile() * 4,
                                dtype=torch.uint8, device=device)
        self.flag = torch.zeros(self.blocks * 2, dtype=torch.int64,
                                device=device)
        self.base = ctypes.c_uint64(0)


_scratch: Dict[torch.device, _Scratch] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def load() -> _build.Built:
    """Build (first call only) and bind ``csrc/ring.cu``."""
    global _built
    with _lock:
        if _built is None:
            built = _build.build("ring.cu")
            lib = built.lib
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.kf_ring_rs.argtypes = [i32, ptr, ptr, i32, i64, i64, ptr]
            lib.kf_ring_tile.argtypes = []
            lib.kf_ring_capacity.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.kf_ring_ag_launch.argtypes = [
                i32, ptr, ptr, i32, i64, i64, ptr, ptr, i32,
                ctypes.POINTER(ctypes.c_uint64), ptr]
            for fn in (lib.kf_ring_rs, lib.kf_ring_tile, lib.kf_ring_capacity,
                       lib.kf_ring_ag_launch):
                fn.restype = ctypes.c_int
            lib.kf_error_string.argtypes = [ctypes.c_int]
            lib.kf_error_string.restype = ctypes.c_char_p
            _built = built
        return _built


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring {what} failed: "
                           f"{lib.kf_error_string(err).decode()}")


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the ring kernels take CUDA tensors, got {what} on "
                         f"{x.device}")
    if x.dim() != 2 or x.shape[0] < 2 or x.shape[1] == 0:
        raise ValueError(f"{what} must be [k >= 2, length > 0], got "
                         f"{tuple(x.shape)}")
    if x.stride(1) != 1:
        raise ValueError(f"each rank's row of {what} must be contiguous")


def _rows(t: torch.Tensor):
    """The ``k`` row base pointers of ``t`` as a C array."""
    step = t.stride(0) * t.element_size()
    base = t.data_ptr()
    return (ctypes.c_void_p * t.shape[0])(
        *(base + r * step for r in range(t.shape[0])))


def _launch_ag(code: int, x: torch.Tensor, out: torch.Tensor, chunk: int,
               cut: int) -> None:
    lib = load().lib
    k = x.shape[0]
    with _lock:
        scratch = _scratch.get(x.device)
        if scratch is None:
            scratch = _scratch[x.device] = _Scratch(lib, x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.kf_ring_ag_launch(
                code, _rows(x), _rows(out), k, chunk, cut,
                scratch.slot.data_ptr(), scratch.flag.data_ptr(),
                scratch.blocks, ctypes.byref(scratch.base), stream)
    _raise_on(lib, err, "all-gather launch")


def reduce_scatter(parts: torch.Tensor, cut: Optional[int] = None
                   ) -> torch.Tensor:
    """The reduce-scatter kernel for one ring: ``parts`` ``[k, k*chunk]``
    (row ``r``: rank ``r``'s mesh-major flat buffer; any row stride and
    base) to ``[k, chunk]``, f32, bf16 or int32; ``cut`` ends the
    clockwise band (default ``chunk``: one direction)."""
    _check(parts, "parts")
    k = parts.shape[0]
    if parts.dtype not in _RS_CODES:
        raise ValueError(f"the reduce-scatter kernel sums float32, bfloat16 "
                         f"or int32, got {parts.dtype}")
    if parts.shape[1] % k:
        raise ValueError(f"rows of {parts.shape[1]} elements do not split "
                         f"into {k} chunks")
    chunk = parts.shape[1] // k
    cut = chunk if cut is None else int(cut)
    if not 0 < cut <= chunk:
        raise ValueError(f"band cut {cut} outside (0, {chunk}]")
    out = torch.empty((k, chunk), dtype=parts.dtype, device=parts.device)
    lib = load().lib
    with torch.cuda.device(parts.device):
        err = lib.kf_ring_rs(_RS_CODES[parts.dtype], _rows(parts), _rows(out),
                             k, chunk, cut,
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "reduce-scatter launch")
    launch_counts["ring_rs"] += 1
    return out


def all_gather(shards: torch.Tensor, cut: Optional[int] = None
               ) -> torch.Tensor:
    """The all-gather kernel for one ring: ``shards`` ``[k, chunk]`` to
    ``[k, k*chunk]``, moved as 2- or 4-byte words (an 8-byte dtype as
    pairs of 4-byte words); ``cut`` as in :func:`reduce_scatter`."""
    _check(shards, "shards")
    k, chunk = shards.shape
    cut = chunk if cut is None else int(cut)
    if not 0 < cut <= chunk:
        raise ValueError(f"band cut {cut} outside (0, {chunk}]")
    size = shards.element_size()
    if size not in (2, 4, 8):
        raise ValueError(f"the all-gather kernel moves 2-, 4- or 8-byte "
                         f"elements, got {shards.dtype}")
    out = torch.empty((k, k * chunk), dtype=shards.dtype, device=shards.device)
    words = 2 if size == 8 else 1
    wdt = torch.int16 if size == 2 else torch.int32
    _launch_ag(min(size, 4), shards.view(wdt), out.view(wdt), chunk * words,
               cut * words)
    launch_counts["ring_ag"] += 1
    return out
