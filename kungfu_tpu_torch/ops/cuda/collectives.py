"""Ring reduce-scatter and all-gather over co-resident ranks: the
hand-written Hopper kernels of ``csrc/ring.cu``.

They replace ``kungfu_tpu/ops/pallas/collectives.py::_rs_kernel`` and
``::_ag_kernel``.  Each wrapper takes one ring's stacked buffers on one
card (row ``r`` is rank ``r``'s), checks them, and launches one kernel
for all ``k`` ranks.  On one card a hop of the ring is a load, so both
work directly: the reduce-scatter folds each output vector from the
``k`` ranks' rows in the ring's order, and the all-gather copies each
vector of a shard into all ``k`` outputs.  Their plain versions, which
compute the same bits, are
:func:`kungfu_tpu_torch.ops.collectives.ring_reduce_scatter_reference`
and :func:`~kungfu_tpu_torch.ops.collectives.ring_all_gather_reference`;
:mod:`kungfu_tpu_torch.ops.collectives` routes between the two.  A CPU
tensor, a failed build or a refused launch raises: nothing falls back.
Neither kernel keeps anything between launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from kungfu_tpu_torch.ops.cuda import _build

#: launches of the hand-written kernels: +1 per launch, nowhere else
launch_counts = {"ring_rs": 0, "ring_ag": 0}

#: reduce-scatter element codes of ``kf_ring_rs``
_RS_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_lock = threading.Lock()
_built: Optional[_build.Built] = None


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
            lib.kf_ring_ag.argtypes = [i32, ptr, ptr, i32, i64, ptr]
            for fn in (lib.kf_ring_rs, lib.kf_ring_ag):
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
    """The all-gather kernel for one ring: ``shards`` ``[k, chunk]`` (any
    row stride and base) to ``[k, k*chunk]``, elements of 2, 4 or 8
    bytes.  ``cut`` is the reference's band cut, checked as in
    :func:`reduce_scatter`: it does not change a gather's values, so the
    kernel takes none."""
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
    lib = load().lib
    with torch.cuda.device(shards.device):
        err = lib.kf_ring_ag(size, _rows(shards), _rows(out), k, chunk,
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "all-gather launch")
    launch_counts["ring_ag"] += 1
    return out
