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

Across worker processes (a process-spanning
:class:`~kungfu_tpu_torch.comm.device.Communicator`) a ring's rows lie in
several processes' symmetric buffers: :func:`reduce_scatter_rows` and
:func:`all_gather_rows` take every rank's row, this process's and the
peers' mapped through CUDA IPC, and launch for this process's own ranks
only.  The symmetric buffers come from :func:`sym_alloc`, :func:`sym_open`,
:func:`sym_close` and :func:`sym_free` (``cudaMalloc`` and the IPC calls,
built from the same source).
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
            lib.kf_ring_rs.argtypes = [i32, ptr, ptr, i32, i32, i32, i64,
                                       i64, ptr]
            lib.kf_ring_ag.argtypes = [i32, ptr, ptr, i32, i32, i32, i64,
                                       ptr]
            lib.kf_sym_handle_bytes.argtypes = []
            lib.kf_sym_alloc.argtypes = [i32, i64, ctypes.POINTER(ptr), ptr]
            lib.kf_sym_open.argtypes = [i32, ptr, ctypes.POINTER(ptr)]
            lib.kf_sym_close.argtypes = [ptr]
            lib.kf_sym_free.argtypes = [ptr]
            for fn in (lib.kf_ring_rs, lib.kf_ring_ag, lib.kf_sym_handle_bytes,
                       lib.kf_sym_alloc, lib.kf_sym_open, lib.kf_sym_close,
                       lib.kf_sym_free):
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


def _ptrs(rows):
    """The base pointers of a list of 1-D tensors as a C array."""
    return (ctypes.c_void_p * len(rows))(*(t.data_ptr() for t in rows))


def _check_rows(rows, outs, r0: int, what: str) -> None:
    """``rows`` (every rank's row) and ``outs`` (the outputs of ranks
    ``r0 .. r0 + len(outs) - 1``): 1-D contiguous CUDA tensors of one
    dtype on one card."""
    k = len(rows)
    if k < 2 or not 1 <= len(outs) or not 0 <= r0 <= k - len(outs):
        raise ValueError(f"{what}: {len(outs)} outputs from rank {r0} of "
                         f"{k} rows")
    dev, dtype = rows[0].device, rows[0].dtype
    for t in list(rows) + list(outs):
        if t.device.type != "cuda" or t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: every row and output must be a "
                             f"{dtype} tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: rows and outputs are 1-D contiguous, "
                             f"got shape {tuple(t.shape)}")


def _launch_rs(code: int, ins, outs, k: int, r0: int, count: int,
               chunk: int, cut: int, device) -> None:
    """One reduce-scatter launch: ``ins`` and ``outs`` C arrays of device
    pointers (every rank's buffer; the outputs of ranks ``r0 .. r0 +
    count - 1``)."""
    lib = load().lib
    with torch.cuda.device(device):
        err = lib.kf_ring_rs(code, ins, outs, k, r0, count, chunk, cut,
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "reduce-scatter launch")
    launch_counts["ring_rs"] += 1


def _launch_ag(nbytes: int, ins, outs, k: int, r0: int, count: int,
               chunk: int, device) -> None:
    """One all-gather launch, its pointers as :func:`_launch_rs`'s."""
    lib = load().lib
    with torch.cuda.device(device):
        err = lib.kf_ring_ag(nbytes, ins, outs, k, r0, count, chunk,
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "all-gather launch")
    launch_counts["ring_ag"] += 1


def _rs_cut(dtype, chunk: int, cut: Optional[int]) -> int:
    if dtype not in _RS_CODES:
        raise ValueError(f"the reduce-scatter kernel sums float32, bfloat16 "
                         f"or int32, got {dtype}")
    cut = chunk if cut is None else int(cut)
    if not 0 < cut <= chunk:
        raise ValueError(f"band cut {cut} outside (0, {chunk}]")
    return cut


def _ag_check(dtype, chunk: int, cut: Optional[int]) -> None:
    cut = chunk if cut is None else int(cut)
    if not 0 < cut <= chunk:
        raise ValueError(f"band cut {cut} outside (0, {chunk}]")
    size = torch.empty((), dtype=dtype).element_size()
    if size not in (2, 4, 8):
        raise ValueError(f"the all-gather kernel moves 2-, 4- or 8-byte "
                         f"elements, got {dtype}")


def reduce_scatter(parts: torch.Tensor, cut: Optional[int] = None
                   ) -> torch.Tensor:
    """The reduce-scatter kernel for one ring: ``parts`` ``[k, k*chunk]``
    (row ``r``: rank ``r``'s mesh-major flat buffer; any row stride and
    base) to ``[k, chunk]``, f32, bf16 or int32; ``cut`` ends the
    clockwise band (default ``chunk``: one direction)."""
    _check(parts, "parts")
    k = parts.shape[0]
    if parts.shape[1] % k:
        raise ValueError(f"rows of {parts.shape[1]} elements do not split "
                         f"into {k} chunks")
    chunk = parts.shape[1] // k
    cut = _rs_cut(parts.dtype, chunk, cut)
    out = torch.empty((k, chunk), dtype=parts.dtype, device=parts.device)
    _launch_rs(_RS_CODES[parts.dtype], _rows(parts), _rows(out), k, 0, k,
               chunk, cut, parts.device)
    return out


def reduce_scatter_rows(rows, outs, r0: int, cut: Optional[int] = None
                        ) -> None:
    """The reduce-scatter kernel for one ring whose rows lie in several
    processes' buffers: ``rows`` holds every rank's mesh-major flat
    buffer in ring order (``[k*chunk]`` each: this process's own and its
    peers' mapped ones), ``outs`` the ``[chunk]`` outputs of ranks ``r0
    .. r0 + len(outs) - 1``, which one launch writes.  Each output is bit
    for bit the chunk :func:`reduce_scatter` gives that rank."""
    _check_rows(rows, outs, r0, "reduce_scatter_rows")
    k = len(rows)
    if rows[0].numel() % k or any(t.numel() != rows[0].numel() for t in rows):
        raise ValueError(f"reduce_scatter_rows: {k} rows of "
                         f"{[t.numel() for t in rows]} elements do not "
                         f"split into {k} equal chunks")
    chunk = rows[0].numel() // k
    if any(t.numel() != chunk for t in outs):
        raise ValueError(f"reduce_scatter_rows: outputs must hold {chunk} "
                         "elements")
    cut = _rs_cut(rows[0].dtype, chunk, cut)
    _launch_rs(_RS_CODES[rows[0].dtype], _ptrs(rows), _ptrs(outs), k, r0,
               len(outs), chunk, cut, rows[0].device)


def all_gather(shards: torch.Tensor, cut: Optional[int] = None
               ) -> torch.Tensor:
    """The all-gather kernel for one ring: ``shards`` ``[k, chunk]`` (any
    row stride and base) to ``[k, k*chunk]``, elements of 2, 4 or 8
    bytes.  ``cut`` is the reference's band cut, checked as in
    :func:`reduce_scatter`: it does not change a gather's values, so the
    kernel takes none."""
    _check(shards, "shards")
    k, chunk = shards.shape
    _ag_check(shards.dtype, chunk, cut)
    out = torch.empty((k, k * chunk), dtype=shards.dtype, device=shards.device)
    _launch_ag(shards.element_size(), _rows(shards), _rows(out), k, 0, k,
               chunk, shards.device)
    return out


def all_gather_rows(rows, outs, r0: int, cut: Optional[int] = None) -> None:
    """The all-gather kernel for one ring whose shards lie in several
    processes' buffers: ``rows`` holds every rank's ``[chunk]`` shard in
    ring order, ``outs`` the ``[k*chunk]`` outputs of ranks ``r0 .. r0 +
    len(outs) - 1``, which one launch writes."""
    _check_rows(rows, outs, r0, "all_gather_rows")
    k, chunk = len(rows), rows[0].numel()
    if any(t.numel() != chunk for t in rows) \
            or any(t.numel() != k * chunk for t in outs):
        raise ValueError(f"all_gather_rows: {k} shards of {chunk} elements "
                         f"into outputs of {k * chunk}")
    _ag_check(rows[0].dtype, chunk, cut)
    _launch_ag(rows[0].element_size(), _ptrs(rows), _ptrs(outs), k, r0,
               len(outs), chunk, rows[0].device)


# -- symmetric buffers (CUDA IPC) --------------------------------------------

class _DeviceMemory:
    """``__cuda_array_interface__`` over a raw device allocation, so that
    :func:`torch.as_tensor` views it without a copy."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


def device_bytes(ptr: int, nbytes: int, device) -> torch.Tensor:
    """A ``uint8`` tensor over ``nbytes`` of device memory at ``ptr`` (a
    buffer of :func:`sym_alloc` or :func:`sym_open`); it does not own the
    memory."""
    return torch.as_tensor(_DeviceMemory(ptr, nbytes), device=device)


def sym_alloc(nbytes: int, device) -> tuple:
    """``cudaMalloc`` ``nbytes`` on ``device``: ``(ptr, handle)``, the
    handle the bytes a peer process opens with :func:`sym_open`."""
    lib = load().lib
    handle = ctypes.create_string_buffer(lib.kf_sym_handle_bytes())
    ptr = ctypes.c_void_p()
    err = lib.kf_sym_alloc(torch.device(device).index or 0, int(nbytes),
                           ctypes.byref(ptr), handle)
    _raise_on(lib, err, f"symmetric buffer of {nbytes} bytes")
    return ptr.value, handle.raw


def sym_open(handle: bytes, device) -> int:
    """Map a peer process's :func:`sym_alloc` buffer; its pointer here."""
    lib = load().lib
    ptr = ctypes.c_void_p()
    err = lib.kf_sym_open(torch.device(device).index or 0, handle,
                          ctypes.byref(ptr))
    _raise_on(lib, err, "opening a peer's symmetric buffer")
    return ptr.value


def sym_close(ptr: int) -> None:
    """Unmap a buffer of :func:`sym_open`."""
    lib = load().lib
    _raise_on(lib, lib.kf_sym_close(ptr), "closing a peer's buffer")


def sym_free(ptr: int) -> None:
    """Free a buffer of :func:`sym_alloc`."""
    lib = load().lib
    _raise_on(lib, lib.kf_sym_free(ptr), "freeing a symmetric buffer")
