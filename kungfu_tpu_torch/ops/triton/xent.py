"""Fused softmax cross-entropy: the Triton kernels and their plain
PyTorch versions.

Port of the kernels of ``kungfu_tpu/ops/pallas/xent.py``.  The forward
kernel replaces ``_fwd_kernel``: one program per block of rows streams
the vocab in blocks, carrying the running max, the running sum of
exponentials and the target logit, and writes ``loss = lse - logit[t]``
and ``lse`` as ``[N]`` f32 vectors — the only extra memory is O(N), never
a second ``[N, V]`` tensor.  The backward kernel replaces ``_bwd_kernel``:
one program per (row block, vocab block) recomputes
``dlogits = (exp(logits - lse) - onehot(t)) * g`` and writes it in the
logits' dtype.  Neither has a matrix product: both are bound by device
memory (the logits read once forward; read once and dlogits written once
backward), which Triton's block loads and reductions reach as well as
CUDA C++ would.  The vocab tail is masked only when the block does not
divide V; the lane-replicated row vectors of the TPU kernels were a
Mosaic tiling rule and are not carried over.

:func:`xent_forward_reference` (one-pass ``logsumexp - logit[t]``) and
:func:`xent_backward_reference` (the reference's blocked ``_bwd_blocked``)
are the plain versions.  :func:`forward` and :func:`backward` dispatch by
device: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises — a failed compile or launch never falls back.  Triton
is imported inside the launching function, never at import.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

#: rows x vocab tile of the forward (one program per row block walks the
#: vocab) and of the backward (one program per tile)
FWD_BLOCK_N, FWD_BLOCK_V = 4, 2048
BWD_BLOCK_N, BWD_BLOCK_V = 8, 1024
#: vocab block of the plain blocked backward
REF_BLOCK_V = 2048

#: launches of the kernels: +1 per launch, nowhere else
launch_counts = {"xent_fwd": 0, "xent_bwd": 0}

#: ``triton.language``, bound by :func:`_kernels` at first launch; the
#: kernels below read it as a module global when Triton compiles them
#: (Triton admits modules and constexprs as globals of a kernel, so the
#: mask value is a literal there)
tl = None
_lock = threading.Lock()
_jitted = None


#: guards the counts: ranks in threads of one process launch at once
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


# -- the kernels (Triton source; compiled at first launch) ----------------
def _xent_fwd_kernel(logits_ptr, targets_ptr, loss_ptr, lse_ptr, n_rows,
                     vocab, stride_n, BLOCK_N: tl.constexpr,
                     BLOCK_V: tl.constexpr, MASKED: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    row_ok = rows < n_rows
    tgt = tl.load(targets_ptr + rows, mask=row_ok, other=-1)
    row_base = logits_ptr + rows.to(tl.int64)[:, None] * stride_n
    m = tl.full([BLOCK_N], -1e30, tl.float32)
    l = tl.zeros([BLOCK_N], tl.float32)
    t = tl.zeros([BLOCK_N], tl.float32)
    for v0 in range(0, vocab, BLOCK_V):
        cols = v0 + tl.arange(0, BLOCK_V)
        mask = row_ok[:, None]
        if MASKED:
            mask = mask & (cols[None, :] < vocab)
        # masked entries read as -1e30: exp(-1e30 - m) underflows to 0
        x = tl.load(row_base + cols[None, :], mask=mask,
                    other=-1e30).to(tl.float32)
        m_new = tl.maximum(m, tl.max(x, axis=1))
        l = l * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new[:, None]), axis=1)
        # the target logit lives in exactly one vocab block
        t += tl.sum(tl.where(cols[None, :] == tgt[:, None], x, 0.0), axis=1)
        m = m_new
    lse = m + tl.log(tl.maximum(l, 1e-30))
    tl.store(loss_ptr + rows, lse - t, mask=row_ok)
    tl.store(lse_ptr + rows, lse, mask=row_ok)


def _xent_bwd_kernel(logits_ptr, targets_ptr, lse_ptr, g_ptr, dlogits_ptr,
                     n_rows, vocab, stride_n, stride_dn, BLOCK_N: tl.constexpr,
                     BLOCK_V: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    row_ok = rows < n_rows
    mask = row_ok[:, None] & (cols[None, :] < vocab)
    rows64 = rows.to(tl.int64)[:, None]
    x = tl.load(logits_ptr + rows64 * stride_n + cols[None, :], mask=mask,
                other=0.0).to(tl.float32)
    lse = tl.load(lse_ptr + rows, mask=row_ok, other=0.0)
    g = tl.load(g_ptr + rows, mask=row_ok, other=0.0)
    tgt = tl.load(targets_ptr + rows, mask=row_ok, other=-1)
    onehot = (cols[None, :] == tgt[:, None]).to(tl.float32)
    d = (tl.exp(x - lse[:, None]) - onehot) * g[:, None]
    tl.store(dlogits_ptr + rows64 * stride_dn + cols[None, :],
             d.to(dlogits_ptr.dtype.element_ty), mask=mask)


def _kernels():
    """Import Triton and wrap the kernels (first call only)."""
    global tl, _jitted
    with _lock:
        if _jitted is None:
            import triton
            import triton.language

            tl = triton.language
            _jitted = (triton.jit(_xent_fwd_kernel),
                       triton.jit(_xent_bwd_kernel), triton.cdiv)
        return _jitted


# -- plain versions --------------------------------------------------------
def xent_forward_reference(logits: torch.Tensor, targets: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(loss, lse)`` f32 ``[N]`` for
    ``[N, V]`` logits, in one pass over the f32 upcast.  A target outside
    ``[0, V)`` matches no logit, so its loss is lse, as in the kernel."""
    x = logits.float()
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    t = targets.long()[:, None]
    ok = (t >= 0) & (t < v)
    picked = torch.where(ok, x.gather(-1, t.clamp(0, v - 1)), 0.0)
    return lse - picked.squeeze(-1), lse


def xent_backward_reference(logits, targets, lse, g,
                            block_v: int = REF_BLOCK_V) -> torch.Tensor:
    """Plain version of the backward kernel (the reference's
    ``_bwd_blocked``): ``(softmax - onehot) * g`` one vocab block at a
    time, each block cast back to the logits' dtype, so live f32 memory
    stays one ``[N, block_v]`` tile beside the output."""
    n, v = logits.shape
    out = torch.empty_like(logits)
    t = targets.long()[:, None]
    for v0 in range(0, v, block_v):
        blk = logits[:, v0:v0 + block_v].float()
        cols = torch.arange(v0, v0 + blk.shape[1], device=logits.device)
        p = torch.exp(blk - lse[:, None])
        onehot = (cols[None, :] == t).float()
        out[:, v0:v0 + block_v] = ((p - onehot) * g[:, None]).to(logits.dtype)
    return out


# -- dispatch --------------------------------------------------------------
def _check(logits: torch.Tensor, targets: torch.Tensor) -> None:
    if logits.dim() != 2 or targets.shape != logits.shape[:1]:
        raise ValueError(f"expected logits [N, V] and targets [N], got "
                         f"{tuple(logits.shape)} and {tuple(targets.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xent takes float32 or bfloat16 logits, got "
                         f"{logits.dtype}")
    if logits.device != targets.device:
        raise ValueError("logits and targets lie on different devices")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xent runs on cuda or cpu, not {logits.device}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A logits matrix with unit stride along the vocab, as the kernels
    index it."""
    return t if t.stride(-1) == 1 else t.contiguous()


def forward(logits: torch.Tensor, targets: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)`` for ``[N, V]`` logits and int ``[N]`` targets in
    ``[0, V)``: the plain version on the CPU, the kernel on CUDA."""
    _check(logits, targets)
    if logits.device.type == "cpu":
        return xent_forward_reference(logits, targets)
    fwd, _, cdiv = _kernels()
    logits = _rows(logits)
    n, v = logits.shape
    targets = targets.to(torch.int32).contiguous()
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(logits.device):
        fwd[(cdiv(n, FWD_BLOCK_N),)](
            logits, targets, loss, lse, n, v, logits.stride(0),
            BLOCK_N=FWD_BLOCK_N, BLOCK_V=FWD_BLOCK_V,
            MASKED=v % FWD_BLOCK_V != 0, num_warps=4)
    _count("xent_fwd")
    return loss, lse


def backward(logits, targets, lse, g) -> torch.Tensor:
    """``dlogits`` in the logits' dtype for the cotangent ``g`` of the
    per-row loss: the plain version on the CPU, the kernel on CUDA."""
    _check(logits, targets)
    g = g.float().expand(logits.shape[:1]).contiguous()
    if logits.device.type == "cpu":
        return xent_backward_reference(logits, targets, lse, g)
    _, bwd, cdiv = _kernels()
    logits = _rows(logits)
    n, v = logits.shape
    targets = targets.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    with torch.cuda.device(logits.device):
        bwd[(cdiv(n, BWD_BLOCK_N), cdiv(v, BWD_BLOCK_V))](
            logits, targets, lse, g, dlogits, n, v, logits.stride(0),
            dlogits.stride(0), BLOCK_N=BWD_BLOCK_N, BLOCK_V=BWD_BLOCK_V,
            num_warps=4)
    _count("xent_bwd")
    return dlogits
