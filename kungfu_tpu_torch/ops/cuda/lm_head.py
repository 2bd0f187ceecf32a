"""Fused LM head + softmax cross-entropy: the hand-written Hopper kernels
and their plain PyTorch versions.

Port of the kernels of ``kungfu_tpu/ops/pallas/lm_head.py``.  The kernels
in ``csrc/lm_head.cu`` replace ``_fwd_kernel`` (loss and lse from logits
tiles that never leave the chip), ``_bwd_dh_kernel`` (``dh = dl Wᵀ``,
vocab innermost) and ``_bwd_dw_kernel`` (``dW = hᵀ dl``, rows
innermost), where ``dl = (exp(h W - lse) - onehot) * g`` is recomputed
tile by tile.  Their plain versions, :func:`lm_head_forward_reference`
and :func:`lm_head_backward_reference`, compute the same functions one
vocab block at a time (f32 products, the reference's ``-1e30`` start and
``1e-30`` clamp), so a comparison at the flagship shape never holds a
second ``[N, V]`` buffer.  For bf16 ``h`` all three kernels run on the
tensor cores from W split into two bf16 terms (:func:`split_w`, whose
plain version is :func:`split_w_reference`): W is never rounded to one
bf16 and TF32 is never used.  :func:`forward` splits W once and returns
the split, which :func:`backward` reuses for dh and dW: one split a
training step.  f32 ``h`` keeps the f32 SIMT kernels, and so do dh and
dW for bf16 ``h`` with D above :data:`WGMMA_MAX_D` (a cluster holds at
most eight 256-column slices).

:func:`forward` and :func:`backward` dispatch by device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernels or raises —
a failed build, a refused launch or a CUDA error never falls back.  A
target outside ``[0, V)`` gives ``loss = lse`` and no onehot term in
both, as in the reference kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from kungfu_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
#: vocab block of the plain versions (any size gives the same sums up to
#: f32 reassociation)
REF_BLOCK_V = 2048

#: launches of the hand-written kernels: +1 per launch, nowhere else
launch_counts = {"lm_head_fwd": 0, "lm_head_bwd_dh": 0, "lm_head_bwd_dw": 0,
                 "lm_head_split": 0}
#: the wgmma dh and dW kernels' clusters hold D in slices of 256, at
#: most 8
WGMMA_MAX_D = 256 * 8

#: W split into two bf16 terms, ``(hi, lo)`` ``[V, ld]`` (lo None for a
#: bf16 W), as :func:`split_w` returns it
Split = Tuple[torch.Tensor, Optional[torch.Tensor]]

_lock = threading.Lock()
_built: Optional[_build.Built] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def load() -> _build.Built:
    """Build (first call only) and bind ``csrc/lm_head.cu``."""
    global _built
    with _lock:
        if _built is None:
            built = _build.build("lm_head.cu")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            signatures = {
                "kf_lm_head_fwd_splits": [i32] * 3,
                "kf_lm_head_fwd": [ptr] * 6 + [i32] * 4 + [ptr],
                "kf_lm_head_bwd_dh": [ptr] * 6 + [i32] * 5 + [ptr],
                "kf_lm_head_bwd_dw": [ptr] * 6 + [i32] * 5 + [ptr],
                "kf_lm_head_split_w": [ptr] * 3 + [i32] * 4 + [ptr],
                "kf_lm_head_fwd_wgmma": [ptr, i32, ptr, ptr, i32]
                + [ptr] * 4 + [i32] * 5 + [ptr],
                "kf_lm_head_bwd_dh_wgmma": [ptr, i32, ptr, ptr, i32]
                + [ptr] * 5 + [i32] * 4 + [ptr],
                "kf_lm_head_bwd_dw_wgmma": [ptr, i32, ptr, ptr, i32]
                + [ptr] * 5 + [i32] * 4 + [ptr],
            }
            for name, argtypes in signatures.items():
                fn = getattr(built.lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            built.lib.kf_lm_head_exchange_scratch.argtypes = []
            built.lib.kf_lm_head_exchange_scratch.restype = ctypes.c_longlong
            built.lib.kf_error_string.argtypes = [ctypes.c_int]
            built.lib.kf_error_string.restype = ctypes.c_char_p
            _built = built
        return _built


# -- plain versions --------------------------------------------------------
def lm_head_forward_reference(h: torch.Tensor, w: torch.Tensor,
                              targets: torch.Tensor,
                              block_v: int = REF_BLOCK_V
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(loss, lse)`` f32 ``[N]`` for
    ``h`` ``[N, D]``, ``w`` ``[D, V]``: an online softmax over f32 logits
    blocks ``h @ w[:, block]``, as the reference's ``_fwd_kernel`` sweeps
    them."""
    hf = h.float()
    n, v = h.shape[0], w.shape[1]
    t = targets.long()[:, None]
    m = torch.full((n,), _NEG_INF, dtype=torch.float32, device=h.device)
    l = torch.zeros_like(m)
    tl = torch.zeros_like(m)
    for v0 in range(0, v, block_v):
        x = hf @ w[:, v0:v0 + block_v].float()
        cols = torch.arange(v0, v0 + x.shape[1], device=h.device)
        m_new = torch.maximum(m, x.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(x - m_new[:, None]).sum(1)
        tl = tl + torch.where(cols[None, :] == t, x, 0.0).sum(1)
        m = m_new
    lse = m + torch.log(l.clamp_min(1e-30))
    return lse - tl, lse


def lm_head_backward_reference(h, w, targets, lse, g,
                               block_v: int = REF_BLOCK_V
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: ``(dh, dW)`` in h's and w's
    dtypes for the cotangent ``g`` of the per-row loss, one vocab block
    at a time (``dl = (exp(x - lse) - onehot) * g`` in f32, ``dh += dl
    w_blkᵀ``, ``dW[:, blk] = hᵀ dl``), each summed in f32 and rounded
    once."""
    hf = h.float()
    v = w.shape[1]
    t = targets.long()[:, None]
    dh = torch.zeros(hf.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    for v0 in range(0, v, block_v):
        wb = w[:, v0:v0 + block_v].float()
        x = hf @ wb
        cols = torch.arange(v0, v0 + x.shape[1], device=h.device)
        dl = (torch.exp(x - lse[:, None]) - (cols[None, :] == t).float()
              ) * g[:, None]
        dh += dl @ wb.T
        dw[:, v0:v0 + block_v] = (hf.T @ dl).to(w.dtype)
    return dh.to(h.dtype), dw


def split_ld(d: int) -> int:
    """Row pitch in elements of the split's ``[V, ld]`` outputs: ``d``
    rounded up to 8, so a row is a multiple of 16 bytes (TMA's rule)."""
    return -(-d // 8) * 8


def split_w_reference(w: torch.Tensor
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the split kernel: ``w`` ``[D, V]`` to ``hi`` and
    ``lo`` bf16 ``[V, ld]`` (columns ``[D, ld)`` zero), ``hi = bf16(wᵀ)``
    and ``lo = bf16(wᵀ - hi)``; ``lo`` is None for a bf16 ``w``, whose
    ``hi`` is ``wᵀ`` exactly."""
    d, v = w.shape
    wt = w.t().float()
    hi = torch.zeros((v, split_ld(d)), dtype=torch.bfloat16, device=w.device)
    hi[:, :d] = wt.to(torch.bfloat16)
    if w.dtype == torch.bfloat16:
        return hi, None
    lo = torch.zeros_like(hi)
    lo[:, :d] = (wt - hi[:, :d].float()).to(torch.bfloat16)
    return hi, lo


# -- dispatch --------------------------------------------------------------
def _check(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor) -> None:
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[1] \
            or targets.shape != h.shape[:1]:
        raise ValueError(f"expected h [N, D], w [D, V] and targets [N], got "
                         f"{tuple(h.shape)}, {tuple(w.shape)} and "
                         f"{tuple(targets.shape)}")
    for name, t in (("h", h), ("w", w)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the fused LM head takes float32 or bfloat16 "
                             f"{name}, got {t.dtype}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise ValueError(f"targets must be integers, got {targets.dtype}")
    if not (h.device == w.device == targets.device):
        raise ValueError("h, w and targets lie on different devices")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused LM head runs on cuda or cpu, "
                         f"not {h.device}")
    if min(h.shape + w.shape[1:]) == 0 or max(h.shape + w.shape[1:]) >= 2 ** 31:
        raise ValueError(f"unsupported sizes h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"lm_head {what} launch failed: "
                           f"{lib.kf_error_string(err).decode()}")


def _types(h: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    return int(h.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def split_w(w: torch.Tensor) -> Split:
    """The split kernel on a contiguous CUDA ``w``: as
    :func:`split_w_reference`, bit for bit."""
    lib = load().lib
    d, v = w.shape
    hi = torch.empty((v, split_ld(d)), dtype=torch.bfloat16, device=w.device)
    lo = None if w.dtype == torch.bfloat16 else torch.empty_like(hi)
    with torch.cuda.device(w.device):
        err = lib.kf_lm_head_split_w(
            w.data_ptr(), hi.data_ptr(), 0 if lo is None else lo.data_ptr(),
            d, v, hi.shape[1], int(lo is None), _stream(w))
    _raise_on(lib, err, "split")
    launch_counts["lm_head_split"] += 1
    return hi, lo


def _split_for(w: torch.Tensor, split: Optional[Split]) -> Split:
    """``split`` checked against ``w``, or a new split of ``w``."""
    if split is None:
        return split_w(w)
    hi, lo = split
    d, v = w.shape
    if hi.shape != (v, split_ld(d)) or hi.dtype != torch.bfloat16 \
            or hi.device != w.device or not hi.is_contiguous() \
            or (lo is None) != (w.dtype == torch.bfloat16) \
            or (lo is not None and (lo.shape != hi.shape
                                    or lo.dtype != torch.bfloat16
                                    or lo.device != w.device
                                    or not lo.is_contiguous())):
        raise ValueError("split does not match w: expected hi (and lo for "
                         "an f32 w) bf16 [V, ld] on w's device")
    return hi, lo


def _tma_rows(h: torch.Tensor) -> torch.Tensor:
    """``h``, or a copy with a 16-byte row pitch and base: TMA reads rows
    of a pitch that is a multiple of 16 bytes."""
    n, d = h.shape
    if d % 8 == 0 and h.data_ptr() % 16 == 0:
        return h
    padded = torch.empty((n, split_ld(d)), dtype=h.dtype, device=h.device)
    padded[:, :d] = h
    return padded


def _split_args(split: Split) -> tuple:
    hi, lo = split
    return hi.data_ptr(), 0 if lo is None else lo.data_ptr(), hi.shape[1]


def _launch_fwd(h, w, targets, split: Optional[Split] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Split]]:
    """The forward kernel on contiguous ``h``, ``w`` and int32 ``targets``:
    ``(loss, lse, split)``.  bf16 ``h`` takes the wgmma kernel on the
    split of ``w`` (``split``, or one made here), which it returns; f32
    ``h`` takes the f32 SIMT kernel and returns no split."""
    lib = load().lib
    (n, d), v = h.shape, w.shape[1]
    bf16 = h.dtype == torch.bfloat16
    if bf16:
        split = _split_for(w, split)
    with torch.cuda.device(h.device):
        # the partial max, sum and target logit of each vocab split
        part = torch.empty((lib.kf_lm_head_fwd_splits(n, v, int(bf16)), n, 3),
                           dtype=torch.float32, device=h.device)
        loss = torch.empty(n, dtype=torch.float32, device=h.device)
        lse = torch.empty_like(loss)
        if bf16:
            ht = _tma_rows(h)
            err = lib.kf_lm_head_fwd_wgmma(
                ht.data_ptr(), ht.stride(0), *_split_args(split),
                targets.data_ptr(), part.data_ptr(), loss.data_ptr(),
                lse.data_ptr(), n, d, v, part.shape[0],
                int(split[1] is None), _stream(h))
        else:
            split = None
            err = lib.kf_lm_head_fwd(
                h.data_ptr(), w.data_ptr(), targets.data_ptr(),
                part.data_ptr(), loss.data_ptr(), lse.data_ptr(), n, d, v,
                int(w.dtype == torch.bfloat16), _stream(h))
    _raise_on(lib, err, "forward")
    launch_counts["lm_head_fwd"] += 1
    return loss, lse, split


def _launch_bwd_kernel(name: str, h, w, targets, lse, g, out,
                       split: Optional[Split]) -> None:
    """The dh or dW kernel ``name`` into ``out``: the wgmma kernel on the
    split of ``w`` (``split``, or one made here) for bf16 ``h`` with D up
    to :data:`WGMMA_MAX_D`, else the f32 SIMT kernel."""
    lib = load().lib
    (n, d), v = h.shape, w.shape[1]
    if h.dtype != torch.bfloat16 or d > WGMMA_MAX_D:
        with torch.cuda.device(h.device):
            err = getattr(lib, f"kf_{name}")(
                h.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(),
                g.data_ptr(), out.data_ptr(), n, d, v, *_types(h, w),
                _stream(h))
        _raise_on(lib, err, name)
        launch_counts[name] += 1
        return
    split = _split_for(w, split)
    h = _tma_rows(h)
    with torch.cuda.device(h.device):
        # where the cluster's CTAs exchange their partial logits
        scratch = torch.empty(lib.kf_lm_head_exchange_scratch(),
                              dtype=torch.float32, device=h.device)
        err = getattr(lib, f"kf_{name}_wgmma")(
            h.data_ptr(), h.stride(0), *_split_args(split), targets.data_ptr(),
            lse.data_ptr(), g.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, d, v, int(split[1] is None), _stream(h))
    _raise_on(lib, err, name)
    launch_counts[name] += 1


def _launch_dh(h, w, targets, lse, g, split: Optional[Split] = None
               ) -> torch.Tensor:
    """The dh kernel on contiguous operands (int32 targets, f32 lse and
    g)."""
    dh = torch.empty_like(h)
    _launch_bwd_kernel("lm_head_bwd_dh", h, w, targets, lse, g, dh, split)
    return dh


def _launch_dw(h, w, targets, lse, g, split: Optional[Split] = None
               ) -> torch.Tensor:
    """The dW kernel, operands as :func:`_launch_dh`."""
    dw = torch.empty_like(w)
    _launch_bwd_kernel("lm_head_bwd_dw", h, w, targets, lse, g, dw, split)
    return dw


def _operands(h, w, targets):
    return h.contiguous(), w.contiguous(), targets.to(torch.int32).contiguous()


def forward(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Split]]:
    """``(loss, lse, split)`` for ``h`` ``[N, D]``, ``w`` ``[D, V]`` and int
    ``targets`` ``[N]``: loss and lse f32 ``[N]``, and the split of ``w``
    the kernel took, for :func:`backward` (None on the CPU and for f32
    ``h``).  The plain version on the CPU, the kernel on CUDA."""
    _check(h, w, targets)
    if h.device.type == "cpu":
        return (*lm_head_forward_reference(h, w, targets), None)
    return _launch_fwd(*_operands(h, w, targets))


def backward(h, w, targets, lse, g, split: Optional[Split] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dh, dW)`` in h's and w's dtypes for the cotangent ``g`` of the
    per-row loss: the plain version on the CPU, the dh kernel then the
    dW kernel on CUDA.  ``split`` is the forward's split of ``w``; without
    it, bf16 ``h`` splits ``w`` once here for both kernels."""
    _check(h, w, targets)
    g = g.float().expand(h.shape[:1]).contiguous()
    lse = lse.float().contiguous()
    if h.device.type == "cpu":
        return lm_head_backward_reference(h, w, targets, lse, g)
    ops = (*_operands(h, w, targets), lse, g)
    if split is None and h.dtype == torch.bfloat16 \
            and h.shape[1] <= WGMMA_MAX_D:
        split = split_w(ops[1])
    return _launch_dh(*ops, split), _launch_dw(*ops, split)
