"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Port of ``kungfu_tpu/ops/pallas/attention.py`` (forward only).  The
kernel (``csrc/flash_fwd.cu``) replaces the TPU kernel ``_fwd_kernel``;
:func:`flash_attention_reference` is its plain version, computing the
same function with the same f32 upcast, ``1/sqrt(D)`` scale, ``-1e30``
mask and ``1e-30`` clamp in one pass.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises — a failed build,
a refused launch or a CUDA error never falls back to the plain version
or to a library attention.  On CUDA the kernel runs inside a
``torch.autograd.Function`` whose backward raises: the backward kernels
are ported with the training slice.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional, Tuple

import torch

from kungfu_tpu_torch.ops.cuda import _build

#: head dims the kernel is compiled for
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_NEG_INF = -1e30

#: launches of the hand-written kernel: +1 per launch, nowhere else
launch_counts = {"flash_fwd": 0}

_lock = threading.Lock()
_built: Optional[_build.Built] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def load() -> _build.Built:
    """Build (first call only) and bind ``csrc/flash_fwd.cu``."""
    global _built
    with _lock:
        if _built is None:
            built = _build.build("flash_fwd.cu")
            fn = built.lib.kf_flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            built.lib.kf_error_string.argtypes = [ctypes.c_int]
            built.lib.kf_error_string.restype = ctypes.c_char_p
            _built = built
        return _built


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(O, lse)`` for ``[..., S, D]``
    operands (``[BH, S, D]`` or ``[B, H, S, D]``); O in the input dtype,
    lse f32.  P is rounded to V's dtype before the PV product, as the
    kernel does; the row sum uses the unrounded f32 P."""
    s, d = q.shape[-2], q.shape[-1]
    logits = (q.float() * (1.0 / (d ** 0.5))) @ k.float().transpose(-1, -2)
    mask = None
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p.to(v.dtype).float() @ v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3:
        raise ValueError(f"expected [BH, S, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash forward takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} is not supported by the "
                         f"flash kernel (supported: {SUPPORTED_HEAD_DIMS})")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if q.shape[0] > 65535 or q.shape[1] == 0:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(q, k, v)
    lib = load().lib
    # q/k/v arrive as strided views (the model's head split and RoPE
    # concat); the kernel takes contiguous rows, so each is made
    # contiguous here once — one copy — instead of passing strides.
    # A fresh contiguous tensor is 16-byte aligned, as the kernel's
    # vector loads need; an offset view is copied to get there.
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kf_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, s, d, int(bool(causal)),
            int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash forward launch failed: "
                           f"{lib.kf_error_string(err).decode()}")
    launch_counts["flash_fwd"] += 1
    return out, lse


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _launch(q, k, v, causal)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        raise NotImplementedError(
            "flash backward is ported with the training slice")


def _flash_pair(q, k, v, causal: bool):
    """``(O, lse)`` for ``[BH, S, D]``: plain version on the CPU, the
    kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, "
                         f"not {q.device}")
    return _FlashForward.apply(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Fused attention for ``[B, H, S, D]`` (or ``[BH, S, D]``) operands;
    numerically the reference's ``flash_attention`` forward."""
    if q.dim() == 3:
        return _flash_pair(q, k, v, causal)[0]
    if q.dim() != 4:
        raise ValueError(f"expected [B,H,S,D] or [BH,S,D], got {tuple(q.shape)}")
    b, h, s, d = q.shape
    out = _flash_pair(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                      v.reshape(b * h, s, d), causal)[0]
    return out.reshape(b, h, s, d)


def flash_attention_with_lse(q, k, v, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)`` for ``[BH, S, D]`` operands — the pair a cross-block
    online-softmax merge (ring attention) needs."""
    if q.dim() != 3:
        raise ValueError(f"expected [BH, S, D], got {tuple(q.shape)}")
    return _flash_pair(q, k, v, causal)


def make_flash_attn() -> Callable:
    """Adapter for the ``attn_fn(q, k, v, causal)`` slot of
    :meth:`kungfu_tpu_torch.models.transformer.Transformer.apply`."""

    def attn(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal)

    return attn
