"""Flash attention: the hand-written Hopper kernels and their plain
PyTorch versions.

Port of ``kungfu_tpu/ops/pallas/attention.py``.  The kernels replace the
TPU kernels ``_fwd_kernel`` (``csrc/flash_fwd.cu``), ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel`` (``csrc/flash_bwd.cu``).  In bf16 all three are
warp-specialised Hopper kernels (wgmma products, TMA tile rings over 3-D
tensor maps that the C launchers encode on each call,
``csrc/hopper.cuh``); the f32 kernels use FMA on the CUDA cores.  Their
plain versions:
:func:`flash_attention_reference` computes the forward with the same f32
upcast, ``1/sqrt(D)`` scale, ``-1e30`` mask and ``1e-30`` clamp in one
pass; :func:`flash_attention_backward_reference` is the reference's
blocked backward ``_bwd_blocked``.

The op is a ``torch.autograd.Function`` differentiable in both outputs,
as the reference's ``custom_vjp``: the lse cotangent folds into the
backward as ``delta -= dlse`` (``_flash_pair_bwd``).  Dispatch is by the
device of the tensors: a CPU tensor takes the plain versions, a CUDA
tensor launches the kernels or raises — a failed build, a refused launch
or a CUDA error never falls back to a plain version or to a library
attention.  A head narrower than the compiled dims (32, 64, 128) runs
zero-padded to one of them where :data:`PADDED_HEAD_DIMS` names it.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from kungfu_tpu_torch.ops.cuda import _build

#: head dims the kernels are compiled for
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_NEG_INF = -1e30
#: kv block of the plain blocked backward (any size gives the same sums
#: up to f32 reassociation)
BWD_BLOCK_K = 256

#: launches of the hand-written kernels: +1 per launch, nowhere else
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_lock = threading.Lock()
_built: Dict[str, _build.Built] = {}


#: guards the counts: ranks in threads of one process launch at once
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def _load(source: str, signatures: Dict[str, int]) -> _build.Built:
    """Build (first call only) and bind ``csrc/<source>``; ``signatures``
    maps each launcher to its number of pointer arguments before the
    ``bh, seq, head_dim, causal, is_bf16`` ints, the scale and the
    stream."""
    with _lock:
        if source not in _built:
            built = _build.build(source)
            for name, n_ptrs in signatures.items():
                fn = getattr(built.lib, name)
                fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            built.lib.kf_error_string.argtypes = [ctypes.c_int]
            built.lib.kf_error_string.restype = ctypes.c_char_p
            _built[source] = built
        return _built[source]


def load() -> _build.Built:
    """Build and bind ``csrc/flash_fwd.cu``."""
    return _load("flash_fwd.cu", {"kf_flash_fwd": 5})


def load_bwd() -> _build.Built:
    """Build and bind ``csrc/flash_bwd.cu``."""
    return _load("flash_bwd.cu", {"kf_flash_bwd_dq": 7, "kf_flash_bwd_dkv": 8})


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(O, lse)`` for ``[..., S, D]``
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


def flash_attention_backward_reference(q, k, v, out, lse, dout, causal: bool,
                                       block_k: int = BWD_BLOCK_K, delta=None
                                       ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernels (the reference's
    ``_bwd_blocked``): ``(dq, dk, dv)`` in q's dtype for ``[BH, S, D]``
    operands, all arithmetic in f32, one kv block at a time.  ``delta``
    defaults to ``rowsum(dO * O)``; a caller with an lse cotangent passes
    ``rowsum(dO * O) - dlse``."""
    s, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    qf, dof = q.float(), dout.float()
    if delta is None:
        delta = (dof * out.float()).sum(-1)
    q_pos = torch.arange(s, device=q.device)[:, None]
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    for k0 in range(0, s, block_k):
        kb, vb = k[..., k0:k0 + block_k, :].float(), v[..., k0:k0 + block_k, :].float()
        s_blk = (qf @ kb.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[-2], device=q.device)[None, :]
        p = torch.exp(s_blk - lse[..., None])
        if causal:
            p = p.masked_fill(q_pos < k_pos, 0.0)
        ds = p * (dof @ vb.transpose(-1, -2) - delta[..., None])
        dq += (ds @ kb) * scale
        dk[..., k0:k0 + block_k, :] = (ds.transpose(-1, -2) @ qf) * scale
        dv[..., k0:k0 + block_k, :] = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3:
        raise ValueError(f"expected [BH, S, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} is not supported by the "
                         f"flash kernel (supported: {SUPPORTED_HEAD_DIMS})")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if q.shape[0] > 65535 or q.shape[1] == 0:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous rows with a 16-byte aligned base, as the kernels' vector
    loads need: operands arrive as strided views (the model's head split
    and RoPE concat), so each is made contiguous here once — one copy —
    instead of passing strides; an offset view is copied too."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash {what} launch failed: "
                           f"{lib.kf_error_string(err).decode()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on contiguous, aligned ``[BH, S, D]`` operands."""
    lib = load().lib
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kf_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, s, d, int(bool(causal)),
            int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5), stream)
    _raise_on(lib, err, "forward")
    _count("flash_fwd")
    return out, lse


def _bwd_operands(q, dout, lse, delta):
    """dout, lse and delta as the backward kernels take them."""
    bh, s, _ = q.shape
    dout = _operand(dout.to(q.dtype))
    lse, delta = (t.float().contiguous() for t in (lse, delta))
    if dout.shape != q.shape or lse.shape != (bh, s) or delta.shape != (bh, s):
        raise ValueError(f"backward operands do not match q {tuple(q.shape)}: "
                         f"dout {tuple(dout.shape)} lse {tuple(lse.shape)} "
                         f"delta {tuple(delta.shape)}")
    return dout, lse, delta


def _launch_bwd_kernel(name: str, q, k, v, dout, lse, delta, causal: bool,
                       outs) -> None:
    lib = load_bwd().lib
    bh, s, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"kf_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            bh, s, d, int(bool(causal)), int(q.dtype == torch.bfloat16),
            1.0 / (d ** 0.5), stream)
    _raise_on(lib, err, name)
    _count(name)


def _launch_bwd_dq(q, k, v, dout, lse, delta, causal: bool) -> torch.Tensor:
    """The dQ kernel on the forward's operands and prepared dout, lse,
    delta (:func:`_bwd_operands`)."""
    dq = torch.empty_like(q)
    _launch_bwd_kernel("flash_bwd_dq", q, k, v, dout, lse, delta, causal, (dq,))
    return dq


def _launch_bwd_dkv(q, k, v, dout, lse, delta, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel, operands as :func:`_launch_bwd_dq`."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd_kernel("flash_bwd_dkv", q, k, v, dout, lse, delta, causal,
                       (dk, dv))
    return dk, dv


def _launch_bwd(q, k, v, dout, lse, delta, causal: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dQ kernel, then the dK/dV kernel."""
    dout, lse, delta = _bwd_operands(q, dout, lse, delta)
    dq = _launch_bwd_dq(q, k, v, dout, lse, delta, causal)
    return (dq, *_launch_bwd_dkv(q, k, v, dout, lse, delta, causal))


def flash_attention_backward(q, k, v, out, lse, dout, dlse=None,
                             causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_with_lse` for ``[BH, S, D]``
    operands: the plain version on the CPU, the kernels on CUDA.
    ``delta = rowsum(dO * O) - dlse`` is formed here, outside the kernels,
    as the reference forms it outside its Pallas kernels."""
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                  causal, delta=delta)
    return _launch_bwd(q, k, v, dout, lse, delta, causal)


class _Flash(torch.autograd.Function):
    """``(O, lse)`` with the flash backward; the plain versions on CPU
    tensors, the kernels on CUDA ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, causal)
        else:
            _check(q, k, v)
            q, k, v = (_operand(t) for t in (q, k, v))
            out, lse = _launch(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                          ctx.causal), None)


#: head dims that run zero-padded to a compiled dim on the card: the
#: serving demo's 16-wide heads (``examples/serve_demo``: d_model 32 over
#: 2 heads) pad to 64, a power of 4 times as wide, so the scale
#: correction ``sqrt(64 / 16)`` = 2 is exact in bf16 and f32.  The
#: reference's Pallas kernel takes the whole head dim as one block, so
#: any ``D`` runs there
PADDED_HEAD_DIMS = {16: 64}


def _flash_padded(q, k, v, causal: bool, dp: int):
    """``(O, lse)`` through heads zero-padded to ``dp``: the zero lanes
    leave every q.k unchanged and give zero output lanes, and q scaled by
    ``sqrt(dp / d)`` turns the kernels' ``1/sqrt(dp)`` into
    ``1/sqrt(d)``; differentiable through the pad, scale and slice."""
    d = q.shape[-1]
    pad = (0, dp - d)
    scale = float(math.isqrt(dp // d))
    out, lse = _Flash.apply(F.pad(q * scale, pad), F.pad(k, pad),
                            F.pad(v, pad), causal)
    return out[..., :d], lse


def _flash_pair(q, k, v, causal: bool):
    """``(O, lse)`` for ``[BH, S, D]``: plain versions on the CPU, the
    kernels on CUDA (a head of :data:`PADDED_HEAD_DIMS` padded)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, "
                         f"not {q.device}")
    d = q.shape[-1]
    if q.device.type == "cuda" and d in PADDED_HEAD_DIMS:
        return _flash_padded(q, k, v, causal, PADDED_HEAD_DIMS[d])
    return _Flash.apply(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Fused attention for ``[B, H, S, D]`` (or ``[BH, S, D]``) operands;
    numerically the reference's ``flash_attention``, differentiable."""
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
    online-softmax merge (ring attention) needs; differentiable in both
    outputs."""
    if q.dim() != 3:
        raise ValueError(f"expected [BH, S, D], got {tuple(q.shape)}")
    return _flash_pair(q, k, v, causal)


def make_flash_attn() -> Callable:
    """Adapter for the ``attn_fn(q, k, v, causal)`` slot of
    :meth:`kungfu_tpu_torch.models.transformer.Transformer.apply`."""

    def attn(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal)

    return attn
