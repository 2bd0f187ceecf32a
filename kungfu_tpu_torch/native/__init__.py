"""ctypes loader for the native host-runtime kernels (port of
``kungfu_tpu/native/__init__.py``).

The host collective engine's inner loop -- accumulate a received chunk
into the local buffer -- runs in C++ (:file:`reduce.cpp`, a copy of the
reference's), and the same library holds the native transport
(:file:`transport.cpp`, see :mod:`kungfu_tpu_torch.native.transport`).
The library is built with ``g++`` at first use, with the flags of the
reference Makefile's production target (``kungfu_tpu/native/Makefile``:
``-O3 -mtune=generic -fPIC -pthread -std=c++17 -Wall -Wextra -shared``;
``KF_NATIVE_MARCH=X`` swaps ``-mtune=generic`` for ``-march=X``), into
``_build/`` beside this file and nowhere else.  The compiler writes a
temp file that is renamed over ``libkfnative.so``, under an exclusive
``flock`` and beside a stamp of the flags and the sources' hash, so
several processes racing on first use build once and never load a
half-written library, and an edited source or flag rebuilds.

Without a compiler or with ``KF_TPU_NO_NATIVE=1`` every entry point falls
back to numpy.  The fallback is bitwise equal to the C++ loop: integers
wrap, a NaN operand propagates, and f16/bf16 widen to f32, reduce, and
narrow with round-to-nearest-even, a NaN becoming the C++ loop's quiet
NaN.  Where both operands are NaNs of different bits, which one the
result carries is the vectorizer's choice in the C++ loop itself (the
vector body and the scalar tail differ), and numpy's may differ again.

Buffers are contiguous CPU ``torch.Tensor`` s (pinned or not) or numpy
arrays; a bfloat16 buffer is a ``torch.bfloat16`` tensor, or a numpy
array whose dtype is named ``bfloat16`` (ml_dtypes', as the reference's
tests feed it), both reduced as code 11.  The sanitizer builds of the
reference (``KF_NATIVE_SANITIZE``) come with ROADMAP A9c.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
#: every file the build writes lives here (gitignored)
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("reduce.cpp", "transport.cpp")
LIB_NAME = "libkfnative.so"

#: reference ``native/__init__.py:46``, keyed by torch dtype
_DTYPE_CODES = {
    torch.uint8: 0,
    torch.int8: 1,
    torch.int16: 2,
    torch.int32: 3,
    torch.int64: 4,
    torch.uint16: 5,
    torch.uint32: 6,
    torch.uint64: 7,
    torch.float16: 8,
    torch.float32: 9,
    torch.float64: 10,
    torch.bfloat16: 11,
}
_OP_CODES = {"sum": 0, "min": 1, "max": 2, "prod": 3}

_NP_REDUCERS = {
    "sum": np.add,
    "min": np.minimum,
    "max": np.maximum,
    "prod": np.multiply,
}

#: public set of supported reduce-op names (consumed by the collective
#: engine; keep in sync with _OP_CODES / reduce.cpp)
REDUCE_OPS = frozenset(_NP_REDUCERS)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def _cxx_flags() -> list:
    march = os.environ.get("KF_NATIVE_MARCH")
    arch = f"-march={march}" if march else "-mtune=generic"
    return ["-O3", arch, "-fPIC", "-pthread", "-std=c++17", "-Wall",
            "-Wextra", "-shared"]


def _stamp(cxx: str, flags: list) -> str:
    h = hashlib.sha256(" ".join([cxx] + flags).encode())
    for src in SOURCES:
        with open(os.path.join(_HERE, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build() -> bool:
    """Build ``_build/libkfnative.so`` unless its stamp is current; True
    when a current library is there afterwards."""
    cxx = os.environ.get("CXX", "g++")
    flags = _cxx_flags()
    os.makedirs(BUILD_DIR, exist_ok=True)
    stamp_path = os.path.join(BUILD_DIR, ".buildflags")
    try:
        want = _stamp(cxx, flags)
        with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lockf:
            # racing builders wait here for the winner's rename
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                try:
                    with open(stamp_path) as f:
                        have = f.read()
                except OSError:
                    have = ""
                if have == want and os.path.exists(lib_path()):
                    return True
                tmp = f"{lib_path()}.tmp.{os.getpid()}"
                subprocess.run(
                    [cxx, *flags, *(os.path.join(_HERE, s) for s in SOURCES),
                     "-o", tmp],
                    check=True, capture_output=True, timeout=300)
                os.replace(tmp, lib_path())
                with open(stamp_path + ".tmp", "w") as f:
                    f.write(want)
                os.replace(stamp_path + ".tmp", stamp_path)
                return True
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first call; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:  # lock-free fast path: per-chunk callers
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("KF_TPU_NO_NATIVE") == "1":
            return None
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(lib_path())
        except OSError:
            return None
        lib.kf_transform2.restype = ctypes.c_int
        lib.kf_transform2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def as_tensor(x) -> torch.Tensor:
    """A CPU tensor viewing ``x`` (a tensor, or a numpy array, whose
    bfloat16 of ml_dtypes becomes ``torch.bfloat16``), no copy."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def np_view(t: torch.Tensor) -> np.ndarray:
    """The numpy array sharing ``t``'s memory; a bfloat16 tensor as its
    16-bit patterns (``uint16``)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _narrow_nan(f32: np.ndarray, bits: np.ndarray, nan_bits: np.ndarray):
    nan = np.isnan(f32)
    if nan.any():
        bits[nan] = nan_bits[nan]


@np.errstate(all="ignore")  # NaN and overflow are results here
def _fallback(d: np.ndarray, s: np.ndarray, code: Optional[int],
              op: str) -> None:
    reducer = _NP_REDUCERS[op]
    if code == 8:  # f16: widen, reduce in f32, narrow (reduce.cpp run_16)
        a = d.view(np.float16).astype(np.float32)
        reducer(a, s.view(np.float16).astype(np.float32), out=a)
        out = a.astype(np.float16).view(np.uint16)
        sign = (a.view(np.uint32) >> 16).astype(np.uint16) & 0x8000
        _narrow_nan(a, out, sign | 0x7E00)
        d.view(np.uint16)[...] = out
    elif code == 11:  # bf16: f32_to_bf16_branchless
        a = (d.astype(np.uint32) << 16).view(np.float32)
        reducer(a, (s.astype(np.uint32) << 16).view(np.float32), out=a)
        u = a.view(np.uint32)
        out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
        _narrow_nan(a, out, (u >> 16).astype(np.uint16) | 0x40)
        d[...] = out
    else:
        reducer(d, s, out=d)


def transform2(dst, src, op: str):
    """dst <- dst OP src in place (reference ``transform2``, ``Transform2``
    of ``base/op.go:19-36``); buffers of one shape and dtype.  Returns
    ``dst``.  A dtype without a code (bool, complex) or a non-contiguous
    buffer takes the numpy fallback, as in the reference."""
    dt, st = as_tensor(dst), as_tensor(src)
    if dt.shape != st.shape or dt.dtype != st.dtype:
        raise ValueError(f"shape/dtype mismatch {tuple(dt.shape)}/{dt.dtype} "
                         f"vs {tuple(st.shape)}/{st.dtype}")
    lib = load()
    code = _DTYPE_CODES.get(dt.dtype)
    if (lib is not None and code is not None and dt.is_contiguous()
            and st.is_contiguous() and op in _OP_CODES):
        rc = lib.kf_transform2(dt.data_ptr(), st.data_ptr(), dt.numel(), code,
                               _OP_CODES[op])
        if rc == 0:
            return dst
    _fallback(np_view(dt), np_view(st), code, op)
    return dst
