"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel source under ``csrc/`` has a plain C launcher (device
pointers, sizes, the caller's stream), so it compiles in seconds without
PyTorch's headers.  The library lands in ``_build/`` beside this file
(listed in ``.gitignore``), named by a hash of the sources and the
flags: an edited ``.cu`` rebuilds, an unchanged one loads the earlier
build.  Nothing builds at import; the kernel's wrapper builds at first
use, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("cuda-build")

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
#: keep the ``a``: sm_90a is the target with Hopper's wgmma/setmaxnreg
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: -Xptxas -v prints each kernel's registers, shared memory and spills
FLAGS = ("-O3", "-std=c++17", "--shared", "-Xcompiler", "-fPIC",
         "-lineinfo", "-Xptxas", "-v")


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    #: wall seconds nvcc took in this process; 0.0 when an earlier build
    #: with the same hash was loaded
    seconds: float
    #: nvcc's output (the -Xptxas -v resource report), kept beside the
    #: library when it was built and read back when it is loaded
    log: str


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
    toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build from source at first use")


def _source_key(source: Path, nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + FLAGS + ARCH_FLAGS).encode())
    # headers included by the source are hashed too
    for p in sorted(CSRC.glob("*.cuh")) + [source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(source: str) -> Built:
    """Compile ``csrc/<source>`` into ``lib<stem>-<hash>.so`` (unless that
    build exists) and load it.  Concurrent processes serialise on a lock
    file; the library is renamed into place only when complete, after
    nvcc's report (``.log`` beside it)."""
    src = CSRC / source
    nvcc = nvcc_path()
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{src.stem}-{_source_key(src, nvcc)}.so"
    seconds, log = 0.0, ""
    with open(out_dir / f"{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = [nvcc, *FLAGS, *ARCH_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}: "
                    f"{' '.join(cmd)}\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            _log.info("built %s with nvcc in %.1f s", out.name, seconds)
        else:
            log_path = out.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
