"""Single-machine multi-process launch without the CLI (port of
``kungfu_tpu/runner/mp.py``).

Parity with the reference's ``launch_multiprocess(f, np)``
(``kungfu/cmd/__init__.py:43-47``) + its ``SingleMachineEnv``
(``env/config.go:59``): spawn N worker processes on localhost, each with
the ``KF_*`` bootstrap contract set, running ``fn(rank, size)`` — the
programmatic alternative to ``kfrun`` for tests and notebooks.

Where the port differs (ROADMAP C24): workers run on the card by
default (``backend="gpu"``), since N processes share one H100;
``backend="cpu"`` stamps ``KF_JAX_PLATFORM=cpu``, the host.  Collectives
between the processes ride the host-plane engine either way.  The
``spawn`` start method is always used: a forked child cannot initialise
CUDA again.
"""

from __future__ import annotations

import errno
import multiprocessing as mp
import os
import socket
import time
from typing import Callable, Optional, Sequence

#: child exit code marking "my cluster port was stolen between the
#: parent's probe and my bind" — the one failure the parent retries
_PORT_RACE_EXIT = 97


def _free_ports(n: int) -> list:
    """Kernel-assigned ephemeral ports, held open together so concurrent
    launches get disjoint sets.  The close→child-bind window is still a
    TOCTOU against unrelated processes; a child losing that race exits
    with ``_PORT_RACE_EXIT`` and the parent retries with fresh ports."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _mp_entry(rank: int, ports: Sequence[int], backend: str, fn, args,
              kwargs):
    from kungfu_tpu_torch.utils import envs

    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    os.environ[envs.SELF_SPEC] = f"127.0.0.1:{ports[rank]}"
    os.environ[envs.INIT_PEERS] = peers
    if backend == "cpu":  # see the module docstring
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        os.environ.setdefault(envs.JAX_PLATFORM, "cpu")
    try:
        fn(rank, len(ports), *args, **(kwargs or {}))
    except OSError as e:
        if e.errno == errno.EADDRINUSE:
            raise SystemExit(_PORT_RACE_EXIT)
        raise


def _stop_all(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        if p.is_alive():
            p.join(5)
            if p.is_alive():  # SIGTERM ignored/masked: escalate
                p.kill()
                p.join(5)


def launch_multiprocess(fn: Callable, np_: int, *args,
                        timeout: Optional[float] = None, backend: str = "gpu",
                        **kwargs) -> None:
    """Run ``fn(rank, size, *args, **kwargs)`` in ``np_`` spawned
    processes forming one localhost cluster, on the card (``backend``
    ``"gpu"``) or on the host (``"cpu"``).

    Fail-fast: the first worker that exits non-zero (or a shared
    ``timeout`` deadline expiring) terminates the rest — survivors
    blocked in a collective waiting for the dead peer must not hang the
    launcher.  Raises ``RuntimeError`` on any failure.  A worker that
    loses the ephemeral-port race retries the whole launch once with
    fresh ports (note: ranks that had already started may run twice).

    Uses the ``spawn`` start method: a forked child cannot initialise
    CUDA again.
    """
    if np_ < 1:
        raise ValueError("np_ must be >= 1")
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"backend {backend!r}, one of ('gpu', 'cpu')")
    for attempt in (0, 1):
        ports = _free_ports(np_)
        ctx = mp.get_context("spawn")
        procs = [
            ctx.Process(target=_mp_entry,
                        args=(r, ports, backend, fn, args, kwargs))
            for r in range(np_)
        ]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        failure = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = next((c for c in codes if c not in (None, 0)), None)
                if bad is not None:
                    failure = f"worker exited with code {bad}"
                    break
                if all(c == 0 for c in codes):
                    return  # every worker finished cleanly
                if deadline is not None and time.monotonic() > deadline:
                    failure = f"worker timed out after {timeout}s"
                    break
                time.sleep(0.05)
        finally:
            _stop_all(procs)
        if (attempt == 0
                and any(p.exitcode == _PORT_RACE_EXIT for p in procs)):
            continue  # stolen port: one retry with fresh ports
        raise RuntimeError(f"launch_multiprocess: {failure}")
