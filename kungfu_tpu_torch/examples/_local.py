"""What the in-process examples share: a scoped environment, a cluster
of peers in this process and a lockstep run of one function a rank on
threads.

The reference's in-process demos set ``KF_CHAOS_SPEC`` and the engine's
knobs at module top, before any import of the package reads them.  The
port's examples set them inside ``main()`` with :func:`scoped_env` and
put every value back on exit, so importing an example changes nothing
(a test process imports every module of the port).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence


@contextmanager
def scoped_env(force: Optional[Dict[str, str]] = None,
               default: Optional[Dict[str, str]] = None):
    """``force`` set and ``default`` set where unset in ``os.environ``
    for the block, every touched name restored after.  The chaos
    controllers are cached per spec, so they are dropped on entry and
    on exit: a spec armed here fires here only."""
    from kungfu_tpu_torch import chaos

    force, default = dict(force or {}), dict(default or {})
    saved = {k: os.environ.get(k) for k in (*force, *default)}
    os.environ.update(force)
    for k, v in default.items():
        os.environ.setdefault(k, v)
    chaos.reset()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        chaos.reset()


def local_peers(n: int, base_port: int = 0,
                env: Optional[Dict[str, str]] = None,
                devices: Optional[Sequence] = None,
                host: str = "127.0.0.1") -> list:
    """``n`` started peers of one cluster in this process.  ``base_port``
    0 takes ports found free (the whole cluster retried on a race,
    :func:`~kungfu_tpu_torch.peer.start_local_cluster`); another value
    puts worker ``r`` on ``base_port + r``, as the reference's demos
    do."""
    from kungfu_tpu_torch.peer import Peer, start_local_cluster
    from kungfu_tpu_torch.utils import envs

    if not base_port:
        return start_local_cluster(n, env=env, devices=devices, host=host)
    ports = [base_port + r for r in range(n)]
    peers: List[Peer] = []
    try:
        for r in range(n):
            cfg = envs.parse_config_from_env(
                {**envs.single_machine_env(r, n, host, ports=ports),
                 **(env or {})})
            peers.append(Peer(cfg, devices=devices))
            peers[-1].start()
    except BaseException:
        close_all(peers)
        raise
    return peers


def close_all(peers) -> None:
    """Close every peer; a victim of a chaos kill is already down."""
    for p in peers:
        try:
            p.close()
        except Exception:  # noqa: BLE001 - the victim closed itself
            pass


def run_world(fns: Sequence[Callable], timeout: float = 120.0) -> list:
    """Run ``fns`` one a thread, together; their results in order.  The
    first error is raised again here, and a thread still running at
    ``timeout`` raises ``TimeoutError``."""
    outs: list = [None] * len(fns)
    errs: list = []

    def wrap(i, f):
        try:
            outs[i] = f()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i, f), daemon=True)
          for i, f in enumerate(fns)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + timeout
    for t in ts:
        t.join(max(0.0, deadline - time.monotonic()))
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        raise TimeoutError("demo cluster hung")
    return outs
