"""The runtime singleton: rank, size and resize (port of
``kungfu_tpu/python/__init__.py``).

A process-wide default :class:`~kungfu_tpu_torch.peer.Peer` made from
the env bootstrap contract, behind ``current_rank``/``cluster_size``/
``local_rank``/``local_size``, ``uid``, ``detached``, ``run_barrier``,
``propose_new_size`` and ``resize``.  Nothing starts at import: the
peer starts at :func:`init` (explicit, or at the first call).
"""

from __future__ import annotations

import threading
from typing import Optional

_default_peer = None
_lock = threading.RLock()


def init(config=None, devices=None):
    """Make (or return) the process-wide default peer; ``devices`` are
    its communicator's (None: the card)."""
    global _default_peer
    with _lock:
        if _default_peer is None:
            from kungfu_tpu_torch.peer import Peer

            peer = Peer(config=config, devices=devices)
            peer.start()
            _default_peer = peer
        return _default_peer


def finalize():
    global _default_peer
    with _lock:
        if _default_peer is not None:
            _default_peer.close()
            _default_peer = None


def _peer():
    return init()


def uid() -> int:
    """``(cluster_version << 32) | rank``."""
    p = _peer()
    return (p.cluster_version << 32) | p.rank()


def current_rank() -> int:
    return _peer().rank()


def cluster_size() -> int:
    return _peer().size()


def current_local_rank() -> int:
    return _peer().local_rank()


def current_local_size() -> int:
    return _peer().local_size()


def detached() -> bool:
    return _peer().detached


def run_barrier() -> None:
    _peer().barrier()


def propose_new_size(new_size: int) -> None:
    _peer().propose_new_size(new_size)


def resize(n: Optional[int] = None) -> bool:
    """Resize the cluster; True when the membership changed.  ``n=None``
    takes the target from the config server."""
    p = _peer()
    if n is None:
        return p.resize_cluster_from_url()
    return p.resize_cluster(n)


def current_communicator():
    """The active :class:`~kungfu_tpu_torch.comm.device.Communicator`."""
    return _peer().communicator()
