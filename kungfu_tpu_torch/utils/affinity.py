"""CPU affinity for the workers of one host (copy of
``kungfu_tpu/utils/affinity.py``): with ``KF_CONFIG_USE_AFFINITY`` set,
each local rank is pinned to an even, contiguous share of the CPUs the
process may use, so co-located workers' host threads (the engine's
reducers, the input pipeline) do not migrate across each other's cores.
"""

from __future__ import annotations

import os
from typing import List, Optional

from kungfu_tpu_torch.utils.envs import USE_AFFINITY
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("affinity")


def affinity_enabled() -> bool:
    return os.environ.get(USE_AFFINITY, "").lower() in ("1", "true", "yes")


def partition_cpus(cpus: List[int], local_rank: int,
                   local_size: int) -> List[int]:
    """Even contiguous split of ``cpus``; lower ranks take the
    remainder."""
    if local_size <= 0:
        raise ValueError("local_size must be positive")
    if not 0 <= local_rank < local_size:
        raise ValueError(f"local_rank {local_rank} not in [0, {local_size})")
    cpus = sorted(cpus)
    base, extra = divmod(len(cpus), local_size)
    start = local_rank * base + min(local_rank, extra)
    size = base + (1 if local_rank < extra else 0)
    return cpus[start:start + size]


def bind_local_rank(local_rank: int, local_size: int, pid: int = 0,
                    force: bool = False) -> Optional[List[int]]:
    """Pin ``pid`` (default this process) to its local rank's CPU share.
    Returns the CPUs bound to, or None when off, unsupported, or the
    share would be empty."""
    if not (force or affinity_enabled()):
        return None
    if not hasattr(os, "sched_getaffinity"):  # pragma: no cover - non-Linux
        _log.warning("affinity unsupported on this platform")
        return None
    allowed = sorted(os.sched_getaffinity(pid))
    share = partition_cpus(allowed, local_rank, local_size)
    if not share:
        _log.warning("no CPUs for local rank %d/%d over %d allowed; leaving "
                     "unpinned", local_rank, local_size, len(allowed))
        return None
    os.sched_setaffinity(pid, share)
    _log.info("local rank %d/%d bound to CPUs %s", local_rank, local_size,
              share)
    return share
