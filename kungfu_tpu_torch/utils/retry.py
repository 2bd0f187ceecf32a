"""Bounded, jittered retry and backoff (trimmed copy of
``kungfu_tpu/utils/retry.py``).

Every network retry loop bounds its attempts and backs off with jitter
between them, so a cluster retrying one dead endpoint does not retry in
lockstep.  ``backoff_delay`` is capped exponential backoff with
half-to-full jitter: the delay of attempt ``k`` is uniform in
``[cap_k/2, cap_k)`` with ``cap_k = min(cap, base * 2**k)``.
``jittered`` keeps a fixed mean period and only spreads the callers, for
poll loops whose total duration is part of a contract (the connect
ladder's 500 x 200 ms window).
"""

from __future__ import annotations

import random
import time
from typing import Optional

#: exponent clamp, so a caller looping hundreds of times cannot overflow
_MAX_EXP = 16


def backoff_delay(attempt: int, base: float = 0.2, cap: float = 2.0,
                  rng: Optional[random.Random] = None) -> float:
    """Delay in seconds for 0-based ``attempt``: capped exponential with
    half-to-full jitter."""
    r = (rng or random).random()
    return min(cap, base * (2 ** min(max(attempt, 0), _MAX_EXP))) * (0.5 + 0.5 * r)


def sleep_backoff(attempt: int, base: float = 0.2, cap: float = 2.0,
                  rng: Optional[random.Random] = None) -> float:
    """Sleep :func:`backoff_delay`; returns the slept delay."""
    d = backoff_delay(attempt, base, cap, rng)
    time.sleep(d)
    return d


def jittered(period: float, rng: Optional[random.Random] = None) -> float:
    """``period`` spread uniformly over ``[period/2, 3*period/2)``: the
    mean is kept, concurrent retriers decorrelate."""
    r = (rng or random).random()
    return period * (0.5 + r)
