"""Step-based resize schedules (copy of ``kungfu_tpu/elastic/
schedule.py``; reference ``StepBasedSchedule``,
``tensorflow/ops/cpu/elastic.cpp:16-82``).

A config string ``"size:steps,size:steps,..."`` maps training-step
ranges to cluster sizes: ``"1:100,2:100,4:200"`` is 100 steps at one
worker, 100 at two, 200 at four.  After the schedule ends, the last size
holds.
"""

from __future__ import annotations

from typing import List, Tuple


def parse_schedule(config: str) -> List[Tuple[int, int]]:
    """-> list of (size, steps); validates positivity."""
    out = []
    for part in config.split(","):
        part = part.strip()
        if not part:
            continue
        size_s, steps_s = part.split(":")
        size, steps = int(size_s), int(steps_s)
        if size <= 0 or steps <= 0:
            raise ValueError(f"invalid schedule entry {part!r}")
        out.append((size, steps))
    if not out:
        raise ValueError(f"empty schedule {config!r}")
    return out


def step_based_schedule(config: str, step: int) -> int:
    """Cluster size scheduled for ``step``."""
    sched = parse_schedule(config)
    off = 0
    for size, steps in sched:
        off += steps
        if step < off:
            return size
    return sched[-1][0]


def total_steps(config: str) -> int:
    return sum(steps for _, steps in parse_schedule(config))
