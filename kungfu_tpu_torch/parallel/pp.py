"""Pipeline geometry: stage partitions and microbatch schedules.

Port of the pure-Python half of ``kungfu_tpu/parallel/pp.py`` (its
``:65-215``): the contiguous layer range of each stage
(:func:`stage_partition`), the non-adjacent chunks of the interleaved
schedule (:func:`interleaved_partition`), and the per-stage op lists of
the three schedules (:func:`schedule_1f1b`, :func:`schedule_sequential`,
:func:`schedule_interleaved`, dispatched by :func:`build_schedule`).
:class:`~kungfu_tpu_torch.parallel.train.ParallelPlan` reads them.  The
cross-host pipeline that runs these schedules over the host plane
(``StageModule``, ``StageBoundary``, ``HostPipeline``) is not ported
yet (ROADMAP A4b).
"""

from __future__ import annotations

from typing import List, Tuple

#: schedule vocabulary (KF_PP_SCHEDULE / ParallelPlan.pp_schedule)
SCHEDULES = ("1f1b", "interleaved", "sequential")


def stage_partition(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` layer range per stage, balanced with the
    remainder spread over the EARLIEST stages (they do not carry the
    LM-head loss work).  Pure and deterministic — every rank computes
    the identical map, like ``reshard_plan``."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers < n_stages:
        raise ValueError(
            f"{n_layers} layers cannot fill {n_stages} stages "
            "(a stage with no layers would forward its input unchanged "
            "— shrink the stage count instead)")
    base, rem = divmod(n_layers, n_stages)
    out, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def interleaved_partition(n_layers: int, n_stages: int,
                          v: int) -> List[List[Tuple[int, int]]]:
    """Layer ranges for the interleaved schedule: ``n_stages * v``
    contiguous groups; stage ``s`` owns groups ``[s, s + S, s + 2S, …]``
    (chunk ``c`` of stage ``s`` is virtual stage ``c * S + s``).
    Returns ``[stage][chunk] -> (lo, hi)``."""
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    groups = stage_partition(n_layers, n_stages * v)
    return [[groups[c * n_stages + s] for c in range(v)]
            for s in range(n_stages)]


def schedule_1f1b(n_micro: int, n_stages: int, stage: int
                  ) -> List[Tuple[str, int, int]]:
    """The classic one-forward-one-backward op list for ``stage``:
    ``[(kind, microbatch, chunk=0)]`` with kinds ``"F"``/``"B"``.
    Warmup ``min(S - 1 - stage, m)`` forwards, steady-state F/B pairs,
    backward drain.  Backwards retire in microbatch order on every
    stage — the property that keeps gradient accumulation bitwise
    against the sequential reference."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} outside {n_stages} stages")
    warm = min(n_stages - 1 - stage, n_micro)
    ops: List[Tuple[str, int, int]] = []
    for m in range(warm):
        ops.append(("F", m, 0))
    for k in range(n_micro - warm):
        ops.append(("F", warm + k, 0))
        ops.append(("B", k, 0))
    for m in range(n_micro - warm, n_micro):
        ops.append(("B", m, 0))
    return ops


def schedule_sequential(n_micro: int, n_stages: int, stage: int
                        ) -> List[Tuple[str, int, int]]:
    """Naive sequential microbatching — each microbatch runs its full
    forward AND backward through the whole pipe before the next starts,
    so every DCN hop sits on the critical path.  The baseline the
    ``bench.py --pp`` gate measures 1F1B against."""
    del n_stages, stage
    ops: List[Tuple[str, int, int]] = []
    for m in range(n_micro):
        ops.append(("F", m, 0))
        ops.append(("B", m, 0))
    return ops


def schedule_interleaved(n_micro: int, n_stages: int, stage: int,
                         v: int) -> List[Tuple[str, int, int]]:
    """Interleaved (virtual-stage) schedule: stage ``s`` executes ops
    for its ``v`` chunks, ordered by a greedy global simulation of the
    ``S*v``-virtual-stage dependency DAG (each physical stage runs one
    ready op per tick, preferring backwards — the 1F1B shape emerges).
    Simulated, not formula'd: the op order is then consistent with a
    valid global schedule by construction, so the blocking recvs of a
    real run can never deadlock, for any ``(m, S, v)``."""
    if v == 1:
        return schedule_1f1b(n_micro, n_stages, stage)
    V = n_stages * v
    f_done = [[False] * n_micro for _ in range(V)]
    b_done = [[False] * n_micro for _ in range(V)]
    per_stage: List[List[Tuple[str, int, int]]] = [
        [] for _ in range(n_stages)]
    remaining = 2 * V * n_micro

    def ready(phys: int):
        """Best ready op for a physical stage: prefer B (drain memory),
        then the lowest (chunk, microbatch) F — deterministic.  Both
        kinds advance strictly in microbatch order per chunk, so
        gradient accumulation order matches the sequential reference
        (the bitwise contract)."""
        best = None
        for c in range(v):
            vs = c * n_stages + phys
            mb_b = next((m for m in range(n_micro)
                         if not b_done[vs][m]), None)
            if mb_b is not None and f_done[vs][mb_b] and (
                    vs == V - 1 or b_done[vs + 1][mb_b]):
                return ("B", mb_b, c)
            if best is None:
                mb_f = next((m for m in range(n_micro)
                             if not f_done[vs][m]), None)
                if mb_f is not None and (
                        vs == 0 or f_done[vs - 1][mb_f]):
                    best = ("F", mb_f, c)
        return best

    while remaining:
        progressed = False
        for phys in range(n_stages):
            op = ready(phys)
            if op is None:
                continue
            kind, m, c = op
            vs = c * n_stages + phys
            (f_done if kind == "F" else b_done)[vs][m] = True
            per_stage[phys].append(op)
            remaining -= 1
            progressed = True
        if not progressed:  # pragma: no cover - the DAG always has a root
            raise AssertionError("interleaved schedule wedged")
    return per_stage[stage]


def build_schedule(name: str, n_micro: int, n_stages: int, stage: int,
                   v: int = 1) -> List[Tuple[str, int, int]]:
    if name not in SCHEDULES:
        raise ValueError(f"unknown pp schedule {name!r}; one of {SCHEDULES}")
    if name == "interleaved":
        return schedule_interleaved(n_micro, n_stages, stage, v)
    if name == "sequential":
        return schedule_sequential(n_micro, n_stages, stage)
    if v != 1:
        raise ValueError("interleave > 1 requires the interleaved schedule")
    return schedule_1f1b(n_micro, n_stages, stage)
