"""Slice topology: the worker-rank ↔ TPU-slice mapping for multislice jobs.

A multislice pod is a two-level world: chips within a slice talk over
ICI, slices talk over DCN — and *failures* follow the same grain.  A
slice that loses its DCN link, its coordinator, or power loses **all**
its hosts at once, and a slice that loses *some* of them cannot keep
training (its within-slice mesh is broken even though the surviving
hosts answer pings).  The elastic layer therefore needs a stable notion
of "which slice does worker rank r belong to", kept consistent across
membership changes:

* **Contract**: workers are slice-major contiguous — rank ``r`` lives in
  slice ``r // ranks_per_slice``.  This mirrors the mesh layout
  (the reference's ``platforms/tpu_pod.slice_mesh_layout`` flattens
  slice-major) and the launcher's spawn order (``kfrun`` assigns
  ``MEGASCALE_SLICE_ID = rank // ranks_per_slice`` in emulation; on a
  real pod each host's env already carries its slice id).
* **ranks_per_slice** is pinned by the launcher (``KF_SLICE_RANKS``) or
  derived once from the bootstrap membership (bootstrap size /
  ``MEGASCALE_NUM_SLICES``).  It never changes: elastic grow/shrink
  moves whole slices, so the CURRENT topology for an n-worker membership
  is simply ``n / ranks_per_slice`` slices (and a membership that does
  not divide is a bug the topology refuses to paper over).

Everything here is pure (no sockets, no devices): the shrink protocol,
the resize alignment, the chaos layer, and the tests all share it.

Copy of ``kungfu_tpu/elastic/slices.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from kungfu_tpu_torch.utils import envs

__all__ = [
    "SliceTopology",
    "bootstrap_topology",
    "align_to_slices",
    "slice_verdict",
    "slice_quorum_ok",
]


@dataclass(frozen=True)
class SliceTopology:
    """Rank→slice mapping for ONE membership epoch (``num_slices``
    slices of ``ranks_per_slice`` workers, slice-major contiguous)."""

    num_slices: int
    ranks_per_slice: int

    def __post_init__(self):
        if self.num_slices < 1 or self.ranks_per_slice < 1:
            raise ValueError(f"degenerate slice topology {self!r}")

    @property
    def size(self) -> int:
        return self.num_slices * self.ranks_per_slice

    def slice_of(self, rank: int) -> int:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside the {self.size}-rank world")
        return rank // self.ranks_per_slice

    def ranks_in(self, slice_id: int) -> List[int]:
        if not 0 <= slice_id < self.num_slices:
            raise ValueError(
                f"slice {slice_id} outside the {self.num_slices}-slice world")
        lo = slice_id * self.ranks_per_slice
        return list(range(lo, lo + self.ranks_per_slice))

    def leader_of(self, slice_id: int) -> int:
        """The slice's representative on the DCN control plane: its
        lowest rank (every member of a surviving slice is alive — a
        slice with any dead member is excluded whole, so the lowest
        rank is always available to lead)."""
        return self.ranks_in(slice_id)[0]

    def for_size(self, n: int) -> "SliceTopology":
        """The topology of an ``n``-worker membership under the SAME
        ranks-per-slice.  Raises when ``n`` is not whole slices — the
        elastic layer aligns every resize, so a misaligned membership
        means the alignment was bypassed."""
        if n % self.ranks_per_slice:
            raise ValueError(
                f"membership of {n} workers is not whole slices "
                f"({self.ranks_per_slice} ranks/slice) — slice-aligned "
                "elasticity was bypassed")
        return SliceTopology(n // self.ranks_per_slice, self.ranks_per_slice)


def bootstrap_topology(bootstrap_size: int,
                       env=None) -> Optional[SliceTopology]:
    """The job's slice topology from the launch contract, or ``None``
    for single-slice jobs (``MEGASCALE_NUM_SLICES`` unset/<=1) — the
    None path is the byte-identical today's-behavior path.

    ``ranks_per_slice`` comes from ``KF_SLICE_RANKS`` when the launcher
    pinned it (it must: late joiners' bootstrap worker list is the
    *current* cluster, not the original one) and otherwise derives from
    ``bootstrap_size / num_slices`` — failing loudly when the worker
    count does not tile the slices."""
    env = env if env is not None else os.environ
    num_slices = int(env.get(envs.MEGASCALE_NUM_SLICES, "0") or 0)
    if num_slices <= 1:
        return None
    rps_s = (env.get(envs.SLICE_RANKS, "") or "").strip()
    if rps_s:
        rps = int(rps_s)
        if rps < 1:
            raise ValueError(f"{envs.SLICE_RANKS}={rps} must be >= 1")
        return SliceTopology(num_slices, rps)
    if bootstrap_size % num_slices:
        raise ValueError(
            f"{envs.MEGASCALE_NUM_SLICES}={num_slices} does not tile the "
            f"{bootstrap_size}-worker bootstrap world — set "
            f"{envs.SLICE_RANKS} or fix the worker count")
    return SliceTopology(num_slices, bootstrap_size // num_slices)


def align_to_slices(new_size: int, topo: SliceTopology) -> int:
    """Clamp a proposed worker count to whole slices (nearest multiple
    of ``ranks_per_slice``, never below one slice).  Planned elasticity
    on a multislice pod grows and shrinks by slices: a fractional slice
    has no mesh to join (its chips cannot form the within-slice axis)."""
    rps = topo.ranks_per_slice
    # nearest multiple, ties rounding UP (a half-slice ask leans toward
    # capacity) — int arithmetic, not round(): banker's rounding would
    # make 5 workers on 2-rank slices align DOWN, surprising schedules
    aligned = max(rps, ((new_size + rps // 2) // rps) * rps)
    return int(aligned)


def slice_verdict(dead_ranks: Iterable[int],
                  topo: SliceTopology) -> Tuple[Set[int], Set[int]]:
    """``(dead_slices, degraded_slices)`` from a ping-confirmed dead
    rank set: ``dead_slices`` lost every member, ``degraded_slices``
    lost some but not all.  The shrink protocol excludes BOTH whole —
    a half-dead slice has live hosts but no within-slice mesh, and
    letting it "keep training" on a broken ICI domain is silent
    corruption, not fault tolerance."""
    dead_by_slice: dict = {}
    for r in dead_ranks:
        dead_by_slice.setdefault(topo.slice_of(r), set()).add(r)
    dead_slices, degraded = set(), set()
    for s, dr in dead_by_slice.items():
        if len(dr) >= topo.ranks_per_slice:
            dead_slices.add(s)
        else:
            degraded.add(s)
    return dead_slices, degraded


def slice_quorum_ok(surviving_slices: Sequence[int],
                    topo: SliceTopology) -> bool:
    """Quorum at slice granularity: a strict majority of slices must
    survive — OR exactly half, provided the survivors include the
    lowest slice id.  The tie-break is the piece rank-granular quorum
    cannot have: a partition splits the slice set into disjoint halves,
    and only ONE half can contain slice 0, so both sides deciding by
    this rule can never both continue (the split-brain strict majority
    exists to prevent).  It is what makes the canonical 2-slice pod's
    slice loss survivable at all — rank-granular strict majority would
    refuse exactly-half survivors and relaunch the world."""
    alive = set(surviving_slices)
    if 2 * len(alive) > topo.num_slices:
        return True
    return 2 * len(alive) == topo.num_slices and 0 in alive
