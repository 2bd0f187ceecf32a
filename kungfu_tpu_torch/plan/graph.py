"""Directed communication graphs.

Copy of ``kungfu_tpu/plan/graph.py``.

Capability parity with reference ``srcs/go/plan/graph/graph.go``: a digraph
where every node tracks a self-loop flag plus ordered predecessor/successor
lists, a compact forest-array codec (``f[i]`` = father of node ``i``) used to
ship trees between processes, reversal (a broadcast tree reversed is a reduce
tree), and a canonical digest for cross-process consensus.

Implementation is fresh: immutable-ish Python dataclasses over numpy arrays,
hashed with blake2b for digests.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence


@dataclass
class Node:
    rank: int
    self_loop: bool = False
    prevs: List[int] = field(default_factory=list)
    nexts: List[int] = field(default_factory=list)


class Graph:
    """A digraph over ranks ``0..n-1``."""

    def __init__(self, n: int):
        self.nodes: List[Node] = [Node(i) for i in range(n)]

    def __len__(self) -> int:
        return len(self.nodes)

    # -- construction ----------------------------------------------------
    def add_self_loop(self, i: int) -> None:
        self.nodes[i].self_loop = True

    def add_edge(self, i: int, j: int) -> None:
        """Directed edge i → j."""
        if i == j:
            self.add_self_loop(i)
            return
        self.nodes[i].nexts.append(j)
        self.nodes[j].prevs.append(i)

    # -- queries ---------------------------------------------------------
    def prevs(self, i: int) -> Sequence[int]:
        return tuple(self.nodes[i].prevs)

    def nexts(self, i: int) -> Sequence[int]:
        return tuple(self.nodes[i].nexts)

    def is_self_loop(self, i: int) -> bool:
        return self.nodes[i].self_loop

    def edges(self) -> List[tuple]:
        out = []
        for node in self.nodes:
            for j in node.nexts:
                out.append((node.rank, j))
        return out

    # -- transforms ------------------------------------------------------
    def reverse(self) -> "Graph":
        g = Graph(len(self))
        for node in self.nodes:
            if node.self_loop:
                g.add_self_loop(node.rank)
            for j in node.nexts:
                g.add_edge(j, node.rank)
        return g

    # -- forest-array codec ----------------------------------------------
    def to_forest_array(self) -> List[int]:
        """Encode a tree/forest as ``f[i] = father(i)`` (roots are their own
        father).  Only valid when every node has ≤1 predecessor."""
        f = []
        for node in self.nodes:
            if len(node.prevs) > 1:
                raise ValueError(f"node {node.rank} has {len(node.prevs)} fathers; not a forest")
            f.append(node.prevs[0] if node.prevs else node.rank)
        return f

    @classmethod
    def from_forest_array(cls, f: Sequence[int]) -> "Graph":
        n = len(f)
        g = cls(n)
        roots = 0
        for i, father in enumerate(f):
            if not 0 <= father < n:
                raise ValueError(f"father {father} of node {i} out of range [0,{n})")
            if father == i:
                roots += 1
                g.add_self_loop(i)
            else:
                g.add_edge(father, i)
        if roots == 0:
            raise ValueError("forest array has no root")
        g._assert_acyclic(f)
        return g

    @staticmethod
    def _assert_acyclic(f: Sequence[int]) -> None:
        n = len(f)
        for start in range(n):
            i, hops = start, 0
            while f[i] != i:
                i = f[i]
                hops += 1
                if hops > n:
                    raise ValueError("forest array contains a cycle")

    # -- consensus digest ------------------------------------------------
    def digest_bytes(self) -> bytes:
        """Canonical content hash — equal graphs (same edges, loops, order)
        hash equal across processes."""
        h = hashlib.blake2b(digest_size=16)
        h.update(len(self).to_bytes(4, "little"))
        for node in self.nodes:
            h.update(b"L" if node.self_loop else b"l")
            for j in node.nexts:
                h.update(j.to_bytes(4, "little"))
            h.update(b"|")
        return h.digest()

    def __eq__(self, other) -> bool:
        return isinstance(other, Graph) and self.digest_bytes() == other.digest_bytes()

    def __repr__(self) -> str:
        return f"Graph(n={len(self)}, edges={self.edges()})"


def merge_graphs(graphs: Iterable[Graph]) -> Graph:
    """Union of edge sets (used to combine reduce+broadcast pair views)."""
    graphs = list(graphs)
    n = len(graphs[0])
    out = Graph(n)
    seen = set()
    for g in graphs:
        for i in range(n):
            if g.is_self_loop(i):
                out.nodes[i].self_loop = True
            for j in g.nexts(i):
                if (i, j) not in seen:
                    seen.add((i, j))
                    out.add_edge(i, j)
    return out
