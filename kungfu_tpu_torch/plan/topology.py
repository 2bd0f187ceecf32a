"""Communication-graph generators.

Copy of ``kungfu_tpu/plan/topology.py``.

Parity with reference ``srcs/go/plan/topology.go`` + ``plan/subgraph``:
star, tree, binary tree, binary-tree-star (binary trees within each host,
star across hosts), their multi-root rotated families, and ring pairs.

Every generator returns ``(reduce_graph, broadcast_graph)`` pairs or a
broadcast tree from which the reduce tree is derived by reversal + self
loops (reference ``topology.go:33``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from kungfu_tpu_torch.plan.graph import Graph

GraphPair = Tuple[Graph, Graph]  # (reduce, broadcast)


def gen_default_reduce_graph(bcast: Graph) -> Graph:
    """Reduce tree = reversed broadcast tree with self-loops on every node
    (each node contributes its own buffer)."""
    g = bcast.reverse()
    for i in range(len(g)):
        g.add_self_loop(i)
    return g


def _pair(bcast: Graph) -> GraphPair:
    return gen_default_reduce_graph(bcast), bcast


def gen_star(n: int, center: int = 0) -> GraphPair:
    """Everyone exchanges with ``center``."""
    b = Graph(n)
    b.add_self_loop(center)
    for i in range(n):
        if i != center:
            b.add_edge(center, i)
    return _pair(b)


def gen_tree(n: int, host_ranks: Sequence[Sequence[int]] = None) -> GraphPair:
    """Host-aware tree (reference ``topology.go:17-31`` GenTree): a star
    from each host's local master to its local ranks, plus a star over the
    masters centered at the first.  Without host info, degenerates to a
    flat star at rank 0 (single-host case)."""
    if not host_ranks:
        host_ranks = [list(range(n))]
    b = Graph(n)
    masters: List[int] = []
    for ranks in host_ranks:
        if not ranks:
            continue
        masters.append(ranks[0])
        for r in ranks[1:]:
            b.add_edge(ranks[0], r)
    if masters:
        b.add_self_loop(masters[0])
        for m in masters[1:]:
            b.add_edge(masters[0], m)
    return _pair(b)


def gen_binary_tree(n: int, ranks: Sequence[int] = None) -> GraphPair:
    """Binary tree over ``ranks`` (default 0..n-1), heap-shaped."""
    if ranks is None:
        ranks = list(range(n))
    b = Graph(n)
    if ranks:
        b.add_self_loop(ranks[0])
    for idx in range(1, len(ranks)):
        b.add_edge(ranks[(idx - 1) // 2], ranks[idx])
    return _pair(b)


def gen_binary_tree_star(n: int, host_ranks: Sequence[Sequence[int]]) -> GraphPair:
    """The reference default strategy (``topology.go:76-105``): a binary tree
    within each host's ranks; local roots form a star across hosts centered
    on the first host's root."""
    b = Graph(n)
    roots: List[int] = []
    for ranks in host_ranks:
        if not ranks:
            continue
        roots.append(ranks[0])
        for idx in range(1, len(ranks)):
            b.add_edge(ranks[(idx - 1) // 2], ranks[idx])
    if roots:
        b.add_self_loop(roots[0])
        for r in roots[1:]:
            b.add_edge(roots[0], r)
    return _pair(b)


def gen_multi_binary_tree_star(n: int, host_ranks: Sequence[Sequence[int]]) -> List[GraphPair]:
    """One binary-tree-star per host, each rotated to center on a different
    host — chunks are spread across the pairs to use all NICs
    (``topology.go:107``)."""
    hosts = [h for h in host_ranks if h]
    k = max(1, len(hosts))
    pairs: List[GraphPair] = []
    for shift in range(k):
        rotated = list(hosts[shift:]) + list(hosts[:shift])
        pairs.append(gen_binary_tree_star(n, rotated))
    return pairs


def gen_multi_star(n: int, host_ranks: Sequence[Sequence[int]] = None) -> List[GraphPair]:
    """Host-aware multi-star (reference ``topology.go:117-125`` GenMultiStar
    + ``genMultiStar``): within each host a star from the local master to
    its ranks; across hosts a star over the masters — one graph pair per
    master rotation, so chunks spread the cross-host load over every
    host's NIC.  Without host info, one host is assumed (pure local star,
    single pair)."""
    if not host_ranks:
        host_ranks = [list(range(n))]
    hosts = [list(h) for h in host_ranks if h]
    masters = [h[0] for h in hosts]
    pairs: List[GraphPair] = []
    for root_idx in range(max(1, len(masters))):
        b = Graph(n)
        for ranks in hosts:
            for r in ranks[1:]:
                b.add_edge(ranks[0], r)
        if masters:
            center = masters[root_idx % len(masters)]
            b.add_self_loop(center)
            for m in masters:
                if m != center:
                    b.add_edge(center, m)
        pairs.append(_pair(b))
    return pairs


def gen_circular_graph_pair(n: int, ranks: Sequence[int] = None, shift: int = 0) -> GraphPair:
    """Ring: reduce flows around the ring accumulating, broadcast flows the
    result back around (``topology.go:149-160``).  ``shift`` rotates the
    ring start so multiple rings spread load."""
    if ranks is None:
        ranks = list(range(n))
    k = len(ranks)
    ring = [ranks[(i + shift) % k] for i in range(k)]
    reduce_g = Graph(n)
    bcast_g = Graph(n)
    for i in range(k):
        reduce_g.add_self_loop(ring[i])
        if i + 1 < k:
            reduce_g.add_edge(ring[i], ring[i + 1])
    # result lands at ring[-1]; broadcast back down the ring
    bcast_g.add_self_loop(ring[-1])
    for i in range(k - 1, 0, -1):
        bcast_g.add_edge(ring[i], ring[i - 1])
    return reduce_g, bcast_g


def gen_clique(n: int) -> List[GraphPair]:
    """All-to-all: n stars, one centered at each rank — the CLIQUE strategy
    (reference ``topology.go:136-147``)."""
    return [gen_star(n, center=c) for c in range(n)]


def gen_cross_ring_pairs(n: int, masters: Sequence[int]) -> List[GraphPair]:
    """Ring rotations over the local-master subset for the cross-host
    stage of hierarchical allreduce (reference
    ``subgraph.go:5-17`` + ``session/strategy.go:188-196``): one ring pair
    per rotation; every non-master node is untouched (no self-loop)."""
    return [
        gen_circular_graph_pair(n, ranks=list(masters), shift=r)
        for r in range(max(1, len(masters)))
    ]


def gen_cross_binary_tree(n: int, masters: Sequence[int]) -> List[GraphPair]:
    """Binary tree over the local-master subset (reference
    ``subgraph.go:19-31`` + ``strategy.go:198-202``), reduce graph with
    self-loops on the masters only so non-participants stay inert."""
    ms = list(masters)
    b = Graph(n)
    for i in range(len(ms)):
        for j in (2 * i + 1, 2 * i + 2):
            if j < len(ms):
                b.add_edge(ms[i], ms[j])
    r = b.reverse()
    for m in ms:
        r.add_self_loop(m)
    return [(r, b)]
