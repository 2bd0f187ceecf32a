"""Adaptation signals: peer latencies, the latency MST, interference votes.

Copy of ``kungfu_tpu/monitor/adapt.py``:

* :func:`get_peer_latencies` — ping round-trip times to every peer
  (reference ``session/monitoring.go:38-64``);
* :func:`latency_matrix` and :func:`minimum_spanning_tree_from_latencies`
  — allgather the latency rows, run Prim's MST; :func:`set_tree`
  installs the tree on the host engine (``topology.cpp:84-151`` +
  ``adaptation.cpp``);
* :func:`check_interference` and :func:`majority_vote_interference` —
  per-strategy throughput under 0.8 of its best, voted across the
  cluster (``session/strategy.go:17-56``,
  ``adaptiveStrategies.go:13-121``).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.mst import minimum_spanning_tree
from kungfu_tpu_torch.plan.topology import gen_default_reduce_graph
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("adapt")

INTERFERENCE_THRESHOLD = 0.8  # reference adaptiveStrategies.go


def get_peer_latencies(peer, samples: int = 1) -> List[float]:
    """Ping RTT (seconds) from this peer to every worker: 0.0 for itself,
    +inf for a peer that does not answer (an unreachable peer must look
    infinitely expensive to the MST, not free).  The best of ``samples``
    pings; two timeouts with no success end the probe of that peer."""
    from kungfu_tpu_torch.chaos import controller_for

    channel = peer.channel
    chaos = controller_for(peer.chaos_rank())
    out: List[float] = []
    for rank, target in enumerate(peer.cluster.workers):
        if channel is None or target == peer.config.self_id:
            out.append(0.0)
            continue
        best, fails = None, 0
        for _ in range(samples):
            t0 = time.perf_counter()
            if chaos is not None:
                # delay:on=ping inside the timed window: an injected slow
                # link must inflate the RTT the MST reads
                chaos.on_ping(rank)
            if channel.ping(target, timeout=5.0):
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            else:
                fails += 1
                if best is None and fails >= 2:
                    break
        out.append(best if best is not None else float("inf"))
    return out


def latency_matrix(peer, samples: int = 1) -> np.ndarray:
    """Every peer's latency row, allgathered into the ``(n, n)`` matrix."""
    row = np.asarray(get_peer_latencies(peer, samples), dtype=np.float64)
    channel, workers = peer.channel, peer.cluster.workers
    if channel is None:
        return row[None, :]
    rows = channel.allgather_bytes(row.tobytes(), workers,
                                   name=f"lat.v{peer.cluster_version}")
    return np.stack([np.frombuffer(r, dtype=np.float64) for r in rows])


def minimum_spanning_tree_from_latencies(peer, samples: int = 1) -> List[int]:
    """Measured latencies to a forest array (the MinimumSpanningTree op)."""
    return minimum_spanning_tree(latency_matrix(peer, samples))


def set_tree(engine, forest: List[int]) -> None:
    """Install an explicit broadcast tree on the engine (reference
    ``SetTree``, ``adaptation.cpp:5``).  The caller runs the
    cluster-wide consensus and barrier around it
    (:meth:`kungfu_tpu_torch.peer.Peer.set_tree`)."""
    bcast = Graph.from_forest_array(forest)
    reduce_g = gen_default_reduce_graph(bcast)
    with engine._stats_lock:
        engine._graphs = [(reduce_g, bcast)]
        engine.stats = [[0, 0.0]]
        engine._window = [[0, 0.0]]
        engine.best_throughputs = [0.0]
        # the install is a swap: a fresh eligibility epoch
        engine._colls_at_swap = engine._colls_total
    # the C++ executor's serialized graphs are stale
    engine._graph_ser.clear()
    engine.strategy = None
    _log.info("installed explicit tree %s", forest)


def check_interference(
    engine,
    reference_throughputs: Optional[List[float]] = None,
    threshold: float = INTERFERENCE_THRESHOLD,
) -> List[int]:
    """This rank's suspicion: the strategy pairs whose recent-window
    throughput fell under ``threshold`` times their recorded best."""
    tp = engine.throughputs()  # recent window; updates best_throughputs
    ref = reference_throughputs or engine.best_throughputs
    return [
        i for i, (t, r) in enumerate(zip(tp, ref))
        if r > 0 and t > 0 and t < threshold * r
    ]


def majority_vote_interference(peer, suspected: bool) -> bool:
    """The cluster's majority over the ranks' suspicion flags."""
    engine = peer.engine()
    if engine is None:
        return suspected
    # record=False: the 8-byte vote must not land in the throughput
    # window it judges
    votes = engine.all_reduce(
        np.array([1 if suspected else 0], np.int64), op="sum", record=False)
    return int(votes[0]) * 2 > peer.size()
