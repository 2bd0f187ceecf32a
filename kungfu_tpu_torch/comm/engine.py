"""Graph-driven collective engine over the host channel (port of
``kungfu_tpu/comm/engine.py``).

Collectives run by walking (reduce-graph, broadcast-graph) pairs generated
from the eight named strategies, with buffers **chunked** and each chunk
hashed onto a strategy pair (reference ``session.go:292-321``,
``shard.go:11-31``).  This is the host data plane: N ranks -- threads or
processes -- allreduce a host buffer over TCP or unix sockets, each
recording per-strategy throughput for the adaptation drivers.

When the channel is a :class:`~kungfu_tpu_torch.comm.host.NativeHostChannel`,
the dtype and op have native codes, ``KF_NATIVE_ENGINE`` is not ``0`` and
chaos is off, the whole chunked allreduce runs in the C++ executor
(``kf_engine_all_reduce``, one ctypes call that drops the GIL); otherwise
the Python path walks the same graphs with its chunks on a thread pool.
Both fold each chunk in graph order (``prevs`` in order, through
:func:`kungfu_tpu_torch.native.transform2`), so they are bitwise equal
to each other and to the reference engine on the same inputs, and a
cluster may mix port and reference engines.  :func:`graph_all_reduce_reference`
is the engine's plain version: the same graph walk over all ranks' buffers
in one process, used by tests and by ``chip_smoke.py``'s checks, never on
the path.

Buffers are contiguous CPU ``torch.Tensor`` s (pinned or not), or numpy
arrays as in the reference (a numpy input gives numpy outputs, bf16 as
ml_dtypes' when the input was).  Differences from the reference:
``native_runs`` counts the collectives the C++ executor ran; and ``mean``
is divided in numpy on the result's buffer, as the reference divides
(``np.divide(out, n)``: an integer input gives float64 and a bf16 input
float32, as numpy promotes them; an integer ``inplace`` mean raises
numpy's casting ``TypeError``).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kungfu_tpu_torch import native
from kungfu_tpu_torch.chaos import controller_for as _chaos_controller_for
from kungfu_tpu_torch.comm.faults import PeerFailureError
from kungfu_tpu_torch.comm.host import (CONNECT_TIMEOUT_S, ConnType,
                                        host_pool_size, tensor_buffer)
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.native import as_tensor, np_view
from kungfu_tpu_torch.plan import (Strategy, auto_select, gen_binary_tree,
                                   gen_binary_tree_star,
                                   gen_circular_graph_pair,
                                   gen_multi_binary_tree_star, gen_multi_star,
                                   gen_star, gen_tree)
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.plan.topology import (gen_clique,
                                            gen_cross_binary_tree,
                                            gen_cross_ring_pairs)
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.retry import sleep_backoff

_log = get_logger("engine")

CHUNK_SIZE = 1 << 20  # 1 MiB, reference session.go:292-316

#: colocated peers (one host) pipeline the socket -> reduce stages with
#: smaller chunks (the reference's choice, kept); cross-host traffic
#: keeps the reference's 1 MiB
CHUNK_SIZE_COLOCATED = 256 << 10


def engine_chunk_size(colocated: bool = False) -> int:
    """Chunk size for graph sharding (``KF_CONFIG_CHUNK_SIZE`` bytes).
    MUST be identical on every peer: chunk boundaries and tags derive
    from it.  Non-positive values fall back to the default."""
    default = CHUNK_SIZE_COLOCATED if colocated else CHUNK_SIZE
    v = envs.parse_int_env(envs.CHUNK_SIZE, default)
    return v if v > 0 else default


def engine_threads() -> int:
    """C++ executor worker threads (``KF_CONFIG_ENGINE_THREADS``),
    default min(8, cpu count)."""
    return envs.parse_int_env(
        envs.ENGINE_THREADS, min(8, max(1, os.cpu_count() or 1)))


def engine_timeout_s() -> float:
    """C++ executor per-collective timeout (``KF_CONFIG_ENGINE_TIMEOUT``
    seconds, default 60)."""
    return envs.parse_float_env(envs.ENGINE_TIMEOUT, 60.0)


def overlap_depth_default() -> int:
    """Bound on in-flight async handles per engine
    (``KF_CONFIG_OVERLAP_DEPTH``, default 2; non-positive falls back)."""
    v = envs.parse_int_env(envs.OVERLAP_DEPTH, 2)
    return v if v > 0 else 2


def peer_deadline_s() -> float:
    """Per-peer deadline for one send or recv (``KF_CONFIG_PEER_DEADLINE``
    seconds; default the engine timeout): past it a primitive raises
    :class:`PeerFailureError` naming the suspect rank."""
    return envs.parse_float_env(envs.PEER_DEADLINE, engine_timeout_s())


#: ceiling on the connect-ladder length handed to ``channel.send`` per
#: retry attempt (the ladder is sized from the remaining deadline)
_SEND_CONNECT_RETRIES = 10

#: "caller did not choose a chaos identity", distinct from an explicit
#: ``None`` (a late joiner with no bootstrap rank)
_CHAOS_RANK_UNSET = object()

REDUCE_OPS = native.REDUCE_OPS

#: worker count of :meth:`CollectiveEngine.async_pool`: the ceiling on
#: concurrently running caller-level async ops per engine
ASYNC_POOL_WORKERS = 8


#: Static protocol metadata for every public wire op of
#: :class:`CollectiveEngine` — the declarative issue-site table the
#: kf-verify abstract interpreter (``analysis/commgraph.py``) extracts
#: comm sequences from.  MUST stay a pure literal dict: the analysis
#: layer reads it via ``ast.literal_eval`` without importing this
#: module (kflint runs in bare CI images with no numpy/torch).
#:
#: Per op: ``kind`` ("collective" = group rendezvous over every engine
#: peer; "p2p-send"/"p2p-recv" = point-to-point toward the rank in the
#: first positional arg), ``group`` (the membership axis a collective
#: rendezvouses over), ``tag`` (how the caller ``name`` becomes the
#: wire rendezvous tag; ``{name}`` is the caller's argument), and
#: ``blocking`` (False = returns a :class:`CollectiveHandle`; the
#: wait/fence discipline is checked by handle-discipline and the
#: kf-verify wait-for-graph pass).  ``analysis/protoverify.py``
#: cross-checks this table against the actual method defs both ways,
#: so drift (new wire op without metadata, metadata for a removed op)
#: is a lint finding, not silent rot.
COMM_OP_SPECS = {
    "all_reduce":          {"kind": "collective", "group": "world",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "broadcast":           {"kind": "collective", "group": "world",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "reduce":              {"kind": "collective", "group": "world",
                            "tag": "{name}.r", "blocking": True,
                            "name_pos": 3, "peer_pos": None},
    "gather":              {"kind": "collective", "group": "world",
                            "tag": "{name}.g", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "all_gather":          {"kind": "collective", "group": "world",
                            "tag": "{name}.ag", "blocking": True,
                            "name_pos": 1, "peer_pos": None},
    "reduce_scatter":      {"kind": "collective", "group": "world",
                            "tag": "{name}.rs", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "local_reduce":        {"kind": "collective", "group": "slice",
                            "tag": "{name}.lr", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "local_broadcast":     {"kind": "collective", "group": "slice",
                            "tag": "{name}.lb", "blocking": True,
                            "name_pos": 1, "peer_pos": None},
    "cross_all_reduce":    {"kind": "collective", "group": "cross",
                            "tag": "{name}.x", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "send_to":             {"kind": "p2p-send", "group": "pair",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 2, "peer_pos": 0},
    "recv_from":           {"kind": "p2p-recv", "group": "pair",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 1, "peer_pos": 0},
    "send_async":          {"kind": "p2p-send", "group": "pair",
                            "tag": "{name}", "blocking": False,
                            "name_pos": 2, "peer_pos": 0},
    "recv_async":          {"kind": "p2p-recv", "group": "pair",
                            "tag": "{name}", "blocking": False,
                            "name_pos": 1, "peer_pos": 0},
    "all_reduce_async":    {"kind": "collective", "group": "world",
                            "tag": "{name}", "blocking": False,
                            "name_pos": 2, "peer_pos": None},
    "reduce_scatter_async": {"kind": "collective", "group": "world",
                             "tag": "{name}.rs", "blocking": False,
                             "name_pos": 2, "peer_pos": None},
    "all_gather_async":    {"kind": "collective", "group": "world",
                            "tag": "{name}.ag", "blocking": False,
                            "name_pos": 1, "peer_pos": None},
}


def build_strategy_graphs(
    strategy: Strategy, peers: PeerList
) -> List[Tuple[Graph, Graph]]:
    """The (reduce, broadcast) graph pairs of a strategy over the peer
    list (reference ``session/strategy.go:90-174``)."""
    n = len(peers)
    host_ranks = list(peers.partition_by_host().values())
    if strategy == Strategy.AUTO:
        strategy = auto_select(len(host_ranks))
    if strategy == Strategy.STAR:
        return [gen_star(n)]
    if strategy == Strategy.MULTI_STAR:
        return gen_multi_star(n, host_ranks)
    if strategy == Strategy.RING:
        return [gen_circular_graph_pair(n, shift=s) for s in range(n)]
    if strategy == Strategy.CLIQUE:
        return gen_clique(n)
    if strategy == Strategy.TREE:
        return [gen_tree(n, host_ranks)]
    if strategy == Strategy.BINARY_TREE:
        return [gen_binary_tree(n)]
    if strategy == Strategy.BINARY_TREE_STAR:
        return [gen_binary_tree_star(n, host_ranks)]
    if strategy == Strategy.MULTI_BINARY_TREE_STAR:
        return gen_multi_binary_tree_star(n, host_ranks)
    raise ValueError(f"unhandled strategy {strategy}")


def build_cross_strategy_graphs(
    strategy: Strategy, peers: PeerList
) -> List[Tuple[Graph, Graph]]:
    """Cross-host stage of hierarchical allreduce (reference
    ``session/strategy.go:188-210``): RING runs ring rotations over the
    local masters, every other strategy one binary tree over them."""
    n = len(peers)
    masters = [ranks[0] for ranks in peers.partition_by_host().values()
               if ranks]
    if strategy == Strategy.RING:
        return gen_cross_ring_pairs(n, masters)
    return gen_cross_binary_tree(n, masters)


def name_based_hash(name: str) -> int:
    """Name-based chunk -> strategy hash (reference ``shard.go:17-23``)."""
    return sum(ord(c) * ord(c) for c in name)


# -- host buffers ------------------------------------------------------------

def _host(x) -> Tuple[torch.Tensor, object]:
    """``(tensor, back)``: ``x`` as a CPU tensor viewing the same memory
    (a read-only numpy array is copied), and the function that turns a
    result tensor into the caller's kind (numpy in, numpy out)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"the host engine takes CPU buffers, got "
                             f"{x.device}")
        return x, _same
    a = np.asarray(x)
    if not a.flags.writeable:
        a = a.copy()
    dt = a.dtype

    def back(t: torch.Tensor):
        return np_view(t).view(dt) if t.dtype == torch.bfloat16 else t.numpy()

    return as_tensor(a), back


def _same(t):
    return t


def _writable(x) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    return bool(np.asarray(x).flags.writeable)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _from_bytes(data, dtype: torch.dtype) -> torch.Tensor:
    """A fresh tensor of ``dtype`` holding the bytes ``data``."""
    t = torch.from_numpy(np.frombuffer(data, _np_dtype(dtype)).copy())
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _payload(t: torch.Tensor):
    """The bytes of a tensor as a buffer the channels send without a copy."""
    return tensor_buffer(t.contiguous())


def _mean_divide(out: torch.Tensor, n: int, inplace: bool) -> torch.Tensor:
    """``out / n`` as the reference's ``np.divide(out, n)``: numpy's true
    division on the same buffer, with numpy's result dtypes -- float64
    for an integer input, float32 for bf16 (ml_dtypes promotes it), the
    input's own for the other floats; ``inplace`` writes back in the
    buffer's dtype (bf16 rounded to nearest-even), and an integer buffer
    raises numpy's casting ``TypeError``."""
    v = np_view(out)
    if out.dtype == torch.bfloat16:
        a = (v.astype(np.uint32) << 16).view(np.float32) / np.float32(n)
        if not inplace:
            return torch.from_numpy(a)
        u = a.view(np.uint32)
        r = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
        nan = np.isnan(a)
        r[nan] = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0)
        v[...] = r
        return out
    res = np.divide(v, n, out=v if inplace else None)
    return out if inplace else torch.from_numpy(res)


def _split(flat: torch.Tensor, chunk_size: int) -> List[torch.Tensor]:
    """``np.array_split`` over elements into ``ceil(nbytes / chunk_size)``
    chunks (the C++ executor slices the same way)."""
    n_chunks = max(1, -(-_nbytes(flat) // chunk_size))
    return list(torch.tensor_split(flat, n_chunks))


# -- the plain version ---------------------------------------------------------

def _walk(chunks: Sequence[torch.Tensor], reduce_g: Graph, bcast_g: Graph,
          op: str) -> List[torch.Tensor]:
    """Every rank's result of one chunk under one graph pair, as
    ``CollectiveEngine._run_graphs`` computes it on each rank."""
    sent: Dict[int, torch.Tensor] = {}

    def reduced(r: int) -> torch.Tensor:
        if r not in sent:
            acc = chunks[r].clone() if reduce_g.is_self_loop(r) else None
            for prev in reduce_g.prevs(r):
                got = reduced(prev)
                acc = got.clone() if acc is None else native.transform2(
                    acc, got.clone(), op)
            sent[r] = chunks[r].clone() if acc is None else acc
        return sent[r]

    final: Dict[int, torch.Tensor] = {}

    def result(r: int) -> torch.Tensor:
        if r not in final:
            prevs = bcast_g.prevs(r)
            final[r] = (result(prevs[0]) if not bcast_g.is_self_loop(r)
                        and prevs else reduced(r))
        return final[r]

    return [result(r).clone() for r in range(len(chunks))]


def graph_all_reduce_reference(bufs: Sequence, graphs, op: str = "sum",
                               chunk_size: int = CHUNK_SIZE_COLOCATED,
                               name: Optional[str] = None) -> List:
    """The engine's allreduce of every rank's buffer, computed in one
    process by walking the same graph pairs over the same chunks in the
    same fold order: ``bufs[r]`` is rank ``r``'s input, ``graphs`` the
    strategy's pairs (:func:`build_strategy_graphs`), ``name`` the tag
    when chunks hash by name (``KF_CONFIG_STRATEGY_HASH_METHOD=NAME``).
    Returns each rank's result (``mean`` divided as the engine
    divides)."""
    if op not in REDUCE_OPS and op != "mean":
        raise ValueError(f"op {op!r}")
    eff_op = "sum" if op == "mean" else op
    hosts = [_host(b) for b in bufs]
    flats = [t.contiguous().reshape(-1) for t, _ in hosts]
    per_rank = [_split(f, chunk_size) for f in flats]
    outs: List[List[torch.Tensor]] = [[] for _ in flats]
    for i in range(len(per_rank[0])):
        gi = (name_based_hash(name) if name is not None else i) % len(graphs)
        reduce_g, bcast_g = graphs[gi]
        got = _walk([c[i] for c in per_rank], reduce_g, bcast_g, eff_op)
        for r, g in enumerate(got):
            outs[r].append(g)
    res = []
    for (t, back), parts in zip(hosts, outs):
        out = torch.cat(parts).reshape(t.shape)
        if op == "mean":
            out = _mean_divide(out, len(bufs), False)
        res.append(back(out))
    return res


# -- async collective plane ----------------------------------------------------
#: process-wide in-flight accounting behind the ``kf_overlap_inflight``
#: gauge (several engines of one process sum into it)
_inflight_lock = threading.Lock()
_inflight_total = 0

#: observed-at-wait hidden-wire fraction buckets
_EFFICIENCY_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def _inflight_adjust(delta: int) -> int:
    global _inflight_total
    with _inflight_lock:
        _inflight_total += delta
        total = _inflight_total
        # set inside the lock: the gauge is last-write-wins
        REGISTRY.gauge("kf_overlap_inflight").set(total)
    return total


class CollectiveHandle:
    """A collective in flight: issued now, settled at :meth:`wait`.
    Whatever the collective would have raised inline is raised at
    :meth:`wait`; every handle must be waited on, and never held across
    a membership change (:meth:`CollectiveEngine.drain_async`)."""

    __slots__ = ("tag", "op", "nbytes", "_event", "_result", "_error",
                 "_t_issue", "_t_complete", "_observed")

    def __init__(self, tag: str, op: str, nbytes: int):
        self.tag = tag
        self.op = op
        self.nbytes = nbytes
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._t_issue = time.perf_counter()
        self._t_complete: Optional[float] = None
        self._observed = False

    def _settle(self, result=None, error: Optional[BaseException] = None):
        self._t_complete = time.perf_counter()
        self._result = result
        self._error = error
        self._event.set()

    def done(self) -> bool:
        """True once the collective settled (successfully or not)."""
        return self._event.is_set()

    def error(self) -> Optional[BaseException]:
        """The settled failure, or None."""
        return self._error

    def wait(self, timeout: Optional[float] = None):
        """Block until the collective settles; return its result or
        re-raise its failure.  The first successful wait observes the
        hidden-wire fraction into ``kf_overlap_efficiency``."""
        t_wait = time.perf_counter()
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"handle {self.tag!r} not complete after {timeout}s "
                "(the collective's own deadline machinery should settle "
                "it; is KF_CONFIG_PEER_DEADLINE larger than this wait?)")
        if self._error is not None:
            raise self._error
        if not self._observed:
            self._observed = True
            wire = (self._t_complete or t_wait) - self._t_issue
            hidden = 1.0 if wire <= 0 else max(
                0.0, min(1.0, (t_wait - self._t_issue) / wire))
            REGISTRY.histogram(
                "kf_overlap_efficiency", buckets=_EFFICIENCY_BUCKETS
            ).observe(hidden)
        return self._result


class CollectiveEngine:
    """Executes graph collectives for one peer over its host channel."""

    def __init__(
        self,
        channel,
        peers: PeerList,
        strategy: Strategy = Strategy.AUTO,
        chaos_rank=_CHAOS_RANK_UNSET,
    ):
        self.channel = channel
        self.peers = peers
        self.rank = peers.rank(channel.self_id)
        if self.rank is None:
            raise ValueError(f"{channel.self_id} not in {peers}")
        self.strategy = strategy
        self._graphs = build_strategy_graphs(strategy, peers)
        self._cross_graphs = build_cross_strategy_graphs(strategy, peers)
        # derived from the shared peer list: identical on every peer
        self._colocated = len(peers.hosts()) <= 1
        # chunk -> strategy hash mode, read once (reference shard.go:25-31)
        self._hash_name_based = (
            os.environ.get(envs.STRATEGY_HASH_METHOD, "").strip().upper()
            == "NAME")
        #: fault injection: None unless KF_CHAOS_SPEC is set.  chaos_rank
        #: is the process's stable identity; engines built directly use
        #: the current rank
        self._chaos = _chaos_controller_for(
            self.rank if chaos_rank is _CHAOS_RANK_UNSET else chaos_rank)
        #: rank stamped on timeline events (the stable one when given)
        self._timeline_rank = (
            chaos_rank
            if chaos_rank is not _CHAOS_RANK_UNSET and chaos_rank is not None
            else self.rank)
        self._peer_deadline = peer_deadline_s()
        self._coll_counter = REGISTRY.counter("kf_engine_collectives_total")
        self._seq = 0
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()  # guards stats/_window swaps
        self._peers_csv = ",".join(str(p) for p in peers)
        self._graph_ser: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # sender/chunk pool scaled with the peer count
        self._pool = ThreadPoolExecutor(
            max_workers=host_pool_size(len(peers), floor=8, pool="engine"),
            thread_name_prefix="kf-engine",
        )
        self._async_pool: Optional[ThreadPoolExecutor] = None
        # per-strategy-pair accounting: cumulative (bytes, seconds), a
        # recent window (reset by throughputs()), and the best window rate
        self.stats = [[0, 0.0] for _ in self._graphs]
        self._window = [[0, 0.0] for _ in self._graphs]
        self.best_throughputs = [0.0 for _ in self._graphs]
        #: collectives the C++ executor ran (port addition)
        self.native_runs = 0
        # swap-eligibility epoch: collectives since the last swap
        self._colls_total = 0
        self._colls_at_swap = 0
        # the bounded in-flight window of async handles
        self._overlap_depth = overlap_depth_default()
        self._overlap_cond = threading.Condition()
        self._inflight_handles: set = set()
        #: ``fn(nbytes, depth, seconds)`` per completed async collective
        self._latency_hook = None

    # -- public collectives ----------------------------------------------
    def all_reduce(self, x, op: str = "sum", name: str = "",
                   record: bool = True, inplace: bool = False):
        """Chunked graph allreduce (reference ``allreduce.go:11`` +
        ``runStrategies``).  ``record=False`` keeps control-plane traffic
        out of the throughput window.  ``inplace=True`` reduces in
        ``x``'s buffer and returns ``x`` (a non-contiguous input pays a
        staging copy and still receives the result); a read-only input
        raises."""
        if op not in REDUCE_OPS and op != "mean":
            raise ValueError(f"op {op!r}")
        self._begin_collective(name or "all_reduce")
        eff_op = "sum" if op == "mean" else op
        if inplace and not _writable(x):
            raise ValueError("inplace=True requires a writable array")
        orig, back = _host(x)
        t = orig.contiguous()
        flat = t.reshape(-1)
        tag = name or f"ar{self._next_seq()}"
        nbytes = _nbytes(flat)
        with timeline.span(
            "collective", f"engine.all_reduce[{nbytes}B]",
            rank=self._timeline_rank, op="all_reduce", tag=tag, nbytes=nbytes,
            trace=self._trace_id("all_reduce", tag),
        ):
            out = self._run_over_graphs(
                flat, eff_op, tag, self._graphs, record=record,
                inplace=inplace)
        out = out.reshape(t.shape)
        if op == "mean":
            out = _mean_divide(out, len(self.peers), inplace)
        if inplace:
            # the Python path, or a non-contiguous staging copy, produced
            # a fresh buffer: the caller's buffer holds the result anyway
            if out.data_ptr() != orig.data_ptr() or not orig.is_contiguous():
                orig.copy_(out)
            return x
        return back(out)

    def _begin_collective(self, tag: str) -> None:
        """Entry hook of every public collective: the collective counter
        and the injector's ``coll`` counter."""
        self._coll_counter.inc()
        with self._stats_lock:
            self._colls_total += 1
        if self._chaos is not None:
            self._chaos.on_collective(tag)

    def _trace_id(self, op: str, tag: str) -> str:
        """Cross-rank trace id: every participant derives the same one."""
        return timeline.collective_trace_id(
            getattr(self.channel, "token", 0), timeline.current_step(),
            op, tag)

    def broadcast(self, x, root: int = 0, name: str = ""):
        self._begin_collective(name or "broadcast")
        with self._lock:
            seq = self._seq
            self._seq += 1
        tag = name or f"bc{seq}"
        _, bcast_g = gen_star(len(self.peers), center=root)
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        with timeline.span(
            "collective", "engine.broadcast", rank=self._timeline_rank,
            op="broadcast", tag=tag, nbytes=_nbytes(flat),
            trace=self._trace_id("broadcast", tag),
        ):
            out = self._run_bcast(flat.clone(), f"{tag}", bcast_g)
        return back(out.reshape(t.shape))

    def reduce(self, x, root: int = 0, op: str = "sum", name: str = ""):
        """Reduce to ``root`` (reference ``session.go:157-161``): only the
        root returns the reduced value; other ranks get their input back."""
        self._begin_collective(name or "reduce")
        tag = (name or f"rd{self._next_seq()}") + ".r"
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        eff_op = "sum" if op == "mean" else op
        reduce_g, _ = gen_star(len(self.peers), center=root)
        me = self.rank
        acc = flat.clone()
        with timeline.span("collective", "engine.reduce",
                           rank=self._timeline_rank, op="reduce", tag=tag,
                           nbytes=_nbytes(flat),
                           trace=self._trace_id("reduce", tag)):
            for prev in reduce_g.prevs(me):
                data = _from_bytes(self._recv(prev, tag), flat.dtype)
                acc = native.transform2(acc, data, eff_op)
            for nxt in reduce_g.nexts(me):
                self._send(nxt, tag, _payload(acc))
        if me == root and op == "mean":
            acc = _mean_divide(acc, len(self.peers), False)
        return back(acc.reshape(t.shape)) if me == root else x

    def gather(self, x, root: int = 0, name: str = ""):
        """Root returns ``[n, ...]`` stacked in rank order; others None
        (reference ``session.go:189-211``)."""
        self._begin_collective(name or "gather")
        tag = (name or f"ga{self._next_seq()}") + ".g"
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        with timeline.span("collective", "engine.gather",
                           rank=self._timeline_rank, op="gather", tag=tag,
                           nbytes=_nbytes(flat),
                           trace=self._trace_id("gather", tag)):
            if self.rank == root:
                parts = []
                for r in range(len(self.peers)):
                    if r == root:
                        parts.append(flat)
                    else:
                        parts.append(_from_bytes(self._recv(r, tag),
                                                 flat.dtype))
                return back(torch.stack(parts).reshape(
                    (len(self.peers),) + tuple(t.shape)))
            self._send(root, tag, _payload(flat))
            return None

    def all_gather(self, x, name: str = ""):
        """Direct full exchange (reference ``allgather.go:17-45``): every
        peer sends to every other; returns ``[n, ...]`` in rank order."""
        self._begin_collective(name or "all_gather")
        tag = (name or f"ag{self._next_seq()}") + ".ag"
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        me = self.rank
        with timeline.span("collective", "engine.all_gather",
                           rank=self._timeline_rank, op="all_gather",
                           tag=tag, nbytes=_nbytes(flat),
                           trace=self._trace_id("all_gather", tag)):
            for r in range(len(self.peers)):
                if r != me:
                    self._send(r, tag, _payload(flat))
            parts = []
            for r in range(len(self.peers)):
                if r == me:
                    parts.append(flat)
                else:
                    parts.append(_from_bytes(self._recv(r, tag), flat.dtype))
        return back(torch.stack(parts).reshape(
            (len(self.peers),) + tuple(t.shape)))

    def reduce_scatter(self, x, op: str = "sum", name: str = ""):
        """Reduce-scatter over the host plane: every rank contributes a
        full flat buffer and receives the 1/n chunk it owns (rank-major,
        zero-padded to ``n * chunk``) reduced across all ranks, folded in
        rank order by direct exchange."""
        if op not in REDUCE_OPS and op != "mean":
            raise ValueError(f"op {op!r}")
        self._begin_collective(name or "reduce_scatter")
        eff_op = "sum" if op == "mean" else op
        tag = (name or f"rs{self._next_seq()}") + ".rs"
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        n = len(self.peers)
        me = self.rank
        chunk = -(-flat.shape[0] // n) if flat.shape[0] else 0
        padded = torch.zeros((chunk * n,), dtype=flat.dtype)
        padded[: flat.shape[0]] = flat
        with timeline.span(
            "collective", f"engine.reduce_scatter[{_nbytes(flat)}B]",
            rank=self._timeline_rank, op="reduce_scatter", tag=tag,
            nbytes=_nbytes(flat), trace=self._trace_id("reduce_scatter", tag),
        ):
            for r in range(n):
                if r != me:
                    self._send(r, f"{tag}.{r}",
                               _payload(padded[r * chunk:(r + 1) * chunk]))
            acc = padded[me * chunk:(me + 1) * chunk].clone()
            for r in range(n):
                if r == me:
                    continue
                data = _from_bytes(self._recv(r, f"{tag}.{me}"), flat.dtype)
                acc = native.transform2(acc, data, eff_op)
        if op == "mean":
            acc = _mean_divide(acc, n, False)
        return back(acc)

    # -- point-to-point ----------------------------------------------------
    def send_to(self, rank: int, data, name: str) -> int:
        """Deadline-bounded point-to-point send to ``rank`` on the
        engine's wire; ``data`` is a tensor, an ndarray or bytes.  Not a
        collective: it does not tick the collective counter.  Returns the
        payload size."""
        if isinstance(data, (torch.Tensor, np.ndarray)):
            payload = _payload(_host(data)[0])
            nbytes = payload.nbytes
        else:
            payload = bytes(data)
            nbytes = len(payload)
        with timeline.span(
            "collective", f"engine.send[{nbytes}B]",
            rank=self._timeline_rank, op="send", tag=name, nbytes=nbytes,
            # op "p2p" on both halves: one trace id for the hop
            trace=self._trace_id("p2p", name),
        ):
            self._send(rank, name, payload)
        return nbytes

    def recv_from(self, rank: int, name: str, dtype=None, shape=None):
        """Deadline-bounded point-to-point receive from ``rank``: raw
        bytes, or with ``dtype`` a tensor (a torch dtype) or an ndarray (a
        numpy dtype), reshaped to ``shape`` when given."""
        with timeline.span(
            "collective", "engine.recv", rank=self._timeline_rank,
            op="recv", tag=name, nbytes=0,
            trace=self._trace_id("p2p", name),
        ):
            data = self._recv(rank, name)
        if dtype is None:
            return bytes(data)
        if isinstance(dtype, torch.dtype):
            out = _from_bytes(data, dtype)
        else:
            out = np.frombuffer(bytes(data), dtype=dtype)
        return out.reshape(shape) if shape is not None else out

    def send_async(self, rank: int, data, name: str) -> CollectiveHandle:
        """Issue a point-to-point send; returns a :class:`CollectiveHandle`."""
        nbytes = (_nbytes(_host(data)[0])
                  if isinstance(data, (torch.Tensor, np.ndarray))
                  else len(data))
        return self._issue_async(
            "send", name, nbytes, lambda: self.send_to(rank, data, name))

    def recv_async(self, rank: int, name: str, dtype=None,
                   shape=None) -> CollectiveHandle:
        """Issue a point-to-point receive; the payload surfaces at
        ``handle.wait()``."""
        return self._issue_async(
            "recv", name, 0,
            lambda: self.recv_from(rank, name, dtype=dtype, shape=shape))

    # -- async collectives ---------------------------------------------------
    def all_reduce_async(self, x, op: str = "sum", name: str = "",
                         record: bool = True) -> CollectiveHandle:
        """Issue a chunked graph allreduce; the result surfaces at
        ``handle.wait()``.  The tag is fixed here, in issue order."""
        tag = name or f"ar{self._next_seq()}"
        return self._issue_async(
            "all_reduce", tag, _nbytes(_host(x)[0]),
            lambda: self.all_reduce(x, op=op, name=tag, record=record))

    def reduce_scatter_async(self, x, op: str = "sum",
                             name: str = "") -> CollectiveHandle:
        """Async :meth:`reduce_scatter` (the ZeRO gradient-bucket pipeline
        primitive)."""
        base = name or f"rs{self._next_seq()}"
        return self._issue_async(
            "reduce_scatter", base, _nbytes(_host(x)[0]),
            lambda: self.reduce_scatter(x, op=op, name=base))

    def all_gather_async(self, x, name: str = "") -> CollectiveHandle:
        """Async :meth:`all_gather` (the ZeRO-3 parameter-bucket
        prefetch primitive)."""
        base = name or f"ag{self._next_seq()}"
        return self._issue_async(
            "all_gather", base, _nbytes(_host(x)[0]),
            lambda: self.all_gather(x, name=base))

    def _issue_async(self, op: str, tag: str, nbytes: int,
                     fn) -> CollectiveHandle:
        """Admit one collective into the bounded in-flight window and run
        it on the async pool; blocks while ``overlap_depth`` handles are
        in flight (completion, not ``wait()``, releases a slot)."""
        pool = self.async_pool()
        with self._overlap_cond:
            while len(self._inflight_handles) >= self._overlap_depth:
                self._overlap_cond.wait()
            handle = CollectiveHandle(tag, op, nbytes)
            self._inflight_handles.add(handle)
            depth_now = len(self._inflight_handles)
        total = _inflight_adjust(+1)
        if timeline.enabled():
            timeline.event("overlap", "issue", rank=self._timeline_rank,
                           op=op, tag=tag, nbytes=nbytes,
                           inflight=depth_now, inflight_total=total)

        def run():
            err = None
            t0 = time.perf_counter()
            try:
                out = fn()
            except BaseException as e:  # noqa: BLE001 - settled at wait()
                err = e
                out = None
            dt = time.perf_counter() - t0
            # one critical section for the whole completion (cond ->
            # _inflight_lock nesting only)
            with self._overlap_cond:
                total_now = _inflight_adjust(-1)
                self._inflight_handles.discard(handle)
                left = len(self._inflight_handles)
                handle._settle(out, err)
                self._overlap_cond.notify_all()
            if timeline.enabled():
                timeline.event(
                    "overlap", "complete", rank=self._timeline_rank,
                    op=op, tag=tag, nbytes=nbytes, inflight=left,
                    inflight_total=total_now, dur=round(dt, 6),
                    error=type(err).__name__ if err is not None else None)
            hook = self._latency_hook
            if hook is not None and err is None:
                try:
                    hook(nbytes, self._overlap_depth, dt)
                except Exception:  # noqa: BLE001 - observability only
                    _log.exception("overlap latency hook failed")

        pool.submit(run)
        return handle

    @property
    def overlap_depth(self) -> int:
        """The in-flight window bound currently in force."""
        return self._overlap_depth

    def set_overlap_depth(self, depth: int) -> None:
        """Retune the in-flight window live."""
        if depth < 1:
            raise ValueError(f"overlap depth must be >= 1, got {depth}")
        with self._overlap_cond:
            self._overlap_depth = int(depth)
            self._overlap_cond.notify_all()

    def inflight(self) -> int:
        """Issued-and-unsettled handle count on this engine."""
        with self._overlap_cond:
            return len(self._inflight_handles)

    def drain_async(self, timeout: Optional[float] = None) -> int:
        """Block until every in-flight handle settles; returns how many
        were drained (the membership fence)."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._overlap_cond:
            drained = len(self._inflight_handles)
            while self._inflight_handles:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"{len(self._inflight_handles)} async handle(s) "
                            f"still in flight after {timeout}s drain")
                self._overlap_cond.wait(remaining)
        return drained

    def set_latency_hook(self, fn) -> None:
        """Install ``fn(nbytes, depth, seconds)`` for each completed async
        collective; ``None`` disables."""
        self._latency_hook = fn

    # -- hierarchical (host-partitioned) collectives -------------------------
    def _local_ranks(self) -> List[int]:
        host = self.peers[self.rank].host
        return [r for r, p in enumerate(self.peers) if p.host == host]

    def _local_roots(self) -> List[int]:
        seen = {}
        for r, p in enumerate(self.peers):
            seen.setdefault(p.host, r)
        return sorted(seen.values())

    def _subset_reduce(self, flat, ranks: List[int], root: int, op: str,
                       tag: str):
        """Star-reduce over a rank subset; result lands on ``root``."""
        me = self.rank
        acc = flat.clone()
        if me == root:
            for r in ranks:
                if r != root:
                    data = _from_bytes(self._recv(r, tag), flat.dtype)
                    acc = native.transform2(acc, data, op)
        else:
            self._send(root, tag, _payload(flat))
        return acc

    def _subset_bcast(self, flat, ranks: List[int], root: int, tag: str):
        me = self.rank
        if me == root:
            for r in ranks:
                if r != root:
                    self._send(r, tag, _payload(flat))
            return flat
        return _from_bytes(self._recv(root, tag), flat.dtype)

    def local_reduce(self, x, op: str = "sum", name: str = ""):
        """Reduce among same-host peers; result on the local root
        (reference ``LocalReduce``).  Non-roots get their input back."""
        self._begin_collective(name or "local_reduce")
        tag = (name or f"lr{self._next_seq()}") + ".lr"
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        ranks = self._local_ranks()
        root = min(ranks)
        with timeline.span("collective", "engine.local_reduce",
                           rank=self._timeline_rank, op="local_reduce",
                           tag=tag, nbytes=_nbytes(flat),
                           trace=self._trace_id("local_reduce", tag)):
            acc = self._subset_reduce(
                flat, ranks, root, "sum" if op == "mean" else op, tag)
        if self.rank == root:
            if op == "mean":
                acc = _mean_divide(acc, len(ranks), False)
            return back(acc.reshape(t.shape))
        return x

    def local_broadcast(self, x, name: str = ""):
        """Broadcast from the local root to same-host peers."""
        self._begin_collective(name or "local_broadcast")
        tag = (name or f"lb{self._next_seq()}") + ".lb"
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        ranks = self._local_ranks()
        with timeline.span("collective", "engine.local_broadcast",
                           rank=self._timeline_rank, op="local_broadcast",
                           tag=tag, nbytes=_nbytes(flat),
                           trace=self._trace_id("local_broadcast", tag)):
            out = self._subset_bcast(flat, ranks, min(ranks), tag)
        return back(out.reshape(t.shape))

    def cross_all_reduce(self, x, op: str = "sum", name: str = ""):
        """Hierarchical allreduce (reference ``allreduce.go:38``): local
        reduce to the host roots, allreduce among roots over the cross
        graphs, local broadcast."""
        self._begin_collective(name or "cross_all_reduce")
        base = name or f"xa{self._next_seq()}"
        eff_op = "sum" if op == "mean" else op
        t, back = _host(x)
        flat = t.contiguous().reshape(-1)
        local = self._local_ranks()
        local_root = min(local)
        roots = self._local_roots()
        with timeline.span(
            "collective", "engine.cross_all_reduce",
            rank=self._timeline_rank, op="cross_all_reduce", tag=base,
            nbytes=_nbytes(flat),
            trace=self._trace_id("cross_all_reduce", base),
        ):
            acc = self._subset_reduce(
                flat, local, local_root, eff_op, base + ".lr")
            if self.rank == local_root and len(roots) > 1:
                acc = self._run_over_graphs(
                    acc.contiguous(), eff_op, base + ".x", self._cross_graphs)
            acc = self._subset_bcast(acc, local, local_root, base + ".lb")
        if op == "mean":
            acc = _mean_divide(acc, len(self.peers), False)
        return back(acc.reshape(t.shape))

    def _run_over_graphs(self, flat: torch.Tensor, op: str, tag: str,
                         graphs: List[Tuple[Graph, Graph]],
                         record: bool = False,
                         inplace: bool = False) -> torch.Tensor:
        """The runStrategies core (reference ``session.go:292-321``):
        chunk ``flat``, hash each chunk onto a graph pair, run the pairs
        concurrently; in the C++ executor when :meth:`_native_run` can,
        else on the chunk pool.  ``record`` feeds the per-strategy
        stats."""
        out = self._native_run(flat, op, tag, graphs, record,
                               inplace=inplace)
        if out is not None:
            return out
        chunks = _split(flat, engine_chunk_size(self._colocated))
        outs: List[Optional[torch.Tensor]] = [None] * len(chunks)
        errs: List[BaseException] = []

        def run_chunk(i: int, chunk: torch.Tensor):
            gi = self._choose(i, tag, len(graphs))
            reduce_g, bcast_g = graphs[gi]
            t0 = time.perf_counter()
            try:
                outs[i] = self._run_graphs(chunk, op, f"{tag}.c{i}",
                                           reduce_g, bcast_g)
            except BaseException as e:  # noqa: BLE001
                errs.append(e)
                return
            if record:
                dt = time.perf_counter() - t0
                with self._stats_lock:
                    st = self.stats[gi]
                    st[0] += _nbytes(chunk)
                    st[1] += dt
                    w = self._window[gi]
                    w[0] += _nbytes(chunk)
                    w[1] += dt

        if len(chunks) == 1:
            run_chunk(0, chunks[0])
        else:
            futures = [self._pool.submit(run_chunk, i, c)
                       for i, c in enumerate(chunks)]
            for f in futures:
                f.result()
        if errs:
            raise errs[0]
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _next_seq(self) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return seq

    # -- native executor delegation -------------------------------------------
    def _native_run(self, flat, op, tag, graphs, record,
                    inplace: bool = False) -> Optional[torch.Tensor]:
        """Run the collective in the C++ executor when possible; None =
        the caller takes the Python path."""
        if os.environ.get("KF_NATIVE_ENGINE", "1").lower() in ("0", "false",
                                                               "no"):
            return None
        if self._chaos is not None:
            # the C++ executor would bypass every chaos hook, so a chaos
            # run pins the Python path
            return None
        t = getattr(self.channel, "_t", None)  # NativeHostChannel only
        if t is None or not hasattr(t, "engine_all_reduce"):
            return None
        code = native._DTYPE_CODES.get(flat.dtype)
        opc = native._OP_CODES.get(op)
        if code is None or opc is None:
            return None
        key = id(graphs)
        ser = self._graph_ser.get(key)
        if ser is None:
            ser = self._graph_ser[key] = self._serialize_graphs(graphs)
        data, offsets = ser
        # reduced in place; the copy keeps the caller's input unless it
        # opted in to clobbering
        buf = flat if inplace else flat.clone()
        stats = np.zeros(len(graphs) * 2, np.float64)
        rc = t.engine_all_reduce(
            self._peers_csv, np_view(buf), flat.element_size(), code, opc,
            data, offsets, len(graphs), tag,
            1 if self._hash_name_based else 0,
            engine_chunk_size(self._colocated),
            min(engine_timeout_s(), peer_deadline_s()), engine_threads(),
            stats,
        )
        # collective-level failure without per-peer attribution
        if rc == 1:
            timeline.event("deadline", tag, rank=self._timeline_rank,
                           phase="native-collective", cause="TimeoutError")
            raise PeerFailureError(
                None, op=tag, phase="native-collective",
                cause=TimeoutError(f"native collective {tag!r} timed out"))
        if rc == 2:
            timeline.event("deadline", tag, rank=self._timeline_rank,
                           phase="native-collective", cause="ConnectionError")
            raise PeerFailureError(
                None, op=tag, phase="native-collective",
                cause=ConnectionError(
                    f"native collective {tag!r}: peer unreachable/closed"))
        if rc != 0:
            raise RuntimeError(f"native collective {tag!r} failed (rc={rc})")
        with self._stats_lock:
            self.native_runs += 1
            if record and graphs is self._graphs:
                for gi in range(len(graphs)):
                    b, s = stats[2 * gi], stats[2 * gi + 1]
                    self.stats[gi][0] += int(b)
                    self.stats[gi][1] += s
                    self._window[gi][0] += int(b)
                    self._window[gi][1] += s
        return buf

    def _serialize_graphs(self, graphs) -> Tuple[np.ndarray, np.ndarray]:
        """Me-centric adjacency consumed by ``kf_engine_all_reduce`` (see
        transport.cpp for the layout)."""
        me = self.rank
        data: List[int] = []
        offsets = [0]
        for red, bc in graphs:
            for g in (red, bc):
                data.append(1 if g.is_self_loop(me) else 0)
                prevs = list(g.prevs(me))
                data.append(len(prevs))
                data.extend(prevs)
                nexts = list(g.nexts(me))
                data.append(len(nexts))
                data.extend(nexts)
            offsets.append(len(data))
        return np.asarray(data, np.int32), np.asarray(offsets, np.int32)

    # -- internals -----------------------------------------------------------
    def _choose(self, chunk_idx: int, name: str,
                n_graphs: Optional[int] = None) -> int:
        """Chunk -> strategy hash (reference ``shard.go:11-31``): round
        robin, or by tensor name under
        ``KF_CONFIG_STRATEGY_HASH_METHOD=NAME``."""
        n = n_graphs if n_graphs is not None else len(self._graphs)
        if self._hash_name_based:
            return name_based_hash(name) % n
        return chunk_idx % n

    def all_reduce_egress(self, nbytes: int, elem_size: int,
                          name: str) -> Dict[str, int]:
        """The payload bytes this rank sends to each peer in one
        :meth:`all_reduce` of ``nbytes`` under ``name`` over the current
        graphs, by peer address: what a ``NetMonitor`` on the channel
        counts for it.  Both executors chunk (``np.array_split`` over
        ``ceil(nbytes / chunk)`` chunks) and route a chunk to its graph
        pair alike; each chunk goes once along every reduce and every
        broadcast edge out of this rank."""
        n = nbytes // elem_size
        n_chunks = max(1, -(-nbytes // engine_chunk_size(self._colocated)))
        base, extra = divmod(n, n_chunks)
        out: Dict[str, int] = {}
        for i in range(n_chunks):
            size = (base + (i < extra)) * elem_size
            reduce_g, bcast_g = self._graphs[
                self._choose(i, name, len(self._graphs))]
            for nxt in (list(reduce_g.nexts(self.rank))
                        + list(bcast_g.nexts(self.rank))):
                key = str(self.peers[nxt])
                out[key] = out.get(key, 0) + size
        return out

    def _send(self, rank: int, name: str, payload):
        """Send under a per-peer deadline: transient wire faults retry
        with jittered backoff; past the deadline :class:`PeerFailureError`
        names the suspect."""
        peer = self.peers[rank]
        deadline = time.monotonic() + self._peer_deadline
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            retries = max(1, min(_SEND_CONNECT_RETRIES,
                                 int(remaining / CONNECT_TIMEOUT_S)))
            try:
                if self._chaos is not None:
                    self._chaos.on_send(rank, name, payload,
                                        channel=self.channel, peer=peer)
                self.channel.send(peer, name, payload, ConnType.COLLECTIVE,
                                  retries=retries)
                return
            except (ConnectionError, TimeoutError, OSError) as e:
                if time.monotonic() >= deadline:
                    timeline.event(
                        "deadline", name, rank=self._timeline_rank,
                        peer=rank, phase="send", cause=type(e).__name__)
                    raise PeerFailureError(
                        rank, peer, op=name, phase="send", cause=e) from e
                timeline.event(
                    "retry", name, rank=self._timeline_rank, peer=rank,
                    attempt=attempt, cause=type(e).__name__)
                sleep_backoff(attempt, base=0.05, cap=1.0)
                attempt += 1

    def _recv(self, rank: int, name: str):
        peer = self.peers[rank]
        if self._chaos is not None:
            self._chaos.on_recv(rank, name)
        try:
            return self.channel.recv(peer, name, ConnType.COLLECTIVE,
                                     timeout=self._peer_deadline)
        except (TimeoutError, ConnectionError) as e:
            timeline.event("deadline", name, rank=self._timeline_rank,
                           peer=rank, phase="recv", cause=type(e).__name__)
            raise PeerFailureError(
                rank, peer, op=name, phase="recv", cause=e) from e

    def _recv_into(self, rank: int, name: str, arr: torch.Tensor) -> None:
        """Receive a same-sized payload into ``arr`` (zero-copy on the
        native channel); a size mismatch is a protocol violation."""
        peer = self.peers[rank]
        if self._chaos is not None:
            self._chaos.on_recv(rank, name)
        try:
            filled = self.channel.recv_into(
                peer, name, tensor_buffer(arr), ConnType.COLLECTIVE,
                timeout=self._peer_deadline)
        except (TimeoutError, ConnectionError) as e:
            timeline.event("deadline", name, rank=self._timeline_rank,
                           peer=rank, phase="recv", cause=type(e).__name__)
            raise PeerFailureError(
                rank, peer, op=name, phase="recv", cause=e) from e
        if filled:
            return
        data = self.channel.recv(peer, name, ConnType.COLLECTIVE)
        raise ValueError(
            f"collective {name!r} from rank {rank}: expected {_nbytes(arr)} "
            f"bytes, got {len(data)} — peers disagree on the chunk layout "
            "(mixed strategy/epoch?)")

    def _run_graphs(self, chunk: torch.Tensor, op: str, tag: str,
                    reduce_g: Graph, bcast_g: Graph) -> torch.Tensor:
        """The reference hot loop (``session.go:222-290`` runGraphs):
        reduce stage -- receive from the graph's prevs in order, fold,
        send to nexts; broadcast stage -- receive the result, forward."""
        me = self.rank
        acc = chunk.clone() if reduce_g.is_self_loop(me) else None
        scratch: Optional[torch.Tensor] = None
        for prev in reduce_g.prevs(me):
            if scratch is None:
                scratch = torch.empty_like(chunk)
            self._recv_into(prev, tag + ".r", scratch)
            if acc is None:
                acc = scratch
                scratch = None  # acc owns it; the next prev gets a fresh one
            else:
                acc = native.transform2(acc, scratch, op)
        if acc is None:
            acc = chunk.clone()
        for nxt in reduce_g.nexts(me):
            self._send(nxt, tag + ".r", _payload(acc))
        # broadcast stage: roots already hold the result
        if not bcast_g.is_self_loop(me):
            prevs = bcast_g.prevs(me)
            if prevs:
                acc = torch.empty_like(chunk)
                self._recv_into(prevs[0], tag + ".b", acc)
        for nxt in bcast_g.nexts(me):
            self._send(nxt, tag + ".b", _payload(acc))
        return acc

    def _run_bcast(self, buf: torch.Tensor, tag: str,
                   bcast_g: Graph) -> torch.Tensor:
        me = self.rank
        if not bcast_g.is_self_loop(me):
            prevs = bcast_g.prevs(me)
            if prevs:
                buf = _from_bytes(self._recv(prevs[0], tag + ".b"), buf.dtype)
        for nxt in bcast_g.nexts(me):
            self._send(nxt, tag + ".b", _payload(buf))
        return buf

    def async_pool(self) -> ThreadPoolExecutor:
        """Per-engine FIFO executor of caller-level async collectives,
        distinct from the chunk pool so a blocked caller-level op cannot
        occupy a chunk slot."""
        with self._lock:
            if self._async_pool is None:
                self._async_pool = ThreadPoolExecutor(
                    max_workers=ASYNC_POOL_WORKERS,
                    thread_name_prefix="kf-engine-async")
            return self._async_pool

    def close(self) -> None:
        """Shut the worker pools down."""
        self._pool.shutdown(wait=False)
        if self._async_pool is not None:
            self._async_pool.shutdown(wait=False)

    # -- adaptation hooks ------------------------------------------------------
    def throughputs(self) -> List[float]:
        """Per-strategy-pair GiB/s over the window since the last call;
        also updates :attr:`best_throughputs` (reference
        ``strategy.go:17-56``)."""
        out = []
        with self._stats_lock:
            for i, (b, t) in enumerate(self._window):
                rate = (b / t / 2**30) if t > 0 else 0.0
                out.append(rate)
                if rate > self.best_throughputs[i]:
                    self.best_throughputs[i] = rate
                self._window[i][0] = 0
                self._window[i][1] = 0.0
        return out

    def total_throughputs(self) -> List[float]:
        """Lifetime per-strategy-pair GiB/s."""
        with self._stats_lock:
            return [(b / t / 2**30) if t > 0 else 0.0 for b, t in self.stats]

    def window_peek(self) -> List[Tuple[int, float]]:
        """The recent per-pair window ``[(bytes, seconds), ...]`` without
        resetting it."""
        with self._stats_lock:
            return [(int(b), float(t)) for b, t in self._window]

    def mark_swap(self) -> None:
        """Open a new swap-eligibility epoch."""
        with self._stats_lock:
            self._colls_at_swap = self._colls_total

    def collectives_since_swap(self) -> int:
        """Collectives executed in the current swap-eligibility epoch."""
        with self._stats_lock:
            return self._colls_total - self._colls_at_swap

    def swap_eligible(self, min_collectives: int = 2) -> bool:
        """Whether the active strategy carried enough traffic since the
        last swap to be judged."""
        return self.collectives_since_swap() >= max(0, int(min_collectives))

    def set_strategy(self, strategy: Strategy) -> None:
        """Swap the strategy set (reference ``SetGlobalStrategy``; the
        caller fences the swap).  Drains the async window first: a handle
        in flight walks the old graphs."""
        self.drain_async()
        self.strategy = strategy
        self._graphs = build_strategy_graphs(strategy, self.peers)
        self._cross_graphs = build_cross_strategy_graphs(strategy, self.peers)
        self._graph_ser.clear()
        with self._stats_lock:
            self.stats = [[0, 0.0] for _ in self._graphs]
            self._window = [[0, 0.0] for _ in self._graphs]
            self.best_throughputs = [0.0 for _ in self._graphs]
            self._colls_at_swap = self._colls_total
