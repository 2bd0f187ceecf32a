"""Port parity: the host collective engine and what it stands on.

``plan/`` graphs and strategies, ``native/`` (``transform2`` and the C++
transport), ``chaos/``, the timeline's engine events, the host channels,
``comm/engine.py CollectiveEngine`` on both channels and both paths (the
C++ executor and the Python chunk loop), the host-plane ZeRO bucket
loops, ``host_noise_scale``, and system.py's quick BERT trained by four
ranks whose gradients go through four port engines -- each held against
the JAX package (``kungfu_tpu``) on the same numpy inputs, bitwise
wherever the reference's results are deterministic.

Every port socket binds port 0; a reference channel takes a port found
free and retries on ``EADDRINUSE``; channels run with
``KF_TPU_USE_UNIXSOCK=0`` (one test sets ``KF_SOCK_DIR`` under
``tmp_path``), so nothing is written outside the test's own directories.
"""

import errno
import os
import socket
import subprocess
import sys
import types
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu import chaos as jchaos
from kungfu_tpu import native as jnative
from kungfu_tpu import plan as jplan
from kungfu_tpu.comm import engine as jengine
from kungfu_tpu.comm import host as jhost
from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.monitor import timeline as jtimeline
from kungfu_tpu.ops import monitor as jmonitor
from kungfu_tpu.parallel import zero as jzero
from kungfu_tpu.plan import graph as jgraph
from kungfu_tpu.plan import hostfile as jhostfile
from kungfu_tpu.plan import mst as jmst
from kungfu_tpu.plan import topology as jtopology
from kungfu_tpu_torch import chaos, interop, native, plan
from kungfu_tpu_torch.comm import engine, host
from kungfu_tpu_torch.comm.faults import PeerFailureError
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.pulse import PulseMonitor
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.ops import monitor as tmonitor
from kungfu_tpu_torch.optimizers import apply_updates, sgd
from kungfu_tpu_torch.parallel import zero
from kungfu_tpu_torch.parallel.train import (ParallelPlan, dp_train_step,
                                             per_rank_grads)
from kungfu_tpu_torch.plan import graph, hostfile, mst, topology
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten
from tests._util import run_all

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = [s for s in plan.Strategy if s != plan.Strategy.AUTO]
#: chunk bytes of the engine tests: 5003 f32 elements make five chunks,
#: so every multi-pair strategy spreads chunks over its pairs
CHUNK = 4096
#: the C++ executor and the Python path of the engine on the port
PATHS = ["python-channel", "native-channel-python-path", "native-channel-cxx"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    monkeypatch.setenv("KF_CONFIG_CHUNK_SIZE", str(CHUNK))
    # a failing rank fails its peers in seconds, not the default minute
    monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "20")
    for k in ("KF_CHAOS_SPEC", "KF_NATIVE_ENGINE", "KF_TPU_HOST_TRANSPORT",
              "KF_CONFIG_STRATEGY_HASH_METHOD", "KF_CONFIG_ENABLE_TRACE",
              "KF_TPU_NO_NATIVE"):
        monkeypatch.delenv(k, raising=False)
    yield
    chaos.reset()
    jchaos.reset()


# -- worlds ------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_channel(native_backend=False, retries=20):
    """A reference channel on a port found free (it takes no port 0)."""
    mk = jhost.NativeHostChannel if native_backend else jhost.PyHostChannel
    for _ in range(retries):
        pid = jplan.PeerID("127.0.0.1", _free_port())
        try:
            return mk(pid, bind_host="127.0.0.1")
        except OSError as e:
            if native_backend or e.errno == errno.EADDRINUSE:
                continue
            raise
    raise RuntimeError("no free port for a reference channel")


def _port_channel(native_backend=False):
    mk = host.NativeHostChannel if native_backend else host.PyHostChannel
    return mk(plan.PeerID("127.0.0.1", 0), bind_host="127.0.0.1")


def _ids(chans):
    return [(c.self_id.host, c.self_id.port) for c in chans]


def _engines(chans, strategy, ref):
    """One engine per channel over the shared peer list; ``ref[i]`` says
    whether channel i is the reference's."""
    ids = _ids(chans)
    jpeers = jplan.PeerList.of(*(jplan.PeerID(h, p) for h, p in ids))
    tpeers = plan.PeerList.of(*(plan.PeerID(h, p) for h, p in ids))
    return [jengine.CollectiveEngine(c, jpeers, jplan.Strategy(strategy.value))
            if r else engine.CollectiveEngine(c, tpeers, strategy)
            for c, r in zip(chans, ref)]


@contextmanager
def _world(kinds, strategy=plan.Strategy.STAR):
    """Channels and engines of one cluster; ``kinds[i]`` is one of
    ``ref-py``, ``ref-native``, ``port-py``, ``port-native``."""
    chans = []
    try:
        for k in kinds:
            owner, backend = k.split("-")
            chans.append(_ref_channel(backend == "native") if owner == "ref"
                         else _port_channel(backend == "native"))
        engs = _engines(chans, strategy, [k.startswith("ref") for k in kinds])
        yield engs
    finally:
        for c in chans:
            c.close()


def _bits(a) -> tuple:
    a = _np(a)
    return (None if a is None else (a.dtype.str, a.shape, a.tobytes()))


def _np(v):
    if v is None or isinstance(v, (bytes, str)):
        return v
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def _to_torch(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)

    def f(dt, size, scale=1.0):
        return [(rng.standard_normal(size) * scale).astype(dt)
                for _ in range(n)]

    return {
        "f32": f(np.float32, 5003),
        "f64": f(np.float64, 301),
        "f16": f(np.float16, 700, 10.0),
        "bf16": f(ml_dtypes.bfloat16, 700, 10.0),
        "i32": [rng.integers(-1000, 1000, 257).astype(np.int32)
                for _ in range(n)],
        "u8": [rng.integers(0, 255, 513).astype(np.uint8) for _ in range(n)],
    }


#: bf16 allreduces: the reference engine cannot take them (C14), so the
#: port's are held against the reference's graphs and kernel
BF16_OPS = ("sum", "max", "mean")


def _program(eng, r, d, to_in, bf16=False):
    """Every public collective of the engine, in one order on every
    rank; the results as numpy arrays keyed by name."""
    n = len(eng.peers)
    x = d["f32"][r]
    out = {}
    for op in ("sum", "min", "max", "prod", "mean"):
        out[f"ar.{op}"] = eng.all_reduce(to_in(x), op=op, name=f"ar.{op}")
    for key, op in (("f64", "sum"), ("f16", "sum"), ("f16", "mean"),
                    ("i32", "max"), ("i32", "mean"), ("u8", "sum")):
        out[f"ar.{key}.{op}"] = eng.all_reduce(
            to_in(d[key][r]), op=op, name=f"ar.{key}.{op}")
    for op in BF16_OPS if bf16 else ():
        out[f"bf16.{op}"] = eng.all_reduce(to_in(d["bf16"][r]), op=op,
                                           name=f"bf16.{op}")
    # in place, on a 2-D numpy buffer and on a non-contiguous view
    buf = x.reshape(5003, 1).copy()
    got = eng.all_reduce(buf, op="mean", name="ip.np", inplace=True)
    out["ip.np"] = buf if got is buf else "not the caller's buffer"
    big = to_in(np.stack([x, x]).T.copy())  # [5003, 2]
    view = big[:, 1]
    eng.all_reduce(view, op="sum", name="ip.view", inplace=True)
    out["ip.view"] = big
    try:
        eng.all_reduce(to_in(d["i32"][r]), op="mean", name="ip.int",
                       inplace=True)
        out["ip.int"] = "no error"
    except TypeError:
        out["ip.int"] = "TypeError"  # numpy's casting error
    out["bcast"] = eng.broadcast(to_in(x), root=1, name="bc")
    out["reduce"] = eng.reduce(to_in(x), root=2 % n, op="sum", name="rd")
    out["reduce.mean"] = eng.reduce(to_in(d["f64"][r]), root=0, op="mean",
                                    name="rdm")
    out["gather"] = eng.gather(to_in(x[:100].reshape(10, 10)), root=1,
                               name="ga")
    out["all_gather"] = eng.all_gather(to_in(d["bf16"][r][:99]), name="ag")
    out["rs.sum"] = eng.reduce_scatter(to_in(x), op="sum", name="rs")
    out["rs.mean"] = eng.reduce_scatter(to_in(d["f16"][r]), op="mean",
                                        name="rsm")
    eng.send_to((r + 1) % n, to_in(x[:37]), name=f"p2p.{r}")
    out["p2p"] = eng.recv_from((r - 1) % n, f"p2p.{(r - 1) % n}",
                               dtype=np.float32)
    eng.send_to((r + 1) % n, b"raw" * r, name=f"p2pb.{r}")
    out["p2p.bytes"] = eng.recv_from((r - 1) % n, f"p2pb.{(r - 1) % n}")
    hs = eng.send_async((r + 1) % n, to_in(x[:11]), name=f"as.{r}")
    hr = eng.recv_async((r - 1) % n, f"as.{(r - 1) % n}", dtype=np.float32)
    hs.wait()
    out["p2p.async"] = hr.wait()
    h1 = eng.all_reduce_async(to_in(x), op="sum", name="aar")
    h2 = eng.reduce_scatter_async(to_in(x), op="mean", name="ars")
    h3 = eng.all_gather_async(to_in(x[:50]), name="aag")
    out["async.ar"], out["async.rs"], out["async.ag"] = (
        h1.wait(timeout=60), h2.wait(timeout=60), h3.wait(timeout=60))
    assert eng.drain_async(timeout=60) == 0 and eng.inflight() == 0
    out["local_reduce"] = eng.local_reduce(to_in(x), op="mean", name="lr")
    out["local_bcast"] = eng.local_broadcast(to_in(x), name="lb")
    out["cross"] = eng.cross_all_reduce(to_in(x), op="sum", name="xa")
    return {k: _bits(v) if not isinstance(v, (bytes, str)) else v
            for k, v in out.items()}


def _run_program(kinds, strategy, d, port_input=_to_torch, bf16=False):
    with _world(kinds, strategy) as engs:
        res = run_all([
            (lambda i=i, e=e: _program(
                e, i, d, (lambda a: np.array(a)) if kinds[i].startswith("ref")
                else port_input, bf16))
            for i, e in enumerate(engs)], timeout=120)
        runs = [getattr(e, "native_runs", None) for e in engs]
    return res, runs


_REFERENCE = {}


def _reference(n, strategy):
    """The reference engine's results, on its native channel: its Python
    path cannot reduce an ml_dtypes bfloat16 array (``memoryview``
    rejects the dtype in ``PyHostChannel.recv_into``, ROADMAP C14), so
    its allreduces run in its C++ executor."""
    key = (n, strategy)
    if key not in _REFERENCE:
        _REFERENCE[key] = _run_program(["ref-native"] * n, strategy,
                                       _data(n))[0]
    return _REFERENCE[key]


def _ref_walk(bufs, strategy, op):
    """What the reference engine's ``_run_graphs`` computes on every rank,
    walked in one process with its graphs and its ``transform2``: the
    chunks of ``np.array_split``, each rank folding its prevs' values in
    order, the broadcast stage forwarding the result."""
    n = len(bufs)
    graphs = jengine.build_strategy_graphs(
        jplan.Strategy(strategy.value),
        jplan.PeerList.parse(",".join(f"127.0.0.1:{i + 1}" for i in range(n))))
    eff = "sum" if op == "mean" else op
    flats = [np.ascontiguousarray(b).reshape(-1) for b in bufs]
    n_chunks = max(1, -(-flats[0].nbytes // CHUNK))
    per = [np.array_split(f, n_chunks) for f in flats]
    outs = [[] for _ in bufs]
    for i in range(n_chunks):
        red, bc = graphs[i % len(graphs)]
        sent = {}

        def reduced(r):
            if r not in sent:
                acc = per[r][i].copy() if red.is_self_loop(r) else None
                for p in red.prevs(r):
                    got = reduced(p).copy()
                    acc = got if acc is None else jnative.transform2(
                        acc, got, eff)
                sent[r] = per[r][i].copy() if acc is None else acc
            return sent[r]

        def result(r):
            prevs = bc.prevs(r)
            return (result(prevs[0]) if not bc.is_self_loop(r) and prevs
                    else reduced(r))

        for r in range(n):
            outs[r].append(result(r))
    res = [np.concatenate(o) for o in outs]
    return [np.divide(o, n) if op == "mean" else o for o in res]


# ==========================================================================
# plan/: graphs, strategies, spanning tree, hostfile
# ==========================================================================

def _layouts(n):
    """Peer lists over one host, over contiguous host blocks, and
    interleaved over two hosts (tests/test_plan.py's shapes)."""
    one = ",".join(f"h0:{10000 + i}" for i in range(n))
    blocks = ",".join(f"h{i // 2}:{10000 + i}" for i in range(n))
    inter = ",".join(f"h{i % 2}:{10000 + i}" for i in range(n))
    return [one, blocks, inter]


def _graph_sig(g):
    return (len(g), [(g.is_self_loop(i), tuple(g.prevs(i)), tuple(g.nexts(i)))
                     for i in range(len(g))], g.digest_bytes())


def _pairs_sig(pairs):
    return [(_graph_sig(r), _graph_sig(b)) for r, b in pairs]


class TestPlan:
    def test_exports(self):
        assert plan.__all__ == jplan.__all__
        for name in plan.__all__:
            assert hasattr(plan, name)

    @pytest.mark.parametrize("n", range(1, 9))
    @pytest.mark.parametrize("strategy", list(plan.Strategy),
                             ids=lambda s: s.value)
    def test_strategy_graphs(self, strategy, n):
        """Every strategy's graph pairs and digests, for n in 1-8, on one
        host and on several, and the engine's serialized adjacency of
        every rank, byte for byte."""
        js = jplan.Strategy(strategy.value)
        for spec in _layouts(n):
            tp, jp = plan.PeerList.parse(spec), jplan.PeerList.parse(spec)
            got = engine.build_strategy_graphs(strategy, tp)
            want = jengine.build_strategy_graphs(js, jp)
            assert _pairs_sig(got) == _pairs_sig(want), spec
            assert (_pairs_sig(engine.build_cross_strategy_graphs(strategy,
                                                                  tp))
                    == _pairs_sig(jengine.build_cross_strategy_graphs(js,
                                                                      jp)))
            for r in range(n):
                a = engine.CollectiveEngine._serialize_graphs(
                    types.SimpleNamespace(rank=r), got)
                b = jengine.CollectiveEngine._serialize_graphs(
                    types.SimpleNamespace(rank=r), want)
                assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))

    GENERATORS = {
        "star": lambda t: [t.gen_star(5), t.gen_star(5, center=3),
                           t.gen_star(1)],
        "tree": lambda t: [t.gen_tree(6), t.gen_tree(6, [[0, 1, 2], [3, 4, 5]]),
                           t.gen_tree(5, [[0, 3], [1, 2, 4]])],
        "binary_tree": lambda t: [t.gen_binary_tree(7),
                                  t.gen_binary_tree(8, [7, 1, 5, 0, 2])],
        "binary_tree_star": lambda t: [
            t.gen_binary_tree_star(n, h) for n, h in
            [(4, [[0, 1], [2, 3]]), (8, [[0, 1, 2, 3], [4, 5, 6, 7]]),
             (1, [[0]]), (5, [[0, 4], [], [1, 2, 3]])]],
        "multi_binary_tree_star": lambda t: t.gen_multi_binary_tree_star(
            6, [[0, 1], [2, 3], [4, 5]]),
        "multi_star": lambda t: t.gen_multi_star(3) + t.gen_multi_star(
            6, [[0, 1], [2, 3], [4, 5]]),
        "circular": lambda t: [t.gen_circular_graph_pair(5, shift=s)
                               for s in range(5)]
        + [t.gen_circular_graph_pair(6, ranks=[5, 2, 0], shift=1)],
        "clique": lambda t: t.gen_clique(4),
        "cross_ring": lambda t: t.gen_cross_ring_pairs(6, [0, 2, 4]),
        "cross_binary_tree": lambda t: t.gen_cross_binary_tree(
            9, [0, 3, 6, 7, 8]),
    }

    @pytest.mark.parametrize("name", sorted(GENERATORS))
    def test_generators(self, name):
        assert (_pairs_sig(self.GENERATORS[name](topology))
                == _pairs_sig(self.GENERATORS[name](jtopology)))

    def test_default_reduce_graph_and_graph_ops(self):
        tb, jb = topology.gen_star(4)[1], jtopology.gen_star(4)[1]
        assert (_graph_sig(topology.gen_default_reduce_graph(tb))
                == _graph_sig(jtopology.gen_default_reduce_graph(jb)))
        f = [0, 0, 1, 1, 3]
        tg, jg = (graph.Graph.from_forest_array(f),
                  jgraph.Graph.from_forest_array(f))
        assert _graph_sig(tg) == _graph_sig(jg)
        assert tg.to_forest_array() == jg.to_forest_array() == f
        assert _graph_sig(tg.reverse()) == _graph_sig(jg.reverse())
        merged = graph.merge_graphs(topology.gen_circular_graph_pair(4))
        jmerged = jgraph.merge_graphs(jtopology.gen_circular_graph_pair(4))
        assert _graph_sig(merged) == _graph_sig(jmerged)
        for bad in ([1, 0], [5, 0]):
            with pytest.raises(ValueError):
                graph.Graph.from_forest_array(bad)
            with pytest.raises(ValueError):
                jgraph.Graph.from_forest_array(bad)

    @pytest.mark.parametrize("seed", range(4))
    def test_minimum_spanning_tree(self, seed):
        w = np.random.default_rng(seed).random((7, 7))
        assert mst.minimum_spanning_tree(w) == jmst.minimum_spanning_tree(w)
        w[3, :] = w[:, 3] = np.inf
        with pytest.raises(ValueError):
            mst.minimum_spanning_tree(w)
        with pytest.raises(ValueError):
            jmst.minimum_spanning_tree(w)

    def test_parse_hostfile_text(self):
        text = ("192.168.1.10 slots=4\n# comment\n\n10.0.0.2  # one slot\n"
                "host-c slots=2 other=1\n")
        got, want = (hostfile.parse_hostfile_text(text),
                     jhostfile.parse_hostfile_text(text))
        assert str(got) == str(want)
        assert [(h.ip, h.slots) for h in got.hosts] == [
            (h.ip, h.slots) for h in want.hosts]

    @pytest.mark.parametrize("s", ["ring", "binary-tree-star", " STAR ",
                                   "auto", "bogus"])
    def test_parse_strategy_and_auto(self, s):
        try:
            want = jplan.parse_strategy(s).value
        except ValueError:
            with pytest.raises(ValueError):
                plan.parse_strategy(s)
            return
        assert plan.parse_strategy(s).value == want
        for hosts in (1, 2, 5):
            assert plan.auto_select(hosts).value == jplan.auto_select(
                hosts).value


# ==========================================================================
# native/: transform2 and the build
# ==========================================================================

DTYPES = [np.uint8, np.int8, np.int16, np.int32, np.int64, np.uint16,
          np.uint32, np.uint64, np.float16, np.float32, np.float64,
          ml_dtypes.bfloat16]


def _operands(dt, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dt).kind in "iu":
        info = np.iinfo(dt)
        return [rng.integers(info.min, info.max, 1031, dtype=np.int64)
                .astype(dt) if info.bits < 64 else
                rng.integers(info.min, info.max, 1031, dtype=dt)
                for _ in range(2)]
    a, b = ((rng.standard_normal(1031) * 300).astype(dt) for _ in range(2))
    # NaN of both signs, infinities, signed zeros; where both operands
    # are NaN they are the same NaN (which of two different NaNs a sum
    # carries is the vectorizer's choice, native/__init__.py)
    a[::17], b[::13] = np.nan, -np.nan
    both = np.isnan(a) & np.isnan(b)
    b[both] = a[both]
    a[5], b[5], a[6], b[7] = np.inf, -np.inf, -0.0, 0.0
    return [a, b]


class TestTransform2:
    def test_dtype_codes(self):
        assert native.available() and jnative.available()
        assert native._OP_CODES == jnative._OP_CODES
        assert native.REDUCE_OPS == jnative.REDUCE_OPS
        for dt in DTYPES:
            t = native.as_tensor(np.zeros(1, dt))
            assert native._DTYPE_CODES[t.dtype] == jnative._DTYPE_CODES[
                np.dtype(dt)]
        assert native._DTYPE_CODES[torch.bfloat16] == 11

    @pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
    @pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
    def test_bitwise_with_reference(self, dt, op):
        """Native against the reference, on numpy and on torch buffers,
        and the numpy fallback against the native loop (NaN propagation
        of min/max included)."""
        a, b = _operands(dt, 0)
        want = jnative.transform2(a.copy(), b.copy(), op)
        got = native.transform2(a.copy(), b.copy(), op)
        assert got.tobytes() == want.tobytes()
        t = _to_torch(a)
        assert native.transform2(t, _to_torch(b), op) is t
        assert _np(t).tobytes() == want.tobytes()
        fb = native.as_tensor(a.copy())
        native._fallback(native.np_view(fb), native.np_view(_to_torch(b)),
                         native._DTYPE_CODES[fb.dtype], op)
        assert _np(fb).tobytes() == want.tobytes()

    def test_no_native_env(self, monkeypatch):
        """``KF_TPU_NO_NATIVE=1``: no library, the fallback, the same
        bits; the Python channel from the factory's auto."""
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setenv("KF_TPU_NO_NATIVE", "1")
        assert native.load() is None and not native.available()
        for dt in (np.float16, ml_dtypes.bfloat16, np.int8):
            a, b = _operands(dt, 1)
            want = jnative.transform2(a.copy(), b.copy(), "sum")
            assert native.transform2(a.copy(), b, "sum").tobytes() \
                == want.tobytes()
        ch = host.HostChannel(plan.PeerID("127.0.0.1", 0),
                              bind_host="127.0.0.1")
        try:
            assert isinstance(ch, host.PyHostChannel)
        finally:
            ch.close()

    def test_uncoded_and_bad_args(self):
        a = np.array([True, False, True])
        assert native.transform2(a.copy(), np.array([False, False, True]),
                                 "sum").tolist() == jnative.transform2(
            a.copy(), np.array([False, False, True]), "sum").tolist()
        with pytest.raises(ValueError):
            native.transform2(np.zeros(3, np.float32), np.zeros(4, np.float32),
                              "sum")
        with pytest.raises(ValueError):
            native.transform2(np.zeros(3, np.float32), np.zeros(3, np.int32),
                              "sum")

    def test_build_flags_match_the_makefile(self):
        text = (ROOT / "kungfu_tpu" / "native" / "Makefile").read_text()
        for flag in native._cxx_flags():
            assert flag in text
        assert (Path(native.lib_path()).parent
                == ROOT / "kungfu_tpu_torch" / "native" / "_build")
        assert (ROOT / "kungfu_tpu_torch" / "native" / "reduce.cpp"
                ).read_text().split("\n", 4)[4] == (
            ROOT / "kungfu_tpu" / "native" / "reduce.cpp"
        ).read_text().split("\n", 2)[2]


# ==========================================================================
# chaos/
# ==========================================================================

SPECS = [
    "die:coll=3,rank=2,mode=raise;reset:send=2,peer=0;"
    "delay:ms=200,jitter=50,every=2;drop_fanout:host=h,count=1;"
    "config_down:after=2,count=3",
    "die:coll=1,rank=2,mode=raise",
    "delay:ms=100,peer=1,every=2",
    "delay:ms=300,rank=1",
    "reset:send=1,rank=0",
    "preempt:all,step=4,mode=raise",
    "die_slice:slice=1,rps=2,coll=3,mode=raise",
    "delay:ms=5,on=recv,after_step=2",
    "drop_request:count=2,every=3",
    "explode:now=1", "die:when=5", "delay:ms=fast", "die:mode=sideways",
    ";;", "preempt:step=3", "die_slice:coll=1", "delay:ms=1,on=sideways",
]


class TestChaos:
    @pytest.mark.parametrize("spec", SPECS)
    def test_spec_parses_like_the_reference(self, spec):
        try:
            want = [(c.kind, c.params) for c in jchaos.parse_spec(spec)]
        except ValueError:
            with pytest.raises(ValueError):
                chaos.parse_spec(spec)
            return
        assert [(c.kind, c.params) for c in chaos.parse_spec(spec)] == want

    @pytest.mark.parametrize("rank", [0, 1, 2, None])
    def test_seeded_controller_decisions(self, rank, monkeypatch):
        """The same event stream through both controllers, seed 7: the
        same delays (jitter included), resets and deaths, in the same
        order.  The clauses whose hooks the port has not reached yet
        (``die_slice``, ``drop_fanout``, ``config_down``, ``on=ping``)
        are in the spec and fire nowhere on this stream."""
        spec = ("delay:ms=5,jitter=50,every=2;reset:send=3,peer=1;"
                "die:coll=4,rank=1,mode=raise;config_down:after=1,count=2;"
                "drop_fanout:host=h,count=1;delay:ms=7,on=recv,after_step=2;"
                "delay:ms=3,on=ping,peer=2;die:step=5,rank=2,mode=raise;"
                "die_slice:slice=9,rps=2,coll=5,mode=raise")
        logs = []
        for mod, parse in ((chaos.inject, chaos.parse_spec),
                           (jchaos.inject, jchaos.parse_spec)):
            log = []
            monkeypatch.setattr(mod.time, "sleep",
                                lambda s, log=log: log.append(("sleep", s)))
            ctl = mod.ChaosController(parse(spec), rank=rank, seed=7)
            events = [("coll", "a"), ("send", 1), ("send", 2), ("recv", 0),
                      ("send", 1), ("step", 2), ("recv", 1), ("coll", "b"),
                      ("coll", "c"), ("send", 1), ("coll", "d"),
                      ("step", 5), ("coll", "e"), ("send", 0), ("recv", 2)]
            for ev in events:
                try:
                    if ev[0] == "coll":
                        ctl.on_collective(ev[1])
                    elif ev[0] == "send":
                        ctl.on_send(ev[1], "t", b"xyz")
                    elif ev[0] == "recv":
                        ctl.on_recv(ev[1], "t")
                    else:
                        ctl.on_step(ev[1])
                except Exception as e:  # noqa: BLE001 - the decision
                    log.append((type(e).__name__, str(e)))
            logs.append(log)
        assert logs[0] == logs[1]
        assert any(e[0] == "sleep" for e in logs[0])

    def test_controller_for_and_note_step(self, monkeypatch):
        assert chaos.controller_for(0) is None
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:step=3,mode=raise")
        c = chaos.controller_for(1)
        assert c is chaos.controller_for(1) and c is not chaos.controller_for(2)
        chaos.note_step(1, 2)
        assert timeline.current_step() == 2
        with pytest.raises(chaos.InjectedDeath):
            chaos.note_step(1, 3)
        chaos.reset()
        assert chaos.controller_for(1) is not c
        assert chaos.DIE_EXIT_CODE == jchaos.DIE_EXIT_CODE
        assert (chaos.SPEC_ENV, chaos.SEED_ENV) == (jchaos.SPEC_ENV,
                                                    jchaos.SEED_ENV)
        timeline.set_step(-1)


# ==========================================================================
# the engine
# ==========================================================================

class TestEngine:
    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
    @pytest.mark.parametrize("n", [3, 4])
    def test_collectives_match_reference(self, n, strategy, path,
                                         monkeypatch):
        """Every public collective over n loopback ranks, bitwise equal to
        the reference engine's on the same numpy inputs."""
        want = _reference(n, strategy)
        if path == "native-channel-python-path":
            monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        kind = "port-py" if path == "python-channel" else "port-native"
        d = _data(n)
        got, runs = _run_program([kind] * n, strategy, d, bf16=True)
        for op in BF16_OPS:
            walk = _ref_walk(d["bf16"], strategy, op)
            for r in range(n):
                assert got[r].pop(f"bf16.{op}") == _bits(walk[r]), (r, op)
        for r in range(n):
            assert got[r].keys() == want[r].keys()
            for k in want[r]:
                assert got[r][k] == want[r][k], (r, k)
        # the C++ executor took every allreduce it can take (the 12
        # coded allreduces, the async one and the in-place ones), and no
        # other path took any
        assert all((m > 0) == (path == "native-channel-cxx") for m in runs)

    @pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
    def test_mixed_cluster(self, strategy):
        """Two reference engines (its Python and its C++ path) and two
        port engines (the Python channel and the C++ executor) in one
        allreduce: every rank ends with the same bits, those of the
        plain graph walk."""
        d = _data(4, seed=3)
        kinds = ["ref-py", "port-native", "ref-native", "port-py"]
        with _world(kinds, strategy) as engs:
            res = run_all([
                (lambda i=i, e=e: [_np(e.all_reduce(
                    np.array(d[k][i]) if kinds[i].startswith("ref")
                    else _to_torch(d[k][i]), op=op, name=f"mx.{k}.{op}"))
                    for k, op in (("f32", "sum"), ("f16", "sum"),
                                  ("f32", "mean"), ("i32", "min"))])
                for i, e in enumerate(engs)], timeout=120)
            graphs = engs[1]._graphs
            assert engs[1].native_runs == 4 and engs[3].native_runs == 0
        for j, (k, op) in enumerate((("f32", "sum"), ("f16", "sum"),
                                     ("f32", "mean"), ("i32", "min"))):
            plain = engine.graph_all_reduce_reference(
                [_to_torch(a) for a in d[k]], graphs, op, chunk_size=CHUNK)
            for r in range(4):
                assert _bits(res[r][j]) == _bits(plain[r]), (k, op, r)

    @pytest.mark.parametrize("hash_mode", ["NAME", ""])
    def test_name_hash_and_stats(self, hash_mode, monkeypatch):
        """The chunk -> pair hash (round robin, or by name) and the
        per-pair stats fill the same pairs as the reference's."""
        monkeypatch.setenv("KF_CONFIG_STRATEGY_HASH_METHOD", hash_mode)
        d = _data(4, seed=5)
        out = {}
        for owner in ("ref", "port"):
            with _world([f"{owner}-py"] * 4, plan.Strategy.RING) as engs:
                res = run_all([
                    (lambda i=i, e=e: _bits(e.all_reduce(
                        np.array(d["f32"][i]) if owner == "ref"
                        else _to_torch(d["f32"][i]), name="grad.w")))
                    for i, e in enumerate(engs)])
                out[owner] = (res, [[b for b, _ in e.stats] for e in engs],
                              [[b for b, _ in e.window_peek()] for e in engs])
        assert out["port"] == out["ref"]
        plain = engine.graph_all_reduce_reference(
            [_to_torch(a) for a in d["f32"]],
            engine.build_strategy_graphs(plan.Strategy.RING,
                                         plan.PeerList.parse(
                                             "h:1,h:2,h:3,h:4")),
            chunk_size=CHUNK, name="grad.w" if hash_mode else None)
        assert [_bits(p) for p in plain] == out["port"][0]

    @pytest.mark.parametrize("channel", ["port-py", "port-native"])
    def test_swap_and_adaptation_hooks(self, channel):
        """``set_strategy`` at a boundary, the swap epoch, throughputs and
        the window: the next allreduce walks the new graphs."""
        d = _data(3, seed=9)
        with _world([channel] * 3, plan.Strategy.STAR) as engs:
            def rank(i, e):
                x = _to_torch(d["f32"][i])
                e.all_reduce(x, name="s0")
                assert e.swap_eligible(1) and not e.swap_eligible(2)
                assert len(e.throughputs()) == 1 and e.best_throughputs[0] > 0
                e.set_strategy(plan.Strategy.RING)
                assert e.collectives_since_swap() == 0 and len(e.stats) == 3
                y = e.all_reduce(x, name="s1")
                e.mark_swap()
                return _bits(y), e.total_throughputs()
            res = run_all([lambda i=i, e=e: rank(i, e)
                           for i, e in enumerate(engs)])
            graphs = engs[0]._graphs
        plain = engine.graph_all_reduce_reference(
            [_to_torch(a) for a in d["f32"]], graphs, chunk_size=CHUNK)
        assert [r[0] for r in res] == [_bits(p) for p in plain]
        assert all(any(t > 0 for t in r[1]) for r in res)

    def test_overlap_window(self):
        """A depth-1 window serializes the async handles; the gauge and
        the in-flight count return to 0; a bad depth raises."""
        d = _data(2, seed=2)
        with _world(["port-native", "port-py"]) as engs:
            def rank(i, e):
                e.set_overlap_depth(1)
                hs = [e.all_reduce_async(_to_torch(d["f32"][i]), name=f"w{k}")
                      for k in range(4)]
                outs = [_bits(h.wait(timeout=60)) for h in hs]
                assert all(h.done() and h.error() is None for h in hs)
                return outs
            res = run_all([lambda i=i, e=e: rank(i, e)
                           for i, e in enumerate(engs)])
            assert res[0] == res[1] and len(set(res[0])) == 1
            assert all(e.inflight() == 0 and e.overlap_depth == 1
                       for e in engs)
            with pytest.raises(ValueError):
                engs[0].set_overlap_depth(0)
        assert REGISTRY.gauge("kf_overlap_inflight").value == 0

    def test_errors_match_reference(self):
        with _world(["port-py"]) as (e,):
            with pytest.raises(ValueError):
                e.all_reduce(torch.zeros(3), op="avg")
            ro = np.zeros(3, np.float32)
            ro.flags.writeable = False
            with pytest.raises(ValueError, match="writable"):
                e.all_reduce(ro, inplace=True)
            assert np.array_equal(e.all_reduce(ro), ro)  # one rank: identity
            with pytest.raises(ValueError):
                e.reduce_scatter(torch.zeros(3), op="avg")
            with pytest.raises(ValueError):
                engine.CollectiveEngine(
                    e.channel, plan.PeerList.parse("127.0.0.1:1"))

    def test_deadline_and_retry_events(self, monkeypatch):
        """A peer that never sends: the recv's deadline raises a typed
        failure naming it, ticks ``kf_peer_faults_total`` with tracing
        off, and records a ``deadline`` event with tracing on."""
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "0.3")
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()
        before = REGISTRY.counter("kf_peer_faults_total").value
        with _world(["port-py", "port-native"]) as engs:
            with pytest.raises(PeerFailureError) as ei:
                engs[0].recv_from(1, "never")
            assert ei.value.rank == 1 and ei.value.phase == "recv"
        assert REGISTRY.counter("kf_peer_faults_total").value == before + 1
        ev = [e for e in timeline.snapshot() if e["kind"] == "deadline"]
        assert ev and ev[0]["attrs"]["peer"] == 1
        timeline.reset()

    @pytest.mark.parametrize("spec", ["delay:ms=1,on=send",
                                      "reset:send=2,rank=0",
                                      "delay:ms=1,on=recv,every=3"])
    def test_chaos_pins_the_python_path(self, spec, monkeypatch):
        """With chaos on, the native channel's engine takes the Python
        path (the hooks live there); a reset mid-chunk is retried; the
        result is the plain walk's."""
        monkeypatch.setenv("KF_CHAOS_SPEC", spec)
        d = _data(3, seed=4)
        with _world(["port-native", "port-py", "port-native"],
                    plan.Strategy.RING) as engs:
            res = run_all([
                (lambda i=i, e=e: _bits(e.all_reduce(
                    _to_torch(d["f32"][i]), name="chaos")))
                for i, e in enumerate(engs)])
            assert [e.native_runs for e in engs] == [0, 0, 0]
            graphs = engs[0]._graphs
        plain = engine.graph_all_reduce_reference(
            [_to_torch(a) for a in d["f32"]], graphs, chunk_size=CHUNK)
        assert res == [_bits(p) for p in plain]

    def test_die_at_collective(self, monkeypatch):
        """``die:coll=2,rank=1,mode=raise`` kills rank 1 at its second
        collective; its peers see a typed failure, not a hang."""
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:coll=2,rank=1,mode=raise")
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "1")
        with _world(["port-py"] * 3) as engs:
            def rank(i, e):
                e.all_reduce(torch.ones(10), name="c1")
                try:
                    e.all_reduce(torch.ones(10), name="c2")
                except chaos.InjectedDeath:
                    return "died"
                except PeerFailureError as err:
                    return ("failed", err.rank)
                return "ok"
            res = run_all([lambda i=i, e=e: rank(i, e)
                           for i, e in enumerate(engs)])
        assert res[1] == "died"
        assert all(r[0] == "failed" for r in (res[0], res[2]))

    def test_timeline_events_match_reference(self, monkeypatch):
        """With tracing on, the engine's ``collective`` and ``overlap``
        events carry the reference's names, ranks, ops, tags, sizes and
        cross-rank trace ids."""
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        d = _data(2, seed=6)
        evs = {}
        for owner, tl in (("ref", jtimeline), ("port", timeline)):
            tl.reset()
            tl.set_step(4)
            with _world([f"{owner}-py"] * 2) as engs:
                def rank(i, e, owner=owner):
                    x = (np.array(d["f32"][i]) if owner == "ref"
                         else _to_torch(d["f32"][i]))
                    e.all_reduce(x, name="ev")
                    e.broadcast(x, name="evb")
                    e.reduce_scatter_async(x, name="evr").wait(timeout=30)
                run_all([lambda i=i, e=e: rank(i, e)
                         for i, e in enumerate(engs)])
            keep = ("op", "tag", "nbytes", "trace", "inflight", "error")
            evs[owner] = sorted(
                ((e["kind"], e["name"], e["rank"], e["step"],
                  tuple((k, e["attrs"].get(k)) for k in keep))
                 for e in tl.snapshot()
                 if e["kind"] in ("collective", "overlap")), key=repr)
            tl.reset()
        assert evs["port"] == evs["ref"] and len(evs["port"]) >= 8


# ==========================================================================
# the channels
# ==========================================================================

class TestNativeChannel:
    @pytest.mark.parametrize("peer", ["ref-native", "ref-py", "port-py"])
    def test_frames_both_ways(self, peer):
        """A port NativeHostChannel on port 0 and another endpoint
        exchange frames each way: bytes, a numpy buffer, a zero-copy
        receive into a tensor, a size mismatch left queued, pings."""
        ours = _port_channel(True)
        other = (_ref_channel(peer == "ref-native") if peer.startswith("ref")
                 else _port_channel(False))
        try:
            assert ours.self_id.port > 0
            them = plan.PeerID(other.self_id.host, other.self_id.port)
            mk = jplan.PeerID if peer.startswith("ref") else plan.PeerID
            us = mk(ours.self_id.host, ours.self_id.port)
            payload = np.arange(4097, dtype=np.float32)
            ours.send(them, "to.other", payload)
            got = other.recv(us, "to.other", timeout=10)
            assert bytes(got) == payload.tobytes()
            other.send(us, "to.port", payload.tobytes()[::-1])
            assert ours.recv(them, "to.port", timeout=10) \
                == payload.tobytes()[::-1]
            other.send(us, "into", payload.tobytes())
            buf = torch.zeros(4097)
            assert ours.recv_into(them, "into", host.tensor_buffer(buf),
                                  timeout=10)
            assert torch.equal(buf, torch.from_numpy(payload))
            other.send(us, "short", b"abc")
            assert not ours.recv_into(them, "short", host.tensor_buffer(buf),
                                      timeout=10)
            assert ours.recv(them, "short", timeout=10) == b"abc"
            assert ours.ping(them) and other.ping(us)
            with pytest.raises(TimeoutError):
                ours.recv(them, "nothing", timeout=0.1)
        finally:
            ours.close()
            other.close()

    def test_factory_auto_gives_native(self, monkeypatch):
        """``HostChannel()`` with no env gives the native channel where
        the library builds, as the reference's ``_backend()`` does;
        ``KF_TPU_HOST_TRANSPORT`` picks either."""
        assert host._backend() == jhost._backend() == "native"
        for mode, cls in ((None, host.NativeHostChannel),
                          ("python", host.PyHostChannel),
                          ("native", host.NativeHostChannel),
                          ("auto", host.NativeHostChannel)):
            if mode is not None:
                monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", mode)
            mon = object()
            ch = host.HostChannel(plan.PeerID("127.0.0.1", 0),
                                  bind_host="127.0.0.1", monitor=mon)
            try:
                assert type(ch) is cls and ch.monitor is mon
                assert ch.self_id.port > 0
            finally:
                ch.close()

    def test_unix_socket(self, monkeypatch, tmp_path):
        """Colocated native channels meet on the sockfile the Python
        side names (``unix_sock_path``), as the reference's do."""
        # a relative directory keeps the sockfile path short whatever the
        # temp root (AF_UNIX paths stop at 107 bytes)
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "1")
        monkeypatch.setenv("KF_SOCK_DIR", "s")
        a, b = _port_channel(True), _port_channel(True)
        try:
            for c in (a, b):
                path = host.unix_sock_path(c.self_id.host, c.self_id.port)
                assert path == jhost.unix_sock_path(c.self_id.host,
                                                    c.self_id.port)
                assert os.path.exists(path)
            a.send(b.self_id, "u", b"over unix")
            assert b.recv(a.self_id, "u", timeout=10) == b"over unix"
        finally:
            a.close()
            b.close()
        assert host.unixsock_enabled()
        monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "no")
        assert not host.unixsock_enabled() and not jhost.unixsock_enabled()

    def test_token_fencing(self):
        a, b = _port_channel(True), _port_channel(False)
        try:
            a.set_token(3)
            assert a.token == 3
            b.set_token(3)
            a.send(b.self_id, "f", b"epoch3")
            assert b.recv(a.self_id, "f", timeout=10) == b"epoch3"
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("n,floor", [(1, 2), (4, 8), (40, 8), (12, 2)])
    def test_host_pool_size(self, n, floor, monkeypatch):
        assert host.host_pool_size(n, floor, "t") == jhost.host_pool_size(
            n, floor, "t")
        monkeypatch.setenv("KF_CONFIG_HOST_POOL_MAX", "3")
        assert host.host_pool_size(n, floor, "t") == jhost.host_pool_size(
            n, floor, "t")


# ==========================================================================
# the host-plane ZeRO buckets and the noise scale
# ==========================================================================

def _zero2_run(kinds, pipelined, steps=3):
    """bench.py payload_overlap's ZeRO-2 loop over three ranks (exact
    binary fractions, STAR): the final params of every rank."""
    n, chunk = 3, 1200
    widths = [300, 500, 400]
    total = n * chunk
    lr, mu = 0.125, 0.5  # exact binary fractions

    def one(i, eng, ref):
        mod = jzero if ref else zero
        params = (np.arange(total, dtype=np.float32) % 64) / 64
        mom = np.zeros(chunk, np.float32)
        if not ref:
            params, mom = torch.from_numpy(params), torch.from_numpy(mom)
        for k in range(steps):
            g = params * 0.5 + 2.0 ** -(k + 2)
            own = params[i * chunk:(i + 1) * chunk].clone() if not ref \
                else params[i * chunk:(i + 1) * chunk].copy()

            def compute(b, red, own=own):
                off, w = mod.host_bucket_spans(chunk, widths)[b]
                m = mom[off:off + w] * mu + red
                mom[off:off + w] = m
                own[off:off + w] -= lr * m

            mod.host_bucket_pipeline(eng, g, widths, compute,
                                     pipelined=pipelined, name=f"zr{k}")
            params = mod.host_bucket_all_gather(eng, own, widths,
                                                pipelined=pipelined,
                                                name=f"zg{k}")
        assert eng.inflight() == 0
        return _bits(params)

    with _world(kinds) as engs:
        return run_all([
            (lambda i=i, e=e: one(i, e, kinds[i].startswith("ref")))
            for i, e in enumerate(engs)], timeout=120)


class TestHostBuckets:
    def test_spans(self):
        assert zero.host_bucket_spans(10, [3, 3, 4]) == \
            jzero.host_bucket_spans(10, [3, 3, 4])
        for mod in (zero, jzero):
            with pytest.raises(ValueError):
                mod.host_bucket_spans(10, [3, 3])

    @pytest.mark.parametrize("kind", ["port-py", "port-native"])
    @pytest.mark.parametrize("pipelined", [True, False])
    def test_zero2_loop_bitwise(self, kind, pipelined):
        """The bucketed reduce-scatter and all-gather loop, pipelined and
        serial, bitwise equal to the reference's serial loop."""
        want = _zero2_run(["ref-py"] * 3, False)
        got = _zero2_run([kind] * 3, pipelined)
        assert got == want and len(set(got)) == 1

    def test_numpy_buffers_and_depth(self):
        d = _data(3, seed=8)
        widths = [1000, 667]
        outs = {}
        for owner, mod in (("ref", jzero), ("port", zero)):
            with _world([f"{owner}-py"] * 3) as engs:
                outs[owner] = run_all([
                    (lambda i=i, e=e, mod=mod: [
                        _bits(r) for r in mod.host_bucket_pipeline(
                            e, d["f32"][i][:5001], widths,
                            lambda b, red: red, depth=3, op="mean")])
                    for i, e in enumerate(engs)])
                with pytest.raises(ValueError):
                    mod.host_bucket_pipeline(engs[0], d["f32"][0][:5000],
                                             widths, None)
        assert outs["port"] == outs["ref"]

    @pytest.mark.parametrize("n", [1, 4])
    def test_host_noise_scale(self, n):
        """``host_noise_scale`` on each rank equals the reference's, with
        f32 and bf16 gradients as tensors; ``None`` on one worker."""
        d = _data(n, seed=11)
        res = {}
        for owner, fn in (("ref", jmonitor.host_noise_scale),
                          ("port", tmonitor.host_noise_scale)):
            with _world([f"{owner}-py"] * n) as engs:
                avg = np.mean(np.stack(d["f32"]), 0)
                res[owner] = run_all([
                    (lambda i=i, e=e: fn(
                        e, d["f32"][i] if owner == "ref"
                        else _to_torch(d["f32"][i]),
                        avg if owner == "ref" else torch.from_numpy(avg), 8))
                    for i, e in enumerate(engs)])
        assert res["port"] == res["ref"]
        if n == 1:
            assert res["port"] == [None]


# ==========================================================================
# faults of earlier slices repaired here
# ==========================================================================

class TestRepairs:
    def test_pulse_event_with_tracing_on(self, monkeypatch):
        """The port's timeline knew only three kinds, so a pulse sample
        with tracing on raised ValueError; it records now."""
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()
        out = PulseMonitor(every=1).update(2.0, 1.0, 8, 4, step=3)
        assert out["gns_raw"] is not None
        assert [e["kind"] for e in timeline.snapshot()] == ["pulse"]
        assert timeline.EVENT_KINDS == jtimeline.EVENT_KINDS
        timeline.reset()

    def test_trace_dump(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        monkeypatch.setenv("KF_CONFIG_TRACE_DUMP", str(tmp_path))
        timeline.reset()
        assert timeline.maybe_dump() is None  # empty ring
        timeline.set_rank(2)
        timeline.event("mark", "m")
        path = timeline.maybe_dump()
        assert path and Path(path).name.startswith("trace-r2-")
        assert len(Path(path).read_text().splitlines()) == 2
        assert timeline.current_rank() == 2
        timeline.set_rank(None)
        timeline.reset()
        assert timeline.collective_trace_id(1, 2, "op", "t") == \
            jtimeline.collective_trace_id(1, 2, "op", "t")

    def test_plan_message_points_at_the_roadmap(self):
        cfg = ttr.TransformerConfig(vocab_size=8, d_model=8, n_layers=1,
                                    n_heads=2, d_ff=8)
        from kungfu_tpu_torch.comm.device import Communicator

        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            dp_train_step(ttr.Transformer(cfg).loss, sgd(0.1),
                          Communicator(devices=["cpu"]),
                          plan=ParallelPlan(tp=2))


# ==========================================================================
# the slice: system.py's quick BERT, four ranks, gradients through engines
# ==========================================================================

#: benchmarks/system.py:71-74, in f32 for parity
_BERT = dict(vocab_size=1000, d_model=128, n_layers=2, n_heads=4, d_ff=256,
             max_seq=128, causal=False, pos="learned", dtype="float32")
#: test_torch_port_replicas.py's TRAIN_ATOL
TRAIN_ATOL = 1e-4
SLICE_ROWS, SLICE_SEQ, SLICE_STEPS = 2, 32, 3


class TestSlice:
    def test_quick_bert_host_engine_steps(self, monkeypatch):
        """Three steps of system.py's ``--backend host`` loop on its quick
        BERT at four ranks, the real model's gradient in place of the
        fake sizes: each rank's flat gradient is mean-allreduced in place
        by its engine (four port engines; four reference engines on the
        JAX side), then ``sgd(1e-3, momentum=0.9)`` applies it.  The port
        engines fed the reference's gradient bytes give the reference
        engines' bits; the params stay within the replicas test's
        tolerance."""
        n = 4
        # 64 KiB chunks: the 1.8 MB gradient in 28 chunks
        monkeypatch.setenv("KF_CONFIG_CHUNK_SIZE", str(64 << 10))
        tcfg, jcfg = ttr.TransformerConfig(**_BERT), jtr.TransformerConfig(
            **_BERT)
        tmodel, jmodel = ttr.Transformer(tcfg), jtr.Transformer(jcfg)
        jp = jmodel.init(jax.random.PRNGKey(0))
        tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu")
        rng = np.random.default_rng(0)
        batches = [tuple(rng.integers(0, _BERT["vocab_size"],
                                      size=(n * SLICE_ROWS, SLICE_SEQ))
                         for _ in range(2)) for _ in range(SLICE_STEPS)]
        jtx, ttx = optax.sgd(1e-3, momentum=0.9), sgd(1e-3, momentum=0.9)
        js, ts = jtx.init(jp), ttx.init(tp)
        jleaves, jdef = jax.tree_util.tree_flatten(jp)
        tleaves, tdef = tree_flatten(tp)
        jgrad = jax.jit(jax.grad(
            lambda p, b: jmodel.loss(p, b, attn_fn=jtr.default_attention)))

        def jflat_grads(params, ids, tgt):
            out = []
            for r in range(n):
                sl = slice(r * SLICE_ROWS, (r + 1) * SLICE_ROWS)
                g = jgrad(params, (jnp.asarray(ids[sl], jnp.int32),
                                   jnp.asarray(tgt[sl], jnp.int32)))
                out.append(np.concatenate([np.asarray(l, np.float32).ravel()
                                           for l in
                                           jax.tree_util.tree_leaves(g)]))
            return out

        def tflat_grads(params, ids, tgt):
            shards = [(torch.from_numpy(ids[r * SLICE_ROWS:(r + 1) * SLICE_ROWS]),
                       torch.from_numpy(tgt[r * SLICE_ROWS:(r + 1) * SLICE_ROWS]))
                      for r in range(n)]
            out = [None] * n

            def sink(r, grads):
                out[r] = torch.cat([g.reshape(-1) for g in grads])

            per_rank_grads(lambda p, b: tmodel.loss(
                p, b, attn_fn=ttr.default_attention), params, shards, sink)
            return out

        with _world(["ref-py"] * n, plan.Strategy.AUTO) as jengs, \
                _world(["port-native", "port-py", "port-native", "port-py"],
                       plan.Strategy.AUTO) as tengs:
            for step, (ids, tgt) in enumerate(batches):
                jg = jflat_grads(jp, ids, tgt)
                # the port engines take the reference's gradient bytes
                fed = [torch.from_numpy(g.copy()) for g in jg]
                run_all([(lambda i=i, e=e: e.all_reduce(
                    jg[i], op="mean", inplace=True, name=f"sysg{step}"))
                    for i, e in enumerate(jengs)])
                run_all([(lambda i=i, e=e: e.all_reduce(
                    fed[i], op="mean", inplace=True, name=f"fed{step}"))
                    for i, e in enumerate(tengs)])
                for i in range(n):
                    assert fed[i].numpy().tobytes() == jg[i].tobytes()
                assert all(jg[0].tobytes() == g.tobytes() for g in jg)
                # the port's own loop
                tg = tflat_grads(tp, ids, tgt)
                run_all([(lambda i=i, e=e: e.all_reduce(
                    tg[i], op="mean", inplace=True, name=f"sysg{step}"))
                    for i, e in enumerate(tengs)])
                assert all(torch.equal(tg[0], g) for g in tg)
                # unflatten rank 0's reduced gradient and apply the update
                off, jgt, tgt_leaves = 0, [], []
                for jl, tl in zip(jleaves, tleaves):
                    k = tl.numel()
                    jgt.append(jnp.asarray(jg[0][off:off + k].reshape(jl.shape)))
                    tgt_leaves.append(tg[0][off:off + k].reshape(tl.shape))
                    off += k
                ju, js = jtx.update(jax.tree_util.tree_unflatten(jdef, jgt),
                                    js, jp)
                jp = optax.apply_updates(jp, ju)
                tu, ts = ttx.update(tree_unflatten(tdef, tgt_leaves), ts, tp)
                tp = apply_updates(tp, tu)
                jleaves, tleaves = (jax.tree_util.tree_leaves(jp),
                                    tree_flatten(tp)[0])
            assert all(e.native_runs == 2 * SLICE_STEPS for e in tengs[::2])
        for t, j in zip(tleaves, jleaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       atol=TRAIN_ATOL)
