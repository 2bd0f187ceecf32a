"""Port parity: the online adaptation plane.

``policy/`` (``ArmStats``, ``ScheduleTable``, ``OverlapDepthBandit``,
``CollectiveBanditPolicy``, the runner and the policies),
``monitor/skew.py``, ``monitor/adapt.py`` (latencies, the latency MST,
``set_tree``, the interference vote), ``monitor/adapt_device.py`` (the
host and device bandit drivers), the host ``AdaptiveStrategyDriver``,
the device plane's bucket table and latency hook, chaos's ``on_ping``,
and the ``Peer`` methods over them.

Held against the JAX package (``kungfu_tpu``) on the same inputs: the
bandit's selection sequences and snapshots for seeded observation
streams, the skew verdicts on the same event lists, the MST forest of
the same allgathered latency matrix, the policies' intents, and
``Peer.get_egress_rates`` with monitoring off; all exact.  The cluster
cases mirror ``tests/test_bandit.py``, ``tests/test_monitoring.py``'s
``TestMST`` and ``TestAdaptIntegration``, ``tests/test_aggregator.py``'s
``TestSkewDeterminism`` and ``tests/test_policy.py`` on port peers
(``start_local_cluster``: ports found free) and on four co-resident CPU
ranks.  Reference channels run with ``KF_TPU_USE_UNIXSOCK=0``; chaos
cases call ``chaos.reset()`` before and after.  No assertion reads a
host speed: the tests assert the decisions, the forests and the values.
"""

import errno
import itertools
import random
import socket
import time

import numpy as np
import pytest
import torch

from kungfu_tpu import chaos as jchaos
from kungfu_tpu.monitor import adapt as jadapt
from kungfu_tpu.monitor import skew as jskew
from kungfu_tpu.peer import Peer as JPeer
from kungfu_tpu.plan.mst import minimum_spanning_tree as jmst
from kungfu_tpu.policy import bandit as jbandit
from kungfu_tpu.policy import base as jbase
from kungfu_tpu.policy import policies as jpolicies
from kungfu_tpu.policy import runner as jrunner
from kungfu_tpu.utils import envs as jenvs
from kungfu_tpu_torch import chaos
from kungfu_tpu_torch import policy
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.comm.engine import CollectiveEngine
from kungfu_tpu_torch.comm.host import PyHostChannel
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.elastic.hooks import ElasticState, elastic_step
from kungfu_tpu_torch.monitor import adapt, skew, timeline
from kungfu_tpu_torch.monitor.adapt_device import (DEFAULT_HOST_ARMS, MST_ARM,
                                                   DeviceBanditDriver,
                                                   HostBanditDriver)
from kungfu_tpu_torch.monitor.adaptive import (AdaptiveStrategyDriver,
                                               monitored_all_reduce)
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.ops.schedules import (ALLREDUCE_SCHEDULES,
                                            SIZE_BUCKET_EDGES, SIZE_BUCKETS,
                                            size_bucket)
from kungfu_tpu_torch.peer import Peer, start_local_cluster
from kungfu_tpu_torch.plan import PeerID, PeerList, Strategy
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.mst import minimum_spanning_tree
from kungfu_tpu_torch.policy import (ArmStats, BasePolicy,
                                     CollectiveBanditPolicy, GNSResizePolicy,
                                     PolicyContext, PolicyRunner,
                                     ScheduledSizePolicy, ScheduleTable)
from kungfu_tpu_torch.policy.bandit import OverlapDepthBandit
from kungfu_tpu_torch.utils import envs
from tests._util import run_all

N = 4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    # a failing rank fails its peers in seconds, not the default minute
    monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "30")
    for k in ("KF_CHAOS_SPEC", "KF_NATIVE_ENGINE", "KF_TPU_HOST_TRANSPORT",
              "KF_CONFIG_ENABLE_TRACE", "KF_CONFIG_ENABLE_MONITORING",
              "KF_CONFIG_ENABLE_CLUSTER_MONITOR", "KF_ALLREDUCE_STRATEGY"):
        monkeypatch.delenv(k, raising=False)
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()
    timeline.reset()


def _peers(n=3, strategy="STAR", extra=None):
    """``n`` started port peers whose engines run ``strategy``."""
    return start_local_cluster(
        n, env={"KF_ALLREDUCE_STRATEGY": strategy, **(extra or {})},
        devices=["cpu"])


def _close(things):
    for t in things:
        t.close()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _ref_peers(n, attempts=5):
    """``n`` started reference peers on ports found free."""
    for _ in range(attempts):
        ports = _free_ports(n)
        peers = []
        try:
            for r in range(n):
                peers.append(JPeer(jenvs.parse_config_from_env(
                    envs.single_machine_env(r, n, ports=ports))))
                peers[-1].start()
            return peers
        except OSError as e:
            for p in peers:
                p.close()
            if getattr(e, "errno", None) not in (None, errno.EADDRINUSE):
                raise
    raise OSError("no free ports for a reference cluster")


# -- policy/bandit.py against the reference -------------------------------------
def _stream(table, lat, rng, steps):
    """Drive ``table`` with a seeded latency stream; the selections and
    the snapshot after each step."""
    seq, snaps = [], []
    for _ in range(steps):
        arm = table.select()
        seq.append(arm)
        table.observe(arm, lat[arm] * (1.0 + 0.2 * rng.random()),
                      count=1.0 + rng.randrange(3))
        snaps.append(table.snapshot())
    return seq, snaps


class TestArmStats:
    @pytest.mark.parametrize("seed,decay,c,min_pulls", [
        (0, 1.0, 0.5, 1), (1, 0.9, 0.5, 2), (2, 1.0, 2.0, 1),
        (3, 0.7, 0.1, 3)])
    def test_seeded_streams_match_reference(self, seed, decay, c, min_pulls):
        """Identical observation streams give the reference's selection
        sequence and snapshots, float for float."""
        arms = ("psum", "two_stage", "ring", "pallas_ring")
        lat = dict(zip(arms, (0.05, 0.04, 0.06, 0.01)))
        got = _stream(ArmStats(arms, c=c, min_pulls=min_pulls, decay=decay),
                      lat, random.Random(seed), 80)
        want = _stream(jbandit.ArmStats(arms, c=c, min_pulls=min_pulls,
                                        decay=decay),
                       lat, random.Random(seed), 80)
        assert got == want

    def test_deterministic_convergence_on_synthetic_stream(self):
        lat = {"a": 0.10, "b": 0.04, "c": 0.20}

        def run(cls):
            t = cls(("a", "b", "c"), min_pulls=2)
            rng = random.Random(7)
            seq = []
            for _ in range(60):
                arm = t.select()
                seq.append(arm)
                t.observe(arm, lat[arm] + rng.random() * 0.005)
            return seq

        s1, s2 = run(ArmStats), run(ArmStats)
        assert s1 == s2 == run(jbandit.ArmStats)
        assert set(s1[-10:]) == {"b"}
        assert all(s1.count(a) >= 2 for a in ("a", "b", "c"))

    def test_unexplored_first_in_declaration_order(self):
        t = ArmStats(("x", "y", "z"), min_pulls=1)
        assert t.select() == "x"
        t.observe("x", 1.0)
        assert t.select() == "y"
        t.observe("y", 1.0)
        assert t.select() == "z"

    def test_reset_reexplores(self):
        t = ArmStats(("x", "y"))
        t.observe("x", 0.1)
        t.observe("y", 0.2)
        assert t.unexplored() is None
        t.reset()
        assert t.unexplored() == "x"
        assert t.mean("x") is None

    def test_rejects_uncredible_observations(self):
        t = ArmStats(("x",))
        for bad in (float("nan"), -1.0, 0.0):
            with pytest.raises(ValueError):
                t.observe("x", bad)
        with pytest.raises(ValueError):
            t.observe("x", 0.1, count=0)
        with pytest.raises(KeyError):
            t.observe("nope", 0.1)
        with pytest.raises(ValueError):
            ArmStats(())
        with pytest.raises(ValueError):
            ArmStats(("x", "x"))
        with pytest.raises(ValueError):
            ArmStats(("x",), decay=0.0)

    def test_degraded_incumbent_is_abandoned(self):
        t, j = ArmStats(("fast", "slow")), jbandit.ArmStats(("fast", "slow"))
        for tab in (t, j):
            for _ in range(6):
                tab.observe(tab.select(),
                            0.01 if tab.select() == "fast" else 0.05)
            for _ in range(20):
                arm = tab.select()
                tab.observe(arm, 0.5 if arm == "fast" else 0.05)
        assert t.select() == j.select() == "slow"
        assert t.snapshot() == j.snapshot()


class TestScheduleTable:
    def test_buckets_learn_independent_winners(self):
        st = ScheduleTable(("psum", "ring"), n_buckets=2, min_pulls=1)
        jst = jbandit.ScheduleTable(("psum", "ring"), n_buckets=2,
                                    min_pulls=1)
        for tab in (st, jst):
            for _ in range(8):
                tab.observe(0, "psum", 0.001)
                tab.observe(0, "ring", 0.010)
                tab.observe(1, "psum", 0.100)
                tab.observe(1, "ring", 0.020)
        assert st.select(0) == "psum" and st.select(1) == "ring"
        st.install(0, "psum")
        st.install(1, "ring")
        assert st.active == ["psum", "ring"]
        with pytest.raises(KeyError):
            st.install(0, "bogus")
        with pytest.raises(ValueError):
            ScheduleTable(("psum",), n_buckets=0)
        jst.install(0, "psum")
        jst.install(1, "ring")
        assert st.summary() == jst.summary()

    def test_size_bucket_edges(self):
        assert len(SIZE_BUCKETS) == len(SIZE_BUCKET_EDGES) + 1
        assert size_bucket(0) == 0
        assert size_bucket(SIZE_BUCKET_EDGES[0] - 1) == 0
        assert size_bucket(SIZE_BUCKET_EDGES[0]) == 1
        assert size_bucket(1 << 30) == len(SIZE_BUCKETS) - 1


class _DepthEngine:
    def __init__(self):
        self.depths = []

    def set_overlap_depth(self, d):
        self.depths.append(d)


class TestOverlapDepthBandit:
    def test_matches_reference(self):
        """The same per-depth pipeline times install the same depths in
        the same order as the reference's bandit."""
        lat = {1: 0.09, 2: 0.05, 4: 0.06}

        def run(cls):
            eng = _DepthEngine()
            b = cls(eng, depths=(1, 2, 4), check_every=2)
            rng = random.Random(5)
            swaps = []
            for _ in range(40):
                t = lat[int(b.active)] * (1 + 0.1 * rng.random())
                swaps.append(b.observe(t))
            b.reset()
            return eng.depths, swaps, b.swaps, b.stats.snapshot()

        got, want = run(OverlapDepthBandit), run(jbandit.OverlapDepthBandit)
        assert got == want
        assert got[0][0] == 1 and 2 in got[0] and got[0][-1] == 1
        with pytest.raises(ValueError):
            OverlapDepthBandit(_DepthEngine(), depths=(0,))


# -- monitor/skew.py against the reference ----------------------------------------
def _span(rank, step, dur, tag, kind="collective", ts=None, op="all_reduce"):
    return {"ts": 100.0 + step if ts is None else ts, "rank": rank,
            "step": step, "kind": kind, "name": "engine.all_reduce",
            "dur": dur, "attrs": {"op": op, "tag": tag}}


def _events(seed):
    """A seeded mix: collective and device spans with one slow rank, a
    chaos fault inside a spike, and noise kinds the math must skip."""
    rng = np.random.default_rng(seed)
    evs = []
    for step in range(6):
        for r in range(4):
            # rank 2 the slowest everywhere, a spike at steps 2 and 3
            slow = (8.0 if step in (2, 3) else 2.5) if r == 2 else 1.0
            evs.append(_span(r, step, 0.01 * slow * (1 + rng.random()),
                             f"g{step}", ts=100.0 + step + 0.01 * r))
            evs.append(_span(r, step, 0.002 * (2.5 if r == 2 else 1.0)
                             * (1 + 0.5 * rng.random()), f"d{step}",
                             kind="device", op="all_reduce"))
    evs.append({"ts": 102.0, "rank": 1, "step": 2, "kind": "chaos",
                "name": "delay", "dur": 0.0, "attrs": {"ms": 30}})
    evs.append({"ts": 103.5, "rank": 0, "step": 3, "kind": "send",
                "name": "x", "dur": 0.0, "attrs": {}})
    evs.append(_span(0, 6, 0.0, "zero"))
    return evs


class TestSkew:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_reference(self, seed):
        evs = _events(seed)
        for fn in ("collective_groups", "skew_rows", "slowest_rank_per_step",
                   "fault_overlaps", "straggler_verdict"):
            got, want = getattr(skew, fn)(evs), getattr(jskew, fn)(evs)
            if fn == "collective_groups":
                got, want = dict(got), dict(want)
            assert got == want, fn
        assert skew.straggler_verdict(evs) == 2
        assert skew.fault_overlaps(evs)[0]["faults"][0]["kind"] == "chaos"
        assert (skew.COLLECTIVE_KINDS, skew.SPIKE_FACTOR, skew.FAULT_KINDS) \
            == (jskew.COLLECTIVE_KINDS, jskew.SPIKE_FACTOR, jskew.FAULT_KINDS)

    def test_tie_breaks_independent_of_event_order(self):
        evs = [_span(r, 1, 0.01 if r < 2 else 0.1, "g") for r in range(3)]
        rows0 = skew.skew_rows(evs)
        assert rows0[0]["fastest_rank"] == 0  # a tie with rank 1: lowest
        assert rows0 == jskew.skew_rows(evs)
        for perm in itertools.permutations(evs):
            assert skew.skew_rows(list(perm)) == rows0
            assert skew.straggler_verdict(list(perm)) == 2

    def test_no_groups_no_verdict(self):
        assert skew.straggler_verdict([_span(0, 1, 0.1, "solo")]) is None
        assert skew.skew_rows([]) == []


# -- monitor/adapt.py ---------------------------------------------------------------
class TestMST:
    def test_chain(self):
        w = np.array([[0, 1, 10], [1, 0, 1], [10, 1, 0]], float)
        f = minimum_spanning_tree(w)
        assert f[0] == 0 and f[1] == 0 and f[2] == 1

    def test_star(self):
        w = np.array([[0, 1, 1, 1], [1, 0, 9, 9], [1, 9, 0, 9],
                      [1, 9, 9, 0]], float)
        assert minimum_spanning_tree(w) == [0, 0, 0, 0]

    def test_asymmetric_symmetrized(self):
        w = np.array([[0, 2], [4, 0]], float)
        assert minimum_spanning_tree(w) == [0, 0]

    def test_bad_shape(self):
        with pytest.raises(ValueError):
            minimum_spanning_tree(np.zeros((2, 3)))

    def test_injected_latency_matrix_matches_reference(self, monkeypatch):
        """Each peer's latency row is injected; three port peers and
        three reference peers allgather the same matrix and take the same
        forest, which leaves the slow 0-1 edge out."""
        mat = np.array([[0.0, 0.030, 0.001], [0.031, 0.0, 0.002],
                        [0.001, 0.002, 0.0]])
        monkeypatch.setattr(adapt, "get_peer_latencies",
                            lambda p, samples=1: list(mat[p.rank()]))
        monkeypatch.setattr(jadapt, "get_peer_latencies",
                            lambda p, samples=1: list(mat[p.rank()]))
        peers, jpeers = _peers(), _ref_peers(3)
        try:
            got = run_all([lambda p=p: adapt.latency_matrix(p)
                           for p in peers], timeout=60)
            want = run_all([lambda p=p: jadapt.latency_matrix(p)
                            for p in jpeers], timeout=60)
            for g, w in zip(got, want):
                assert np.array_equal(g, mat) and np.array_equal(w, mat)
            forests = run_all(
                [lambda p=p: adapt.minimum_spanning_tree_from_latencies(p)
                 for p in peers], timeout=60)
            assert forests == [jmst(mat)] * 3 == [[0, 2, 0]] * 3
        finally:
            _close(peers + jpeers)


class TestAdaptIntegration:
    @pytest.fixture
    def peers(self):
        ps = _peers(strategy="BINARY_TREE_STAR")
        yield ps
        _close(ps)

    def test_latencies(self, peers):
        lats = peers[0].get_peer_latencies()
        assert len(lats) == 3
        assert lats[0] == 0.0 and lats[1] > 0 and lats[2] > 0

    def test_latency_matrix_and_mst(self, peers):
        mats = run_all([lambda p=p: adapt.latency_matrix(p) for p in peers],
                       timeout=60)
        for m in mats:
            assert m.shape == (3, 3)
            assert np.array_equal(m, mats[0])  # allgathered: one matrix
        f = minimum_spanning_tree(mats[0])
        assert len(f) == 3 and f[0] == 0

    def test_set_tree_then_allreduce(self, peers):
        chain = [0, 0, 1]

        def one(p, val):
            p.set_tree(chain)
            return p.engine().all_reduce(np.full(4, val, np.float32))

        outs = run_all([lambda p=p, v=v: one(p, float(v))
                        for v, p in enumerate(peers)], timeout=60)
        for o in outs:
            np.testing.assert_allclose(o, np.full(4, 3.0))
        for p in peers:
            e = p.engine()
            assert e.strategy is None and len(e._graphs) == 1
            assert e._graphs[0][1].digest_bytes() == \
                Graph.from_forest_array(chain).digest_bytes()
            assert e.collectives_since_swap() == 1

    def test_set_tree_clears_native_serialization(self):
        """The C++ executor's serialized graphs go with a tree install;
        the next native allreduce runs the tree."""
        peers = _peers(strategy="STAR")
        try:
            data = [np.full(5000, float(i + 1), np.float32)
                    for i in range(3)]
            run_all([lambda p=p, d=d: p.engine().all_reduce(d)
                     for p, d in zip(peers, data)], timeout=60)
            e0 = peers[0].engine()
            native = e0.native_runs > 0
            run_all([lambda p=p: p.set_tree([0, 2, 0]) for p in peers],
                    timeout=60)
            assert all(not p.engine()._graph_ser for p in peers)
            outs = run_all([lambda p=p, d=d: p.engine().all_reduce(d)
                            for p, d in zip(peers, data)], timeout=60)
            for o in outs:
                np.testing.assert_array_equal(o, np.full(5000, 6.0))
            if native:
                assert e0.native_runs >= 2 and e0._graph_ser
        finally:
            _close(peers)

    def test_interference_vote(self, peers):
        outs = run_all([lambda p=p: p.check_interference() for p in peers],
                       timeout=60)
        assert outs == [False, False, False]

    def test_adaptive_driver_swaps_on_interference(self, peers):
        """A pinned best throughput makes every window a drop: the
        suspicion, the majority vote and the fenced swap run for real,
        in lockstep, and the collectives stay exact."""
        drivers = [AdaptiveStrategyDriver(p, check_every=1,
                                          min_steps_between_swaps=1)
                   for p in peers]
        data = np.ones(64_000, np.float32)

        def train_step(p, d):
            return monitored_all_reduce(p.engine(), data, d, op="sum"), \
                d.swaps

        outs = run_all([lambda p=p, d=d: train_step(p, d)
                        for p, d in zip(peers, drivers)], timeout=60)
        assert [s for _, s in outs] == [0, 0, 0]
        for p in peers:
            e = p.engine()
            e.best_throughputs = [1e12] * len(e.best_throughputs)
        swaps = []
        for _ in range(3):
            outs = run_all([lambda p=p, d=d: train_step(p, d)
                            for p, d in zip(peers, drivers)], timeout=60)
            for o, _ in outs:
                np.testing.assert_array_equal(o, data * 3)
            swaps.append({s for _, s in outs})
            assert len(swaps[-1]) == 1  # lockstep: all or none
            for p in peers:
                e = p.engine()
                e.best_throughputs = [1e12] * len(e.best_throughputs)
        assert swaps[-1] == {1} and all(d.swaps == 1 for d in drivers)
        # the rotation skips the incumbent BINARY_TREE_STAR
        assert {p.engine().strategy for p in peers} == \
            {Strategy.MULTI_BINARY_TREE_STAR}
        outs = run_all([lambda p=p: p.engine().all_reduce(
            np.full(5, 2.0, np.float32)) for p in peers], timeout=60)
        for o in outs:
            np.testing.assert_allclose(o, np.full(5, 6.0))

    def test_adaptive_driver_mst_swap(self, peers):
        drivers = [AdaptiveStrategyDriver(p, check_every=1, use_mst=True,
                                          min_steps_between_swaps=1,
                                          consecutive_drops=1)
                   for p in peers]

        def one(p, d):
            e = p.engine()
            e.best_throughputs = [1e12] * len(e.best_throughputs)
            out = monitored_all_reduce(e, np.full(50_000, 1.0 + p.rank(),
                                                  np.float32), d)
            return out, d.swaps

        # the first window is a drop (the best is pinned): the vote
        # agrees and every rank installs the allgathered latency MST
        outs = run_all([lambda p=p, d=d: one(p, d)
                        for p, d in zip(peers, drivers)], timeout=60)
        assert {s for _, s in outs} == {1}
        for o, _ in outs:
            np.testing.assert_array_equal(o, np.full(50_000, 6.0))
        assert all(p.engine().strategy is None for p in peers)
        digests = {p.engine()._graphs[0][1].digest_bytes() for p in peers}
        assert len(digests) == 1


class TestEgressRates:
    def test_zeros_without_a_net_monitor(self):
        """With monitoring off (the only mode the port has), the rates are
        ``[0.0] * size()``, as the reference's."""
        peers, jpeers = _peers(2), _ref_peers(2)
        try:
            for p, j in zip(peers, jpeers):
                assert p.get_egress_rates() == j.get_egress_rates() \
                    == [0.0, 0.0]
            single = Peer(envs.parse_config_from_env({}), devices=["cpu"])
            jsingle = JPeer(jenvs.parse_config_from_env({}))
            assert single.get_egress_rates() == jsingle.get_egress_rates() \
                == [0.0]
        finally:
            _close(peers + jpeers)


# -- the device plane: bucket table, latency hook, device bandit -------------------
@pytest.fixture
def comm():
    return Communicator(devices=["cpu"] * N, local_size=N)


class TestDeviceBucketDispatch:
    def test_per_bucket_strategy_dispatch(self, comm, monkeypatch):
        from kungfu_tpu_torch.comm import device as dev

        ran = []
        real = dev.all_reduce_scheduled

        def spy(a, axes, op="sum", schedule="psum"):
            ran.append(schedule)
            return real(a, axes, op=op, schedule=schedule)

        monkeypatch.setattr(dev, "all_reduce_scheduled", spy)
        small = torch.arange(4, dtype=torch.float32)[:, None]
        large = torch.ones((4, 100_000), dtype=torch.float32)
        comm.set_bucket_strategy(1, "ring")
        assert float(comm.all_reduce(small)[0, 0]) == 6.0
        assert bool(torch.all(comm.all_reduce(large) == 4.0))
        assert ran == ["psum", "ring"]
        assert comm.strategy_for(16) == "psum"
        assert comm.strategy_for(large.numel() * 4) == "ring"
        assert comm.strategy_for_bucket(1) == "ring"
        assert comm.strategy_for_bucket(0) == "psum"
        assert comm.bucket_summary() == "large=ring"
        comm.set_bucket_strategy(1, None)
        assert comm.bucket_summary() == ""
        assert comm.strategy_for(large.numel() * 4) == "psum"
        with pytest.raises(ValueError):
            comm.set_bucket_strategy(0, "bogus")
        with pytest.raises(ValueError):
            comm.set_bucket_strategy(99, "ring")

    def test_latency_hook_reports_executed_schedule(self, comm):
        obs = []
        comm.set_latency_hook(lambda n, s, dt: obs.append((n, s, dt)))
        comm.set_bucket_strategy(1, "two_stage")
        comm.all_reduce(torch.arange(4, dtype=torch.float32)[:, None])
        comm.all_reduce(torch.ones((4, 100_000), dtype=torch.float32))
        comm.all_reduce(torch.ones((4, 3)), op="prod")
        # agreement traffic is not measured
        comm._agree([1.0, 2.0], op="mean")
        comm.set_latency_hook(None)
        assert [(n, s) for n, s, _ in obs] == [
            (16, "psum"), (1_600_000, "two_stage"), (48, "psum")]
        assert all(dt > 0 for _, _, dt in obs)
        comm.all_reduce(torch.arange(4, dtype=torch.float32)[:, None])
        assert len(obs) == 3

    def test_device_spans_carry_nbytes_and_sched(self, comm, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()
        comm.set_bucket_strategy(1, "ring")
        x = torch.ones((4, 100_000))
        comm.all_reduce(x)
        comm.all_gather(torch.ones((4, 2)))
        comm.broadcast(torch.ones((4, 2)))
        comm.reduce_scatter(torch.ones((4, 8)))
        comm.all_gather_shard(torch.ones((4, 2)))
        spans = [e for e in timeline.snapshot() if e["kind"] == "device"]
        assert [e["name"] for e in spans] == [
            "device.all_reduce", "device.all_gather", "device.broadcast",
            "device.reduce_scatter", "device.all_gather_shard"]
        a = spans[0]["attrs"]
        assert (a["op"], a["n"], a["nbytes"], a["sched"]) == \
            ("all_reduce", N, 1_600_000, "ring")
        assert a["trace"] == timeline.collective_trace_id(
            comm.version, -1, "all_reduce", "device.all_reduce")
        assert all(e["dur"] > 0 for e in spans)

    def test_autotune_rejects_uncredible_winner(self, comm, monkeypatch):
        comm.set_strategy("two_stage")
        for bad in ([0.0] * 4, [float("nan")] * 4, [1e9] * 4):
            monkeypatch.setattr(type(comm), "_time_schedules",
                                lambda self, x, trials, _b=bad: list(_b))
            assert comm.autotune_strategy(nbytes=1 << 10,
                                          trials=1) == "two_stage"
            assert comm.strategy == "two_stage"

    def test_device_driver_converges_and_installs(self, comm):
        d = DeviceBanditDriver(comm, check_every=2, min_pulls=1)
        assert comm._latency_hook is not None
        small = torch.arange(4, dtype=torch.float32)[:, None]
        large = torch.ones((4, 70_000), dtype=torch.float32)
        swaps = 0
        for _ in range(18):
            np.testing.assert_array_equal(comm.all_reduce(small)[:, 0],
                                          [6.0] * 4)
            assert bool(torch.all(comm.all_reduce(large) == 4.0))
            swaps += d.step()
        assert swaps > 0
        summary = d.summary()
        assert set(summary) == {0, 1}
        for b in summary.values():
            assert all(v["count"] > 0 for v in b["arms"].values()), summary
        for b, active in enumerate(d.table.active):
            assert comm.strategy_for_bucket(b) == active
            assert summary[b]["active"] == active
        comm.set_latency_hook(None)

    def test_device_driver_timeline_feed(self, comm, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()
        d = DeviceBanditDriver(comm, check_every=4, feed="timeline")
        assert comm._latency_hook is None
        comm.all_reduce(torch.ones((4, 100_000)))
        comm.all_reduce(torch.arange(4, dtype=torch.float32)[:, None])
        assert d.feed_from_timeline() == 2
        pend = d._pending
        assert sum(c for c, _ in pend[1].values()) == 1
        assert sum(c for c, _ in pend[0].values()) == 1
        with pytest.raises(ValueError):
            DeviceBanditDriver(comm, feed="bogus")

    def test_device_driver_matches_reference_decisions(self):
        """The same synthetic windows through the port's driver and the
        reference's give the same installs at the same checks."""
        import jax

        from kungfu_tpu.comm.device import Communicator as JCommunicator
        from kungfu_tpu.monitor import adapt_device as jad

        comms = (Communicator(devices=["cpu"] * N, local_size=N),
                 JCommunicator(devices=jax.devices()[:N], local_size=N))
        drivers = (DeviceBanditDriver(comms[0], check_every=2, min_pulls=1),
                   jad.DeviceBanditDriver(comms[1], check_every=2,
                                          min_pulls=1))
        rng = random.Random(11)
        lat = {"psum": 0.05, "two_stage": 0.04, "ring": 0.06,
               "pallas_ring": 0.01}
        hist = ([], [])
        for _ in range(30):
            arm_l = [d.table.active[1] for d in drivers]
            arm_s = [d.table.active[0] for d in drivers]
            assert arm_l[0] == arm_l[1] and arm_s[0] == arm_s[1]
            t = lat[arm_l[0]] * (1 + 0.1 * rng.random())
            ts = 0.001 if arm_s[0] == "psum" else 0.003
            for d, h in zip(drivers, hist):
                d._on_collective(1 << 20, arm_l[0], t)
                d._on_collective(64, arm_s[0], ts)
                h.append(d.step())
        assert hist[0] == hist[1] and any(hist[0])
        assert drivers[0].summary() == drivers[1].summary()
        for c in comms:
            c.set_latency_hook(None)


class TestEngineSwapEpochs:
    def test_window_peek_and_swap_eligibility(self):
        chans = [PyHostChannel(PeerID("127.0.0.1", 0),
                               bind_host="127.0.0.1") for _ in range(2)]
        peers = PeerList.of(*(c.self_id for c in chans))
        engines = [CollectiveEngine(c, peers, Strategy.STAR) for c in chans]
        try:
            data = np.ones(1000, np.float32)
            run_all([lambda e=e: e.all_reduce(data) for e in engines],
                    timeout=60)
            e = engines[0]
            w1, w2 = e.window_peek(), e.window_peek()
            assert w1 == w2 and sum(b for b, _ in w1) > 0
            assert e.throughputs()
            assert sum(b for b, _ in e.window_peek()) == 0
            assert e.collectives_since_swap() >= 1
            assert e.swap_eligible(1)
            e.mark_swap()
            assert e.collectives_since_swap() == 0
            assert not e.swap_eligible(1)
            assert e.swap_eligible(0)
        finally:
            _close(engines + chans)


# -- the host bandit on port peers ---------------------------------------------------
class TestFencedSwapLockstep:
    def test_lockstep_swap_and_event_on_every_rank(self, monkeypatch):
        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()
        peers = _peers()
        try:
            drivers = [HostBanditDriver(p, arms=("STAR", "RING"),
                                        check_every=2, min_pulls=1,
                                        min_swap_collectives=1)
                       for p in peers]
            before = REGISTRY.counter("kf_strategy_swaps_total",
                                      what="RING").value

            def one(rank, d):
                # rank-skewed locals: only the allreduced mean agrees
                dt = (0.1 if d.active == "STAR" else 0.001) * (1 + 0.2 * rank)
                return d.step(dt)

            swap_steps = []
            for step in range(8):
                flags = run_all([lambda r=r, d=d: one(r, d)
                                 for r, d in enumerate(drivers)], timeout=60)
                assert len(set(flags)) == 1, f"non-lockstep at step {step}"
                if flags[0]:
                    swap_steps.append(step)
            assert swap_steps
            assert len({d.active for d in drivers}) == 1
            assert len({p.engine().strategy.name for p in peers}) == 1
            swaps = [e for e in timeline.snapshot() if e["kind"] == "swap"]
            by_seq = {}
            for e in swaps:
                by_seq.setdefault(e["attrs"]["seq"], []).append(e["rank"])
                assert e["attrs"]["plane"] == "host"
                assert set(e["attrs"]) >= {"plane", "seq", "prev"}
            assert by_seq and all(sorted(r) == [0, 1, 2]
                                  for r in by_seq.values())
            assert REGISTRY.counter("kf_strategy_swaps_total",
                                    what="RING").value > before
        finally:
            _close(peers)

    def test_default_arms_and_incumbent(self):
        assert DEFAULT_HOST_ARMS == ("STAR", "RING", "BINARY_TREE_STAR",
                                     MST_ARM)
        peers = _peers(strategy="MULTI_STAR")
        try:
            d = HostBanditDriver(peers[0])
            assert d.table.arms == ("MULTI_STAR",) + DEFAULT_HOST_ARMS
            assert d.active == "MULTI_STAR"
        finally:
            _close(peers)


class TestCollectiveBanditPolicy:
    def test_runner_drives_lockstep_swaps(self, monkeypatch):
        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        peers = _peers()
        try:
            pols = [CollectiveBanditPolicy(
                p, arms=("STAR", "RING"), check_every=2, min_pulls=1,
                min_swap_collectives=1) for p in peers]
            runners = [PolicyRunner([pol], peer=p, batch_size=4)
                       for pol, p in zip(pols, peers)]

            def one(pol, run):
                dt = 0.1 if pol.host.active == "STAR" else 0.001
                run.after_step(step_collective_s=dt)
                return pol.host.active, run.ctx.metrics.get("bandit_swaps")

            last = []
            for _ in range(6):
                last = run_all([lambda pol=pol, run=run: one(pol, run)
                                for pol, run in zip(pols, runners)],
                               timeout=60)
                assert len({a for a, _ in last}) == 1
            assert {a for a, _ in last} == {"RING"}
            assert all(s and s >= 1.0 for _, s in last), last
            assert all(r.ctx.step == 6 for r in runners)
        finally:
            _close(peers)


class TestResizeReexplore:
    def test_live_shrink_resets_bandit(self, monkeypatch):
        """3 -> 2 through the config server and ``elastic_step(bandit=)``:
        the survivors' tables reset and track the new version."""
        import urllib.request

        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        server = ConfigServer(port=0, host="127.0.0.1").start()
        peers = _peers(extra={envs.CONFIG_SERVER: server.url})
        try:
            urllib.request.urlopen(urllib.request.Request(
                server.url, data=peers[0].cluster.to_json().encode(),
                method="PUT"), timeout=10).read()
            drivers = [HostBanditDriver(p, arms=("STAR", "RING"),
                                        check_every=2, min_pulls=1,
                                        min_swap_collectives=1)
                       for p in peers]
            params = {"w": torch.arange(4.0)}

            def loop(p, d):
                state = ElasticState()
                out = dict(resets=0, stopped=False)
                for _ in range(6):
                    before = sum(d.table.counts)
                    state, _, stop = elastic_step(p, state, "3:3,2:100",
                                                  params, bandit=d)
                    if stop:
                        out["stopped"] = True
                        break
                    d.step(0.01)
                    if before > 0 and sum(d.table.counts) == 0:
                        out["resets"] += 1
                out["size"], out["version"] = p.size(), d._seen_version
                return out

            outs = run_all([lambda p=p, d=d: loop(p, d)
                            for p, d in zip(peers, drivers)], timeout=180)
            stopped = [o for o in outs if o["stopped"]]
            survived = [o for o in outs if not o["stopped"]]
            assert len(stopped) == 1 and len(survived) == 2, outs
            assert all(o["size"] == 2 for o in survived)
            assert all(o["resets"] >= 1 for o in survived), outs
            versions = {o["version"] for o in survived}
            assert len(versions) == 1 and versions != {0}
            for d, o in zip(drivers, outs):
                if not o["stopped"]:
                    assert sum(d.table.counts) < 4
        finally:
            _close(peers)
            server.stop()


class TestChaosDelayAbandon:
    SPEC = ";".join(f"delay:ms={{ms}},rank={a},peer={b},on={on}"
                    for a, b in ((0, 1), (1, 0)) for on in ("send", "ping"))

    def test_bandit_abandons_degraded_strategy(self, monkeypatch):
        """The 0<->1 link is throttled on the data path and the probe:
        the bandit leaves STAR in lockstep, every rank ends on one arm,
        the values stay exact, and an installed MST leaves 0-1 out."""
        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        monkeypatch.setenv("KF_CHAOS_SPEC", self.SPEC.format(ms=15))
        chaos.reset()
        peers = _peers()
        data = np.ones(20_000, np.float32)
        try:
            drivers = [HostBanditDriver(p, check_every=2, min_pulls=1,
                                        min_swap_collectives=1)
                       for p in peers]

            def one(p, d):
                t0 = time.perf_counter()
                out = p.engine().all_reduce(data, op="sum")
                dt = time.perf_counter() - t0
                np.testing.assert_array_equal(out, data * 3)
                return d.step(dt)

            swapped = []
            for i in range(24):
                flags = run_all([lambda p=p, d=d: one(p, d)
                                 for p, d in zip(peers, drivers)],
                                timeout=120)
                assert len(set(flags)) == 1, f"non-lockstep at {i}"
                if flags[0]:
                    swapped.append(i)
            assert swapped, "the bandit never left STAR"
            actives = {d.active for d in drivers}
            assert len(actives) == 1 and actives != {"STAR"}, actives
            if actives == {MST_ARM}:
                for p in peers:
                    assert (0, 1) not in _edges(p.engine()._graphs[0][1])
        finally:
            _close(peers)
            chaos.reset()

    def test_delay_on_ping_inflates_latency_probe(self, monkeypatch):
        monkeypatch.setenv("KF_CHAOS_SPEC", "delay:ms=60,rank=0,peer=1,on=ping")
        chaos.reset()
        peers = _peers(2)
        try:
            row = adapt.get_peer_latencies(peers[0], samples=1)
            assert row[0] == 0.0
            assert row[1] >= 0.055, row
            # rank 1's probe of rank 0 is not throttled
            assert peers[1].get_peer_latencies()[1] == 0.0
        finally:
            _close(peers)
            chaos.reset()


def _edges(graph):
    """Undirected edges of a broadcast graph."""
    out = set()
    for i in range(len(graph.nodes)):
        for j in graph.nodes[i].nexts:
            out.add((min(i, j), max(i, j)))
    return out


class TestPallasRingArm:
    def test_pallas_ring_in_default_arm_set(self, comm):
        d = DeviceBanditDriver(comm, check_every=2)
        assert d.table.arms == ALLREDUCE_SCHEDULES
        assert "pallas_ring" in d.table.arms
        comm.set_latency_hook(None)

    def test_pallas_ring_installs_per_bucket(self, comm, monkeypatch):
        from kungfu_tpu_torch.comm import device as dev

        d = DeviceBanditDriver(comm, check_every=1, min_pulls=1)
        lat = {"psum": 0.05, "two_stage": 0.04, "ring": 0.06,
               "pallas_ring": 0.001}
        small, large = 1 << 10, 1 << 20
        for _ in range(12):
            for arm, t in lat.items():
                d._on_collective(large, arm, t)
                d._on_collective(small, arm,
                                 0.0001 if arm == "psum" else 0.01)
            d.step()
        assert comm.strategy_for_bucket(1) == "pallas_ring"
        assert d.table.active[1] == "pallas_ring"
        assert comm.strategy_for_bucket(0) == "psum"
        ran = []
        real = dev.all_reduce_scheduled
        monkeypatch.setattr(dev, "all_reduce_scheduled",
                            lambda a, axes, op="sum", schedule="psum":
                            ran.append(schedule) or real(a, axes, op=op,
                                                         schedule=schedule))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4, large // 4)).astype(np.float32))
        out = comm.all_reduce(x)
        np.testing.assert_allclose(out.numpy(),
                                   np.broadcast_to(x.numpy().sum(0), x.shape),
                                   rtol=1e-4, atol=1e-4)
        assert ran == ["pallas_ring"]
        comm.set_latency_hook(None)

    def test_fenced_lockstep_install_across_ranks(self, monkeypatch):
        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        peers = _peers()
        try:
            comms = [Communicator(devices=["cpu"] * N, local_size=N)
                     for _ in peers]
            drivers = [DeviceBanditDriver(c, peer=p, check_every=2,
                                          min_pulls=1)
                       for c, p in zip(comms, peers)]

            def one(rank, d):
                skew_ = 1 + 0.3 * rank
                for arm, t in (("psum", 0.05), ("two_stage", 0.04),
                               ("ring", 0.06), ("pallas_ring", 0.002)):
                    d._on_collective(1 << 20, arm, t * skew_)
                return d.step()

            for step in range(10):
                flags = run_all([lambda r=r, d=d: one(r, d)
                                 for r, d in enumerate(drivers)], timeout=60)
                assert len(set(flags)) == 1, f"non-lockstep at {step}"
            assert {c.strategy_for_bucket(1) for c in comms} == \
                {"pallas_ring"}
            assert len({d._seq for d in drivers}) == 1
        finally:
            _close(peers)

    def test_reset_on_live_resize(self):
        peer = Peer(envs.parse_config_from_env({}), devices=["cpu"])
        comm0 = peer.communicator()
        d = DeviceBanditDriver(comm0, peer=peer, check_every=1, min_pulls=1)
        for _ in range(6):
            for arm, t in (("psum", 0.05), ("two_stage", 0.04),
                           ("ring", 0.06), ("pallas_ring", 0.001)):
                d._on_collective(1 << 20, arm, t)
            d.step()
        assert comm0.strategy_for_bucket(1) == "pallas_ring"
        assert sum(d.table.tables[1].counts) > 0
        with peer._lock:
            peer._retire_comm()
        peer.cluster_version += 1
        d.step()
        comm1 = peer.communicator()
        assert d.comm is comm1 and comm1 is not comm0
        assert sum(sum(t.counts) for t in d.table.tables) == 0
        assert comm1.bucket_strategies() == {}
        assert d.table.active[1] == comm1.strategy_for_bucket(1)
        assert comm0._latency_hook is None
        d.on_membership_change(5)
        assert d._seen_version is None


# -- policy/ against the reference ---------------------------------------------------
def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.calls = []

    for hook in ("before_train", "after_train", "before_epoch",
                 "after_epoch", "before_step", "after_step"):
        setattr(Recorder, hook,
                lambda self, ctx, _h=hook: self.calls.append(_h))
    return Recorder()


class TestPolicy:
    def test_callback_order_and_globals(self):
        outs = []
        for base, runner in ((BasePolicy, PolicyRunner),
                             (jbase.BasePolicy, jrunner.PolicyRunner)):
            rec = _recorder(base)
            r = runner([rec], batch_size=32)
            r.before_train()
            r.before_epoch()
            for _ in range(3):
                r.before_step()
                params, stop = r.after_step(params={"w": 1},
                                            gradient_noise_scale=2.5,
                                            loss=0.5)
                assert not stop and params == {"w": 1}
            r.after_epoch()
            r.after_train()
            outs.append((rec.calls, r.ctx.step, r.ctx.trained_samples,
                         r.ctx.epoch, r.ctx.gradient_noise_scale,
                         r.ctx.metrics))
        assert outs[0] == outs[1]
        assert outs[0][0] == (["before_train", "before_epoch"]
                              + ["before_step", "after_step"] * 3
                              + ["after_epoch", "after_train"])
        assert outs[0][1:4] == (3, 96, 1)

    def test_stop_request(self):
        class Stopper(BasePolicy):
            def after_step(self, ctx):
                if ctx.step >= 2:
                    ctx.request_stop()

        r = PolicyRunner([Stopper()])
        assert r.after_step()[1] is False
        assert r.after_step()[1] is True

    def test_resize_intent_without_peer_is_noop(self):
        r = PolicyRunner([ScheduledSizePolicy("1:1,4:100")])
        params, stop = r.after_step(params=None)
        assert not stop and r.ctx.requested_size is None

    @pytest.mark.parametrize("schedule", ["1:2,2:2,4:10", "4:3,2:3,4:2"])
    def test_scheduled_size_matches_reference(self, schedule):
        got, want = [], []
        for cls, ctx_cls, out in (
                (ScheduledSizePolicy, PolicyContext, got),
                (jpolicies.ScheduledSizePolicy, jbase.PolicyContext, want)):
            p = cls(schedule)
            for step in range(12):
                ctx = ctx_cls(cluster_size=1 + step % 4)
                ctx.step = step
                p.after_step(ctx)
                out.append(ctx.requested_size)
        assert got == want and any(x is not None for x in got)

    def test_gns_resize_matches_reference(self):
        """Growth, the hysteresis band, no signal, and the cooldown, on
        one seeded stream of contexts through both packages."""
        rng = np.random.default_rng(3)
        cases = [(int(rng.integers(1, 5)) * 16, int(rng.integers(1, 17)),
                  None if rng.random() < 0.2 else float(rng.uniform(1, 4096)))
                 for _ in range(60)]
        out = []
        for cls, ctx_cls in ((GNSResizePolicy, PolicyContext),
                             (jpolicies.GNSResizePolicy, jbase.PolicyContext)):
            p = cls(min_size=1, max_size=32, threshold=0.5, cooldown_steps=4)
            seq = []
            for step, (bs, size, gns) in enumerate(cases):
                ctx = ctx_cls(batch_size=bs, cluster_size=size)
                ctx.step = step
                ctx.gradient_noise_scale = gns
                p.after_step(ctx)
                seq.append(ctx.requested_size)
            out.append(seq)
        assert out[0] == out[1] and any(x is not None for x in out[0])

    def test_gns_resize_cases(self):
        p = GNSResizePolicy(max_size=16)
        ctx = PolicyContext(batch_size=64, cluster_size=2)
        ctx.step = 100
        ctx.gradient_noise_scale = 512.0
        p.after_step(ctx)
        assert ctx.requested_size == 8
        ctx = PolicyContext(batch_size=64, cluster_size=8)
        ctx.gradient_noise_scale = 64.0 * 9
        GNSResizePolicy().after_step(ctx)
        assert ctx.requested_size is None
        p = GNSResizePolicy(cooldown_steps=10, max_size=64)
        ctx = PolicyContext(batch_size=32, cluster_size=2)
        ctx.step, ctx.gradient_noise_scale = 1, 32.0 * 16
        p.after_step(ctx)
        assert ctx.requested_size == 16
        ctx.requested_size, ctx.step = None, 5
        p.after_step(ctx)
        assert ctx.requested_size is None
        ctx.step = 12
        p.after_step(ctx)
        assert ctx.requested_size == 16

    def test_adaptive_strategy_policy_counts_swaps(self):
        peers = _peers(strategy="BINARY_TREE_STAR")
        try:
            pols = [policy.AdaptiveStrategyPolicy(
                p, check_every=1, min_steps_between_swaps=1,
                consecutive_drops=1) for p in peers]
            runners = [PolicyRunner([pol], peer=p)
                       for pol, p in zip(pols, peers)]

            def one(p, run):
                e = p.engine()
                e.all_reduce(np.ones(20_000, np.float32))
                e.best_throughputs = [1e12] * len(e.best_throughputs)
                run.after_step()
                return run.ctx.metrics.get("strategy_swaps")

            # every pinned window is a drop: one swap a step, in rotation
            for k, want in ((1, Strategy.MULTI_BINARY_TREE_STAR),
                            (2, Strategy.RING)):
                outs = run_all([lambda p=p, r=r: one(p, r)
                                for p, r in zip(peers, runners)], timeout=60)
                assert outs == [float(k)] * 3
                assert {p.engine().strategy for p in peers} == {want}
        finally:
            _close(peers)

    @pytest.mark.parametrize("name,item", [
        ("BatchWidthController", "A3"), ("ServeAutoscalePolicy", "A3"),
        ("serve_signals", "A3"), ("sentinel_signals", "A9b")])
    def test_not_ported_names_raise(self, name, item):
        """The serving names came with A3 and are the reference's
        policy/serve.py objects' counterparts; the sentinel's still
        raises, naming A9b."""
        if item == "A3":
            from kungfu_tpu.policy import serve as jserve
            from kungfu_tpu_torch.policy import serve as tserve

            got = getattr(policy, name)
            assert got is getattr(tserve, name)
            assert got.__name__ == getattr(jserve, name).__name__
        else:
            with pytest.raises(NotImplementedError, match=item):
                getattr(policy, name)
        with pytest.raises(AttributeError):
            policy.no_such_name  # noqa: B018
