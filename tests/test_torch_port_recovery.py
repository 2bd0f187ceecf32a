"""Port parity: failure detection and in-flight recovery.

Mirrors of ``tests/test_chaos.py`` (typed peer failure, a peer killed
mid-allreduce and its edge cases, a death mid-flight on an async
handle), ``tests/test_slices.py`` (topology, verdict, quorum, slice
shrinks), ``tests/test_persist.py`` (manifests, GC, restore onto other
world sizes, plane handles, agreement, knobs), ``tests/test_failure_detection.py``
(the detector, the compile grace, silent ranks, npz checkpoints) and
the recovery and guard cases of ``tests/test_reshard.py`` through real
peers -- on the port, with the JAX package (``kungfu_tpu``) run on the
same inputs wherever the two can be compared: the shrunk sums, the
re-carve's timeline marks, manifests and checkpoints written by each
package and read by the other, and system-sized runs of the quick GPT
of ``tests/test_reshard.py:202`` through a kill, a shrink, a replay and
a cold restore.

Peers take ports found free (the port's ``start_local_cluster``, the
reference's :func:`_ref_peers`, each retrying the whole cluster on
``EADDRINUSE``); detectors and channels bind port 0 or ports found free;
``KF_TPU_USE_UNIXSOCK=0``.  Every join and receive is bounded.
"""

import errno
import json
import math
import os
import socket
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu import chaos as jchaos
from kungfu_tpu import checkpoint as jckpt
from kungfu_tpu.checkpoint import StepSnapshot as JStepSnapshot
from kungfu_tpu.comm import faults as jfaults
from kungfu_tpu.elastic import hooks as jhooks
from kungfu_tpu.elastic import persist as jpersist
from kungfu_tpu.elastic import shrink as jshrink
from kungfu_tpu.elastic import slices as jslices
from kungfu_tpu.elastic.reshard import ZeroBoundary as JZeroBoundary
from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.monitor import timeline as jtimeline
from kungfu_tpu.parallel import zero as jzero
from kungfu_tpu.peer import Peer as JPeer
from kungfu_tpu.utils import envs as jenvs
from kungfu_tpu_torch import chaos, checkpoint, interop
from kungfu_tpu_torch.checkpoint import StepSnapshot
from kungfu_tpu_torch.comm import faults
from kungfu_tpu_torch.comm.engine import CollectiveEngine
from kungfu_tpu_torch.comm.host import HostChannel
from kungfu_tpu_torch.elastic import hooks as port_hooks
from kungfu_tpu_torch.elastic import persist, shrink, slices
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.elastic.hooks import ElasticState, elastic_step
from kungfu_tpu_torch.elastic.reshard import ZeroBoundary
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.detector import DetectorServer, post_signal
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.parallel import zero
from kungfu_tpu_torch.peer import start_local_cluster
from kungfu_tpu_torch.plan import PeerID, PeerList, Strategy
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten
from tests._util import run_all

#: the quick GPT's run against the reference's: five SGD-with-momentum
#: steps from identical params, each rank's gradient from jax and from
#: torch (tests/test_torch_port_train.py's TRAIN_ATOL)
TRAIN_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for k in ("KF_CHAOS_SPEC", "KF_TPU_HOST_TRANSPORT", "KF_MONITOR_ADDR",
              "MEGASCALE_NUM_SLICES", "KF_SLICE_RANKS", "MEGASCALE_SLICE_ID",
              "KF_CONFIG_ENABLE_TRACE", "KF_PERSIST_DIR", "KF_PERSIST_PERIOD",
              "KF_PERSIST_RESTORE", "KF_PERSIST_KEEP",
              "KF_PERSIST_ASYNC_DEPTH", "KF_TPU_CKPT_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


_STAR = {"KF_ALLREDUCE_STRATEGY": "STAR"}


def _port_peers(n, extra=None):
    return start_local_cluster(n, env={**_STAR, **(extra or {})},
                               devices=["cpu"])


def _ref_peers(n, extra=None, attempts=5):
    """``n`` started reference peers on ports found free; the whole
    cluster retries on EADDRINUSE."""
    for _ in range(attempts):
        ports = _free_ports(n)
        peers = []
        try:
            for r in range(n):
                env = {**envs.single_machine_env(r, n, ports=ports), **_STAR,
                       **(extra or {})}
                peers.append(JPeer(jenvs.parse_config_from_env(env)))
                peers[-1].start()
            return peers
        except OSError as e:
            for p in peers:
                p.close()
            if getattr(e, "errno", None) not in (None, errno.EADDRINUSE):
                raise
    raise OSError("no free ports for a reference cluster")


PORT = types.SimpleNamespace(
    name="port", peers=_port_peers, chaos=chaos, faults=faults,
    Snapshot=StepSnapshot, shrink=shrink)
REF = types.SimpleNamespace(
    name="ref", peers=_ref_peers, chaos=jchaos, faults=jfaults,
    Snapshot=JStepSnapshot, shrink=jshrink)


def _close(peers):
    for p in peers:
        p.close()


def _join(ts, timeout=60):
    for t in ts:
        t.start()
    deadline = time.monotonic() + timeout
    for t in ts:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in ts), "recovery hung"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ==========================================================================
# tests/test_chaos.py
# ==========================================================================
@pytest.fixture
def python_transport(monkeypatch):
    """The wire-level chaos faults live in the Python transport, as the
    reference's chaos tests run it."""
    monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")


class TestTypedPeerFailure:
    def test_recv_deadline_names_the_suspect(self, monkeypatch,
                                             python_transport):
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "1.5")
        chans = [HostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
                 for _ in range(2)]
        peers = PeerList.of(*(c.self_id for c in chans))
        engines = [CollectiveEngine(c, peers, Strategy.STAR) for c in chans]
        chans[1].close()  # rank 1 dies before the collective
        try:
            with pytest.raises(faults.PeerFailureError) as ei:
                engines[0].all_reduce(np.ones(4, np.float32))
            assert ei.value.rank == 1
            assert not chans[0].ping(peers[1], timeout=1.0)
        finally:
            chans[0].close()


def _kill_mid_allreduce(pkg, monkeypatch, n=3, victim=2, coll=2):
    """tests/test_chaos.py::TestKillOnePeerMidAllreduce::
    test_shrink_to_survivors on ``pkg``: rank ``victim`` of ``n`` dies at
    its ``coll``-th engine collective; the survivors shrink, replay and
    finish the step.  Returns ``(results, peers)``."""
    monkeypatch.setenv("KF_CHAOS_SPEC",
                       f"die:coll={coll},rank={victim},mode=raise")
    monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "2")
    peers = pkg.peers(n)
    data = [np.arange(32, dtype=np.float32) * (i + 1) for i in range(n)]
    snaps = [pkg.Snapshot() for _ in range(n)]
    outs = run_all([lambda p=p, d=d: p.engine().all_reduce(d, name="s1")
                    for p, d in zip(peers, data)])
    for i, o in enumerate(outs):
        assert np.array_equal(_np(o), sum(data))
        snaps[i].commit(1, {"w": o})
    results = [None] * n

    def victim_fn():
        try:
            peers[victim].engine().all_reduce(data[victim], name="s2")
            results[victim] = ("no-death", None)
        except pkg.chaos.InjectedDeath:
            peers[victim].close()
            results[victim] = ("died", None)

    def survivor(i):
        try:
            results[i] = ("clean", peers[i].engine().all_reduce(
                data[i], name="s2"))
        except pkg.faults.PeerFailureError as err:
            shrunk, replay = peers[i].recover_from_failure(
                err, snapshot=snaps[i])
            out = peers[i].engine().all_reduce(data[i], name="s2r")
            results[i] = ("recovered", (shrunk, replay[0], err.rank,
                                        _np(out)))

    _join([threading.Thread(target=victim_fn, daemon=True)]
          + [threading.Thread(target=survivor, args=(i,), daemon=True)
             for i in range(n) if i != victim])
    return results, peers, data


class TestKillOnePeerMidAllreduce:
    def test_shrink_to_survivors_matches_reference(self, monkeypatch,
                                                   python_transport):
        got = {}
        for pkg in (PORT, REF):
            res, peers, data = _kill_mid_allreduce(pkg, monkeypatch)
            try:
                assert res[2] == ("died", None)
                for i in (0, 1):
                    status, (shrunk, step, suspect, out) = res[i]
                    assert status == "recovered" and shrunk and step == 1
                    assert np.array_equal(out, data[0] + data[1])
                    assert peers[i].size() == 2
                    assert peers[i].cluster_version == 1
                    assert not peers[i].detached
                assert peers[0].cluster.digest() == \
                    peers[1].cluster.digest()
                got[pkg.name] = [res[i][1][3] for i in (0, 1)]
            finally:
                _close(peers[:2])
        for a, b in zip(got["port"], got["ref"]):
            np.testing.assert_array_equal(a, b)

    def test_divergent_committed_steps_adopt_the_leader(self, monkeypatch,
                                                        python_transport):
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:coll=1,rank=2,mode=raise")
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "2")
        peers = _port_peers(3)
        snaps = [StepSnapshot() for _ in range(3)]
        snaps[0].commit(4, {"w": np.full(8, 4.0, np.float32)}, {"epoch": 1})
        snaps[1].commit(5, {"w": np.full(8, 5.0, np.float32)}, {"epoch": 1})
        results = [None] * 2
        try:
            def victim():
                try:
                    peers[2].engine().all_reduce(np.ones(8, np.float32))
                except chaos.InjectedDeath:
                    peers[2].close()

            def survivor(i):
                try:
                    peers[i].engine().all_reduce(np.ones(8, np.float32),
                                                 name="x")
                except faults.PeerFailureError as err:
                    results[i] = peers[i].recover_from_failure(
                        err, snapshot=snaps[i])

            _join([threading.Thread(target=victim, daemon=True)]
                  + [threading.Thread(target=survivor, args=(i,),
                                      daemon=True) for i in (0, 1)])
            for i in (0, 1):
                shrunk, (step, tree, meta) = results[i]
                assert shrunk and step == 4 and meta == {"epoch": 1}
                assert torch.equal(tree["w"], torch.full((8,), 4.0))
            assert snaps[1].step() == 4
        finally:
            _close(peers[:2])

    def test_quorum_loss_falls_back_to_detector(self, monkeypatch,
                                                python_transport):
        detector = DetectorServer(expected_ranks=2, port=0, host="127.0.0.1",
                                  stall_timeout=1.0).start()
        monkeypatch.setenv("KF_MONITOR_ADDR", f"127.0.0.1:{detector.port}")
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:coll=1,rank=1,mode=raise")
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "1.5")
        peers = _port_peers(2)
        try:
            def victim():
                try:
                    peers[1].engine().all_reduce(np.ones(4, np.float32))
                except chaos.InjectedDeath:
                    peers[1].close()

            t = threading.Thread(target=victim, daemon=True)
            t.start()
            with pytest.raises(faults.PeerFailureError):
                peers[0].engine().all_reduce(np.ones(4, np.float32))
            t.join(10)
            with pytest.raises(faults.QuorumLostError):
                peers[0].recover_from_failure(faults.PeerFailureError(
                    1, peers[0].cluster.workers[1], phase="recv"))
            deadline = time.time() + 5
            while not detector.results.down_flag and time.time() < deadline:
                time.sleep(0.1)
            assert detector.results.down_flag
        finally:
            peers[0].close()
            detector.stop()

    def test_transient_failure_does_not_shrink(self, python_transport):
        peers = _port_peers(2)
        try:
            shrunk, replay = peers[0].recover_from_failure(
                faults.PeerFailureError(1, peers[0].cluster.workers[1],
                                        phase="recv"))
            assert not shrunk and replay is None
            assert peers[0].size() == 2
        finally:
            _close(peers)


class TestShrinkEdgeCases:
    def test_exact_half_is_not_quorum(self, python_transport):
        peers = _port_peers(4)
        try:
            with pytest.raises(faults.QuorumLostError):
                shrink.shrink_to_survivors(peers[0], [2, 3])
            assert peers[0].size() == 4 and peers[0].cluster_version == 0
        finally:
            _close(peers)

    def test_minimal_strict_majority_shrinks(self, python_transport):
        peers = _port_peers(5)
        try:
            _close(peers[3:])
            assert all(run_all([lambda p=p: shrink.shrink_to_survivors(
                p, [3, 4]) for p in peers[:3]]))
            for p in peers[:3]:
                assert (p.size(), p.cluster_version, p.detached) == \
                    (3, 1, False)
        finally:
            _close(peers[:3])

    def test_leader_death_during_replay_broadcast(self, monkeypatch,
                                                  python_transport):
        peers = _port_peers(2)
        snap = StepSnapshot()
        snap.commit(7, {"w": np.full(4, 7.0, np.float32)}, {"epoch": 2})
        try:
            def dead_leader_broadcast(*a, **k):
                raise TimeoutError("leader died mid-broadcast")

            monkeypatch.setattr(peers[1].channel, "broadcast_bytes",
                                dead_leader_broadcast)
            assert shrink._sync_replay_point(peers[1], snap) is None
            assert snap.step() == 7
        finally:
            _close(peers)

    def test_leader_side_broadcast_failure_is_contained(self,
                                                        python_transport):
        peers = _port_peers(2)
        snap = StepSnapshot()
        snap.commit(3, {"w": np.zeros(2, np.float32)})
        try:
            peers[1].close()
            assert shrink._sync_replay_point(peers[0], snap) is None
        finally:
            peers[0].close()

    def test_double_shrink_reentry(self, python_transport):
        peers = _port_peers(3)
        try:
            peers[2].close()
            assert all(run_all([lambda p=p: shrink.shrink_to_survivors(
                p, [2]) for p in peers[:2]]))
            assert peers[0].size() == 2 and peers[0].cluster_version == 1
            assert shrink.shrink_to_survivors(peers[0], [2]) is False
            shrunk, replay = peers[0].recover_from_failure()
            assert not shrunk and replay is None
            peers[1].close()
            with pytest.raises(faults.QuorumLostError):
                peers[0].recover_from_failure(faults.PeerFailureError(
                    1, peers[0].cluster.workers[1], phase="recv"))
        finally:
            peers[0].close()


class TestAsyncHandleFaults:
    def test_die_midflight_typed_at_wait_and_shrink_drains(
            self, monkeypatch, python_transport):
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:coll=2,rank=2,mode=raise")
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "2")
        peers = _port_peers(3)
        data = [np.arange(32, dtype=np.float32) * (i + 1) for i in range(3)]
        snaps = [StepSnapshot() for _ in range(3)]
        try:
            outs = run_all([lambda p=p, d=d: p.engine().all_reduce(
                d, name="s1") for p, d in zip(peers, data)])
            for i, o in enumerate(outs):
                snaps[i].commit(1, {"w": o})
            results = [None] * 3

            def victim():
                eng = peers[2].engine()
                ha = eng.all_reduce_async(data[2], name="s2")
                try:
                    ha.wait(timeout=30)
                    results[2] = ("no-death", None)
                except chaos.InjectedDeath:
                    peers[2].close()
                    results[2] = ("died", None)

            def survivor(i):
                eng = peers[i].engine()
                ha = eng.all_reduce_async(data[i], name="s2")
                hb = eng.all_reduce_async(data[i], name="s3")
                try:
                    ha.wait(timeout=30)
                    results[i] = ("clean", None)
                    hb.wait(timeout=30)
                except faults.PeerFailureError as err:
                    assert err.rank is not None
                    if i == 0:
                        assert err.rank == 2, err
                    shrunk, replay = peers[i].recover_from_failure(
                        err, snapshot=snaps[i])
                    assert shrunk and replay is not None
                    assert eng.inflight() == 0, "window not drained"
                    assert hb.done() and isinstance(
                        hb.error(), faults.PeerFailureError)
                    out = peers[i].engine().all_reduce(data[i], name="s2r")
                    results[i] = ("recovered", out)

            _join([threading.Thread(target=victim, daemon=True)]
                  + [threading.Thread(target=survivor, args=(i,),
                                      daemon=True) for i in (0, 1)])
            assert results[2][0] == "died"
            for i in (0, 1):
                status, out = results[i]
                assert status == "recovered", results[i]
                assert np.array_equal(out, data[0] + data[1])
                assert peers[i].size() == 2
            assert REGISTRY.snapshot().get("kf_overlap_inflight", 0.0) == 0.0
        finally:
            _close(peers[:2])

    def test_native_close_while_receiving(self, monkeypatch):
        """A dying peer closes its native channel while its engine's
        pool threads are still inside receives, pings and sends (more
        threads than cores, a short switch interval): each leaves with
        the closed status, and the process does not fault."""
        import sys

        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "native")
        chans = [HostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
                 for _ in range(2)]
        peers = PeerList.of(*(c.self_id for c in chans))
        errs, others = [], []

        def recv():
            try:
                chans[0].recv(peers[1], "never", timeout=30)
            except (ConnectionError, TimeoutError) as e:
                errs.append(e)

        def churn():
            try:
                while True:
                    chans[0].ping(peers[1], timeout=1.0)
                    chans[0].send(peers[1], "x", b"1234", retries=1)
            except ConnectionError as e:
                others.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            ts = ([threading.Thread(target=recv, daemon=True)
                   for _ in range(2 * (os.cpu_count() or 4))]
                  + [threading.Thread(target=churn, daemon=True)
                     for _ in range(4)])
            for t in ts:
                t.start()
            time.sleep(0.3)
            chans[0].close()
            for t in ts:
                t.join(10)
        finally:
            sys.setswitchinterval(old)
            chans[1].close()
        assert not any(t.is_alive() for t in ts)
        assert len(errs) == len(ts) - 4 and len(others) == 4
        assert all(isinstance(e, ConnectionError) for e in errs)
        with pytest.raises(ConnectionError):
            chans[0].ping(peers[1])


# ==========================================================================
# tests/test_slices.py
# ==========================================================================
class TestSliceTopology:
    def test_mapping_leaders_and_for_size(self):
        for mod in (slices, jslices):
            t = mod.SliceTopology(3, 2)
            assert t.size == 6
            assert [t.slice_of(r) for r in range(6)] == [0, 0, 1, 1, 2, 2]
            assert t.ranks_in(1) == [2, 3] and t.leader_of(2) == 4
            assert t.for_size(4) == mod.SliceTopology(2, 2)
            with pytest.raises(ValueError):
                t.for_size(5)
            for bad in (lambda: t.slice_of(6), lambda: t.ranks_in(3),
                        lambda: mod.SliceTopology(0, 1)):
                with pytest.raises(ValueError):
                    bad()

    @pytest.mark.parametrize("env,n", [
        ({}, 4), ({"MEGASCALE_NUM_SLICES": "1"}, 4),
        ({"MEGASCALE_NUM_SLICES": "2"}, 4),
        ({"MEGASCALE_NUM_SLICES": "2", "KF_SLICE_RANKS": "3"}, 4),
        ({"MEGASCALE_NUM_SLICES": "4"}, 8)])
    def test_bootstrap_matches_reference(self, env, n):
        got = slices.bootstrap_topology(n, env)
        want = jslices.bootstrap_topology(n, env)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.num_slices, got.ranks_per_slice) == \
                (want.num_slices, want.ranks_per_slice)

    def test_bootstrap_errors(self):
        for mod in (slices, jslices):
            with pytest.raises(ValueError):
                mod.bootstrap_topology(3, {"MEGASCALE_NUM_SLICES": "2"})
            with pytest.raises(ValueError):
                mod.bootstrap_topology(4, {"MEGASCALE_NUM_SLICES": "2",
                                           "KF_SLICE_RANKS": "0"})

    @pytest.mark.parametrize("rps", [1, 2, 3, 4])
    def test_align_to_slices(self, rps):
        for ask in range(0, 13):
            assert slices.align_to_slices(ask, slices.SliceTopology(4, rps)) \
                == jslices.align_to_slices(ask, jslices.SliceTopology(4, rps))

    def test_verdict_and_quorum_match_reference(self):
        for ns, rps in ((2, 2), (3, 2), (4, 1), (2, 3)):
            tp, tj = slices.SliceTopology(ns, rps), \
                jslices.SliceTopology(ns, rps)
            n = ns * rps
            for mask in range(1 << n):
                dead = [r for r in range(n) if mask >> r & 1]
                assert slices.slice_verdict(dead, tp) == \
                    jslices.slice_verdict(dead, tj)
            for mask in range(1 << ns):
                alive = [s for s in range(ns) if mask >> s & 1]
                assert slices.slice_quorum_ok(alive, tp) == \
                    jslices.slice_quorum_ok(alive, tj)


def _slice_env(monkeypatch, n, num_slices):
    monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", str(num_slices))
    monkeypatch.setenv("KF_SLICE_RANKS", str(n // num_slices))


class TestSlicePeers:
    def test_peer_wiring(self, monkeypatch):
        p = _port_peers(1)[0]
        try:
            assert p.slice_topology() is None and p._comm_strategy == "psum"
        finally:
            p.close()
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        monkeypatch.setenv("KF_SLICE_RANKS", "1")
        ps = _port_peers(2)
        try:
            assert ps[0].slice_topology() == slices.SliceTopology(2, 1)
            assert ps[1].slice_id() == 1
            assert ps[0]._comm_strategy == "two_stage"
        finally:
            _close(ps)
        monkeypatch.delenv("KF_SLICE_RANKS")
        ps = _port_peers(3)  # an inherited count that does not tile: flat
        try:
            assert ps[0].slice_topology() is None
            assert ps[0]._comm_strategy == "psum"
        finally:
            _close(ps)

    def _scenario(self, monkeypatch, n, num_slices, spec, victims,
                  excluded=()):
        _slice_env(monkeypatch, n, num_slices)
        monkeypatch.setenv("KF_CHAOS_SPEC", spec)
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "2")
        peers = _port_peers(n)
        data = [np.ones(8, np.float32) * (i + 1) for i in range(n)]
        snaps = [StepSnapshot() for _ in range(n)]
        outs = run_all([lambda p=p, d=d: p.engine().all_reduce(
            d, name="s1") for p, d in zip(peers, data)])
        for i, o in enumerate(outs):
            snaps[i].commit(1, {"w": o})
        results = [None] * n

        def one(i):
            try:
                peers[i].engine().all_reduce(data[i], name="s2")
                results[i] = ("clean", None)
            except chaos.InjectedDeath:
                peers[i].close()
                results[i] = ("died", None)
            except faults.PeerFailureError as err:
                try:
                    shrunk, replay = peers[i].recover_from_failure(
                        err, snapshot=snaps[i])
                    out = (peers[i].engine().all_reduce(data[i], name="s2r")
                           if shrunk else None)
                    results[i] = ("recovered", (shrunk, replay, out))
                except faults.SliceExcludedError as exc:
                    results[i] = ("excluded", exc)
                except faults.QuorumLostError as q:
                    results[i] = ("quorum-lost", q)

        _join([threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(n)])
        return peers, data, results

    def test_whole_slice_death_shrinks_to_surviving_slice(self, monkeypatch):
        peers, data, res = self._scenario(
            monkeypatch, 4, 2, "die_slice:slice=1,coll=2,mode=raise,rps=2",
            (2, 3))
        try:
            assert res[2][0] == res[3][0] == "died"
            for i in (0, 1):
                status, (shrunk, replay, out) = res[i]
                assert status == "recovered" and shrunk and replay[0] == 1
                assert np.array_equal(out, data[0] + data[1])
                assert peers[i].slice_topology() == slices.SliceTopology(1, 2)
        finally:
            _close(peers[:2])

    def test_partial_slice_death_excludes_the_whole_slice(self, monkeypatch):
        peers, _, res = self._scenario(
            monkeypatch, 4, 2, "die:coll=2,rank=2,mode=raise", (2,))
        try:
            assert res[2][0] == "died"
            assert res[3][0] == "excluded" and res[3][1].slice_id == 1
            for i in (0, 1):
                assert res[i][0] == "recovered" and res[i][1][0]
                assert peers[i].size() == 2
                assert peers[i].cluster.workers.rank(
                    peers[3].config.self_id) is None
        finally:
            _close([peers[i] for i in (0, 1, 3)])

    def test_losing_slice_zero_loses_quorum(self, monkeypatch):
        peers, _, res = self._scenario(
            monkeypatch, 2, 2, "die_slice:slice=0,coll=2,mode=raise,rps=1",
            (0,))
        try:
            assert res[0][0] == "died" and res[1][0] == "quorum-lost"
        finally:
            peers[1].close()

    def test_rank_death_on_last_slice_shrinks_by_rank(self, monkeypatch):
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        monkeypatch.setenv("KF_SLICE_RANKS", "3")
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:coll=2,rank=2,mode=raise")
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "2")
        peers = _port_peers(3)
        assert peers[0].slice_topology().num_slices == 1
        data = [np.ones(8, np.float32) * (i + 1) for i in range(3)]
        snaps = [StepSnapshot() for _ in range(3)]
        try:
            outs = run_all([lambda p=p, d=d: p.engine().all_reduce(
                d, name="s1") for p, d in zip(peers, data)])
            for i, o in enumerate(outs):
                snaps[i].commit(1, {"w": o})
            results = [None] * 3

            def one(i):
                try:
                    peers[i].engine().all_reduce(data[i], name="s2")
                except chaos.InjectedDeath:
                    peers[i].close()
                    results[i] = "died"
                except faults.PeerFailureError as err:
                    shrunk, replay = peers[i].recover_from_failure(
                        err, snapshot=snaps[i])
                    results[i] = shrunk and replay[0] == 1

            _join([threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(3)])
            assert results == [True, True, "died"]
            for i in (0, 1):
                assert peers[i].size() == 2
                assert peers[i].slice_topology() is None
        finally:
            _close(peers[:2])


# ==========================================================================
# tests/test_persist.py, and manifests across the packages
# ==========================================================================
TOTAL = 10


def _chunks_of(full, total, n):
    chunk = math.ceil(total / n)
    buf = np.zeros((chunk * n,), full.dtype)
    buf[:total] = full[:total]
    return [buf[r * chunk:(r + 1) * chunk] for r in range(n)]


def _vectors(seed=9):
    rng = np.random.RandomState(seed)
    return {"mu": rng.randn(TOTAL).astype(np.float32),
            "nu": rng.randn(TOTAL).astype(np.float32)}


def _write_world(root, n, vecs, step=7, cv=0, replicated=None, ref=False):
    """One complete manifest: ``n`` planes of one package (the port's, or
    the reference's with ``ref``), each persisting its own chunk."""
    mu = _chunks_of(vecs["mu"], TOTAL, n)
    nu = _chunks_of(vecs["nu"], TOTAL, n)
    mdir = None
    for r in range(n):
        if ref:
            b = JZeroBoundary()
            b.commit_local(step, {"mu": mu[r], "nu": nu[r],
                                  "count": np.int64(step)},
                           total=TOTAL, old_n=n, my_old=r)
            plane = jpersist.PersistPlane(root, r, cluster_version=cv,
                                          period_s=0.0, depth=2, keep=10)
        else:
            b = ZeroBoundary()
            b.commit_local(step, {"mu": torch.from_numpy(mu[r]),
                                  "nu": torch.from_numpy(nu[r]),
                                  "count": torch.tensor(step)},
                           total=TOTAL, old_n=n, my_old=r)
            plane = persist.PersistPlane(root, r, cluster_version=cv,
                                         period_s=0.0, depth=2, keep=10)
        mdir = plane.persist_async(step, b, replicated=replicated).wait()
        plane.close()
    return mdir


def _gathered(states, leaf):
    chunk = states[0].chunk
    buf = np.zeros((chunk * len(states),), np.float32)
    for r, st in enumerate(states):
        buf[r * chunk:(r + 1) * chunk] = _np(st.vec[leaf])
    return buf[:TOTAL]


class TestManifestCompleteness:
    def test_complete_round_trip(self, tmp_path):
        mdir = _write_world(str(tmp_path), 2, _vectors())
        assert persist.manifest_complete(mdir)
        assert persist.newest_complete_manifest(str(tmp_path)) == mdir
        assert os.path.basename(mdir) == persist.manifest_name(7, 0) == \
            jpersist.manifest_name(7, 0)

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_torn_segment_refused_in_both(self, tmp_path, writer):
        mdir = _write_world(str(tmp_path), 2, _vectors(), ref=writer == "ref")
        segp = os.path.join(mdir, "rank1.seg.npz")
        with open(segp, "rb") as f:
            data = f.read()
        with open(segp, "wb") as f:
            f.write(data[:-7])
        for mod in (persist, jpersist):
            assert not mod.manifest_complete(mdir)
            assert not mod.manifest_complete(mdir, digest=False)
            assert mod.newest_complete_manifest(str(tmp_path)) is None
            with pytest.raises(mod.ManifestError):
                mod.restore_from_manifest(mdir, 1, 2)

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_same_size_corruption_needs_the_digest(self, tmp_path, writer):
        mdir = _write_world(str(tmp_path), 2, _vectors(), ref=writer == "ref")
        segp = os.path.join(mdir, "rank0.seg.npz")
        with open(segp, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0xFF
        with open(segp, "wb") as f:
            f.write(bytes(data))
        for mod in (persist, jpersist):
            assert mod.manifest_complete(mdir, digest=False)
            assert not mod.manifest_complete(mdir)
            with pytest.raises(mod.ManifestError):
                mod.restore_from_manifest(mdir, 0, 2)

    def test_missing_commit_record_is_partial(self, tmp_path):
        mdir = _write_world(str(tmp_path), 2, _vectors())
        os.unlink(os.path.join(mdir, "rank1.ok.json"))
        assert not persist.manifest_complete(mdir)

    def test_newest_complete_beats_newer_partial(self, tmp_path):
        old = _write_world(str(tmp_path), 2, _vectors(), step=5)
        new = _write_world(str(tmp_path), 2, _vectors(seed=10), step=9)
        os.unlink(os.path.join(new, "rank0.ok.json"))
        assert persist.newest_complete_manifest(str(tmp_path)) == old
        assert persist.choose_manifest(str(tmp_path)) == \
            jpersist.choose_manifest(str(tmp_path)) == (5, 0)

    def test_format_mismatch_refuses(self, tmp_path):
        mdir = _write_world(str(tmp_path), 2, _vectors())
        metap = os.path.join(mdir, "meta.json")
        with open(metap) as f:
            meta = json.load(f)
        meta["format"] = persist.FORMAT + 1
        with open(metap, "w") as f:
            json.dump(meta, f)
        with pytest.raises(persist.ManifestError):
            persist.restore_from_manifest(mdir, 0, 2)


class TestGC:
    def test_keep_last_k(self, tmp_path):
        for s in (1, 2, 3, 4):
            _write_world(str(tmp_path), 2, _vectors(seed=s), step=s)
        removed = persist.gc_manifests(str(tmp_path), keep=2)
        assert [s for s, _, _ in persist.manifest_dirs(str(tmp_path))] == \
            [3, 4]
        assert sorted(os.path.basename(p) for p in removed) == \
            [persist.manifest_name(1, 0), persist.manifest_name(2, 0)]

    def test_only_complete_manifest_never_deleted(self, tmp_path):
        older = _write_world(str(tmp_path), 2, _vectors(), step=2)
        keeper = _write_world(str(tmp_path), 2, _vectors(), step=5)
        newer = _write_world(str(tmp_path), 2, _vectors(), step=8)
        os.unlink(os.path.join(older, "rank0.ok.json"))
        os.unlink(os.path.join(newer, "rank1.ok.json"))
        assert persist.gc_manifests(str(tmp_path), keep=1) == [older]
        assert os.path.isdir(keeper) and os.path.isdir(newer)
        os.unlink(os.path.join(keeper, "rank0.ok.json"))
        assert persist.gc_manifests(str(tmp_path), keep=1) == []


class TestRestoreReshard:
    @pytest.mark.parametrize("writer,reader", [
        ("port", "port"), ("port", "ref"), ("ref", "port")])
    @pytest.mark.parametrize("old_n,new_n", [(4, 2), (2, 4), (3, 3), (1, 1),
                                             (4, 3)])
    def test_restore_bitwise_across_packages(self, tmp_path, writer, reader,
                                             old_n, new_n):
        vecs = _vectors(seed=old_n * 10 + new_n)
        params = np.arange(6, dtype=np.float32) / 7
        mdir = _write_world(str(tmp_path), old_n, vecs, step=7,
                            replicated={"params": params},
                            ref=writer == "ref")
        mod = persist if reader == "port" else jpersist
        sts = [mod.restore_from_manifest(mdir, r, new_n)
               for r in range(new_n)]
        # dict keys flatten sorted: leaf 0 = count, 1/2 = mu/nu
        np.testing.assert_array_equal(_gathered(sts, 1), vecs["mu"])
        np.testing.assert_array_equal(_gathered(sts, 2), vecs["nu"])
        for st in sts:
            assert st.step == 7 and st.new_n == new_n
            assert int(st.scal[0]) == 7
            assert str(_np(st.scal[0]).dtype) == "int64"
            np.testing.assert_array_equal(_np(st.replicated["params"]),
                                          params)

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_bf16_replicated_leaf_casts_back(self, tmp_path, writer):
        import ml_dtypes

        vals = np.array([1.5, -2.25, 3e-3, 7.0], np.float32)
        if writer == "ref":
            rep = vals.astype(ml_dtypes.bfloat16)
        else:
            rep = torch.from_numpy(vals).to(torch.bfloat16)
        mdir = _write_world(str(tmp_path), 2, _vectors(),
                            replicated={"h": rep}, ref=writer == "ref")
        got = persist.restore_from_manifest(mdir, 0, 1).replicated["h"]
        want = jpersist.restore_from_manifest(mdir, 0, 1).replicated["h"]
        assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))

    def test_install_into_boundary_continues_live(self, tmp_path):
        vecs = _vectors(seed=13)
        mdir = _write_world(str(tmp_path), 4, vecs, step=7)
        st = persist.restore_from_manifest(mdir, 1, 2)
        b = ZeroBoundary()
        st.install_into_boundary(b)
        step, vec, _ = b.chunks()
        assert step == 7
        assert torch.equal(vec[1], st.vec[1]) and \
            torch.equal(vec[2], st.vec[2])

    def test_bad_geometry_rejected(self, tmp_path):
        mdir = _write_world(str(tmp_path), 2, _vectors())
        for args in ((2, 2), (0, 0)):
            with pytest.raises(ValueError):
                persist.restore_from_manifest(mdir, *args)


class TestPlaneHandles:
    def _boundary(self, step=1):
        b = ZeroBoundary()
        b.commit_local(step, {"m": torch.zeros(TOTAL)}, total=TOTAL,
                       old_n=1, my_old=0)
        return b

    def test_commit_is_period_gated(self, tmp_path):
        plane = persist.PersistPlane(str(tmp_path), 0, period_s=1000.0)
        try:
            assert plane.commit(1, self._boundary(1)) is not None
            assert plane.commit(2, self._boundary(2)) is None
        finally:
            plane.close()

    def test_period_zero_persists_every_commit_and_fence_counts(
            self, tmp_path):
        plane = persist.PersistPlane(str(tmp_path), 0, period_s=0.0, depth=2,
                                     keep=10)
        try:
            for s in (1, 2, 3):
                assert plane.commit(s, self._boundary(s)) is not None
            assert plane.persist_fence() <= 2
            assert REGISTRY.gauge("kf_ckpt_last_step").value == 3.0
            assert REGISTRY.gauge("kf_ckpt_age_seconds").value < 60.0
            assert len(persist.manifest_dirs(str(tmp_path))) == 3
        finally:
            plane.close()

    def test_persist_before_any_commit_raises(self, tmp_path):
        plane = persist.PersistPlane(str(tmp_path), 0, period_s=0.0)
        try:
            with pytest.raises(ValueError):
                plane.persist_async(1, ZeroBoundary())
        finally:
            plane.close()

    def test_env_knobs(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KF_PERSIST_PERIOD", "0")
        monkeypatch.setenv("KF_PERSIST_KEEP", "0")
        monkeypatch.setenv("KF_PERSIST_ASYNC_DEPTH", "0")
        plane = persist.PersistPlane(str(tmp_path), 0)
        jplane = jpersist.PersistPlane(str(tmp_path), 0)
        try:
            assert (plane.period_s, plane.keep, plane.depth) == \
                (jplane.period_s, jplane.keep, jplane.depth) == (0.0, 1, 1)
        finally:
            plane.close()
            jplane.close()


class TestAgreement:
    def _agree(self, tmp_path, n, choice):
        chans = [HostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
                 for _ in range(n)]
        peers = PeerList.of(*(c.self_id for c in chans))
        planes = [persist.PersistPlane(str(tmp_path), r) for r in range(n)]
        try:
            return run_all([lambda r=r: planes[r].agree_manifest(
                chans[r], peers, r, *(choice if r == 0 else (-1, -1)))
                for r in range(n)], timeout=60)
        finally:
            for c in chans:
                c.close()
            for p in planes:
                p.close()

    def test_every_rank_adopts_rank0_choice(self, tmp_path):
        assert self._agree(tmp_path, 3, (7, 2)) == [(7, 2)] * 3
        assert persist.agreed_manifest_path(str(tmp_path), 7, 2) == \
            os.path.join(str(tmp_path), persist.manifest_name(7, 2))

    def test_fresh_start_sentinel_agreed(self, tmp_path):
        assert self._agree(tmp_path, 2, (-1, -1)) == [(-1, -1)] * 2
        assert persist.agreed_manifest_path(str(tmp_path), -1, -1) is None


class TestChaosPreempt:
    def test_parse_requires_explicit_all(self):
        for bad in ("preempt:step=2", "preempt:rank=1"):
            with pytest.raises(ValueError):
                chaos.parse_spec(bad)
        (c,) = chaos.parse_spec("preempt:all,step=2,mode=raise")
        assert c.kind == "preempt" and c.get("step") == 2

    def test_fires_on_every_rank_at_the_step(self):
        spec = chaos.parse_spec("preempt:all,step=2,mode=raise")
        for rank in (0, 5):
            ctl = chaos.ChaosController(spec, rank=rank, seed=0)
            ctl.on_step(1)
            with pytest.raises(chaos.InjectedDeath):
                ctl.on_step(2)

    def test_without_step_fires_at_first_boundary(self):
        ctl = chaos.ChaosController(
            chaos.parse_spec("preempt:all,mode=raise"), rank=3, seed=0)
        with pytest.raises(chaos.InjectedDeath):
            ctl.on_step(0)

    def test_drop_fanout(self):
        ctl = chaos.ChaosController(chaos.parse_spec(
            "drop_fanout:host=10.0.0.7,count=1"), rank=None, seed=0)
        assert not ctl.drop_fanout("10.0.0.8")
        assert ctl.drop_fanout("10.0.0.7")
        assert not ctl.drop_fanout("10.0.0.7")


# ==========================================================================
# tests/test_failure_detection.py
# ==========================================================================
@pytest.fixture
def detector():
    d = DetectorServer(expected_ranks=2, port=0, host="127.0.0.1",
                       stall_timeout=1.0, compile_grace=1.0).start()
    yield d
    d.stop()


def _post(d, **sig):
    post_signal("127.0.0.1", d.port, sig)


def _wait_down(d, deadline_s=10):
    deadline = time.time() + deadline_s
    while not d.results.down_flag and time.time() < deadline:
        time.sleep(0.05)
    return d.results.down_flag


class TestDetector:
    def test_port_zero_reports_the_bound_port(self, detector):
        assert detector.port > 0

    def test_stall_detection(self, detector):
        _post(detector, kind="epoch", rank=0, epoch=0)
        _post(detector, kind="epoch", rank=1, epoch=1)
        _post(detector, kind="begin", rank=1)
        assert _wait_down(detector)
        assert detector.results.epoch_num == 1 and detector.min_epoch() == 1

    def test_begin_end_cycle_no_false_positive(self, detector):
        for _ in range(3):
            _post(detector, kind="begin", rank=0)
            time.sleep(0.1)
            _post(detector, kind="end", rank=0)
        time.sleep(1.5)
        assert not detector.results.down_flag

    def test_finish_flag(self, detector):
        _post(detector, kind="trainend", rank=0)
        assert not detector.results.finish_flag
        _post(detector, kind="trainend", rank=1)
        assert detector.results.finish_flag

    def test_otherdown_intake_and_unknown_epoch(self, detector):
        _post(detector, kind="epoch", rank=0, epoch=4)
        _post(detector, kind="epoch", rank=1, epoch=5)
        _post(detector, kind="otherdown", epoch=-1)
        assert detector.results.down_flag and detector.results.epoch_num == 5
        detector.reset()
        _post(detector, kind="otherdown", epoch=3)
        assert detector.results.epoch_num == 3

    def test_report_local_down_without_state(self, detector):
        detector.report_local_down()
        assert detector.results.down_flag and detector.results.epoch_num == 0

    def test_status_endpoint_and_query(self, detector):
        from kungfu_tpu_torch.monitor.detector import query_detector

        with urllib.request.urlopen(f"http://127.0.0.1:{detector.port}/",
                                    timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert set(doc) == {"down", "epoch", "finished"}
        assert query_detector("127.0.0.1", detector.port) == doc

    def test_reset(self, detector):
        _post(detector, kind="otherdown", epoch=3)
        detector.reset()
        assert not detector.results.down_flag and detector.min_epoch() == 0

    def test_signals_from_the_worker_side(self, monkeypatch, detector):
        from kungfu_tpu_torch.monitor import signals

        monkeypatch.setenv("KF_MONITOR_ADDR", f"127.0.0.1:{detector.port}")
        signals.monitor_batch_begin(0)
        signals.monitor_batch_end(0)
        signals.monitor_epoch_end(0, 2)
        signals.monitor_compile_grace(1)
        signals.monitor_train_end(0)
        assert detector._ranks[0].epochs_done == 3
        assert detector._ranks[1].grace_pending
        signals.monitor_report_down()
        assert detector.results.down_flag
        monkeypatch.delenv("KF_MONITOR_ADDR")
        signals.monitor_batch_begin(0)  # unset: a no-op


@pytest.fixture
def grace_detector():
    d = DetectorServer(expected_ranks=1, port=0, host="127.0.0.1",
                       stall_timeout=0.5, compile_grace=2.5).start()
    yield d
    d.stop()


class TestCompileGrace:
    def test_first_batch_outlasts_stall_timeout(self, grace_detector):
        d = grace_detector
        _post(d, kind="begin", rank=0)
        time.sleep(1.2)
        assert not d.results.down_flag
        _post(d, kind="end", rank=0)
        assert not d.results.down_flag

    def test_first_batch_grace_is_bounded(self, grace_detector):
        _post(grace_detector, kind="begin", rank=0)
        assert _wait_down(grace_detector)

    def test_steady_state_uses_stall_timeout(self, grace_detector):
        d = grace_detector
        for kind in ("begin", "end", "begin"):
            _post(d, kind=kind, rank=0)
        time.sleep(1.5)
        assert d.results.down_flag

    def test_grace_anchors_at_begin_and_dies_with_its_batch(
            self, grace_detector):
        d = grace_detector
        for kind in ("begin", "end", "grace"):
            _post(d, kind=kind, rank=0)
        time.sleep(1.0)
        _post(d, kind="begin", rank=0)
        time.sleep(1.2)
        assert not d.results.down_flag
        _post(d, kind="end", rank=0)
        _post(d, kind="begin", rank=0)
        time.sleep(1.5)
        assert d.results.down_flag

    def test_finished_rank_reuse_resets_state(self):
        d = DetectorServer(expected_ranks=2, port=0, host="127.0.0.1",
                           stall_timeout=0.5, compile_grace=2.5).start()
        try:
            for kind in ("begin", "end", "trainend", "begin"):
                _post(d, kind=kind, rank=0)
            time.sleep(1.2)
            assert not d.results.down_flag
            assert _wait_down(d)
        finally:
            d.stop()


@pytest.fixture
def silent_detector():
    d = DetectorServer(expected_ranks=2, port=0, host="127.0.0.1",
                       stall_timeout=0.5, compile_grace=1.5).start()
    yield d
    d.stop()


class TestSilentRankDetection:
    def test_grace_only_rank_death_detected(self, silent_detector):
        _post(silent_detector, kind="grace", rank=0)
        assert _wait_down(silent_detector)

    def test_epoch_only_rank_death_detected(self, silent_detector):
        _post(silent_detector, kind="epoch", rank=0, epoch=2)
        assert _wait_down(silent_detector)
        assert silent_detector.results.epoch_num == 3

    def test_grace_only_within_allowance_and_begin_cancels(
            self, silent_detector):
        _post(silent_detector, kind="grace", rank=0)
        time.sleep(0.8)
        assert not silent_detector.results.down_flag
        _post(silent_detector, kind="begin", rank=0)
        time.sleep(0.5)
        assert not silent_detector.results.down_flag


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": torch.ones(4, dtype=torch.float64)}
        checkpoint.save_checkpoint(str(tmp_path), 3, tree,
                                   meta={"epochs_done": 2})
        like = {"w": torch.zeros(2, 3), "b": torch.zeros(4,
                                                         dtype=torch.float64)}
        out, step, meta = checkpoint.restore_checkpoint(str(tmp_path), like)
        assert step == 3 and meta == {"epochs_done": 2}
        assert torch.equal(out["w"], tree["w"]) and \
            out["b"].dtype == torch.float64

    def test_latest_and_prune(self, tmp_path):
        tree = {"x": torch.zeros(2)}
        for s in range(5):
            checkpoint.save_checkpoint(str(tmp_path), s, tree)
        assert checkpoint.latest_step(str(tmp_path)) == 4
        checkpoint.prune_checkpoints(str(tmp_path), keep=2)
        assert checkpoint.latest_step(str(tmp_path)) == 4
        assert checkpoint.restore_checkpoint(str(tmp_path), tree,
                                             step=4) is not None
        with pytest.raises(FileNotFoundError):
            checkpoint.restore_checkpoint(str(tmp_path), tree, step=0)

    def test_restore_empty_dir(self, tmp_path):
        assert checkpoint.restore_checkpoint(
            str(tmp_path), {"x": torch.zeros(1)}) is None

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_checkpoints_cross_the_packages(self, monkeypatch, tmp_path,
                                            writer):
        monkeypatch.setenv("KF_TPU_CKPT_BACKEND", "npz")
        vals = {"a": np.arange(12, dtype=np.float32).reshape(3, 4) / 3,
                "b": np.array([1, -2, 3], np.int32),
                "h": np.array([0.5, -1.25, 8.0], np.float32)}
        tvals = {"a": torch.from_numpy(vals["a"]),
                 "b": torch.from_numpy(vals["b"]),
                 "h": torch.from_numpy(vals["h"]).to(torch.bfloat16)}
        jvals = {"a": vals["a"], "b": vals["b"],
                 "h": jnp.asarray(vals["h"], jnp.bfloat16)}
        if writer == "port":
            checkpoint.save_checkpoint(str(tmp_path), 9, tvals, {"k": 1})
        else:
            jckpt.save_checkpoint(str(tmp_path), 9, jvals, {"k": 1})
        got, step, meta = checkpoint.restore_checkpoint(str(tmp_path), tvals)
        want, jstep, jmeta = jckpt.restore_checkpoint(str(tmp_path), jvals)
        assert (step, meta) == (jstep, jmeta) == (9, {"k": 1})
        for k in vals:
            np.testing.assert_array_equal(
                got[k].float().numpy() if k == "h" else got[k].numpy(),
                np.asarray(want[k], np.float32) if k == "h" else want[k])

    def test_async_save_and_wait(self, tmp_path):
        t = {"x": torch.arange(5.0)}
        fut = checkpoint.save_checkpoint_async(str(tmp_path), 2, t)
        t["x"].add_(100)  # the snapshot was taken at issue
        checkpoint.wait_pending_checkpoints(timeout=30)
        assert fut.result().endswith("ckpt_00000002.npz")
        out, _, _ = checkpoint.restore_checkpoint(str(tmp_path), t)
        assert torch.equal(out["x"], torch.arange(5.0))


# ==========================================================================
# tests/test_reshard.py's recovery and guard cases, through real peers
# ==========================================================================
def _events(mod):
    return [(e["kind"], e["name"], sorted(e["attrs"]))
            for e in mod.snapshot() if e["kind"] == "shrink"]


class TestRecarveThroughPeers:
    def test_chunk_mode_recarve_marks_match_reference(self, monkeypatch):
        """C13: the re-carve's timeline marks, kinds, names and fields
        as the reference emits them, for one chunk-mode 4 -> 3 re-carve
        with rank 3 dead (its chunk from rank 2's mirror)."""
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        total = 11
        full = np.arange(total, dtype=np.float32) + 1
        out = {}
        for pkg, mod, start, Boundary, conv in (
                ("port", timeline, _port_peers, ZeroBoundary,
                 torch.from_numpy),
                ("ref", jtimeline, _ref_peers, JZeroBoundary, np.asarray)):
            mod.reset()
            peers = start(4)
            try:
                chunks = _chunks_of(full, total, 4)
                bs = []
                for r in range(4):
                    b = Boundary()
                    b.commit_local(1, {"m": conv(chunks[r])}, total=total,
                                   old_n=4, my_old=r)
                    bs.append(b)
                workers = peers[0].cluster.workers
                run_all([lambda b=b, p=p: b.replicate_ring(
                    p.channel, workers, tag="t") for b, p in zip(bs, peers)])
                peers[3].close()
                survivors = workers.select([0, 1, 2])
                run_all([lambda r=r: bs[r].recarve(
                    3, peer=peers[r], old_workers=workers,
                    new_workers=survivors, tag="t3", dead=[3])
                    for r in range(3)])
                got = np.concatenate([_np(bs[r].chunks()[1][0])
                                      for r in range(3)])
                np.testing.assert_array_equal(got[:total], full)
                out[pkg] = _events(mod)
            finally:
                _close(peers[:3])
                mod.reset()
        assert sorted(out["port"]) == sorted(out["ref"])
        assert ("shrink", "buddy-replicate",
                ["nbytes", "stride"]) in out["port"]
        assert ("shrink", "zero-recarve",
                ["new_n", "old_n", "segments", "total"]) in out["port"]

    def test_step_mismatch_fails_the_recovery(self, monkeypatch,
                                              python_transport):
        """Boundaries committed one step past the agreed replay point
        refuse the re-carve instead of blending two steps' state, after
        the shrink, before any segment moves."""
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "2")
        peers = _port_peers(3)
        try:
            bs, snaps = [], []
            for r in range(3):
                b = ZeroBoundary()
                b.commit_local(5, {"m": torch.zeros(4)}, total=10, old_n=3,
                               my_old=r)
                bs.append(b)
                s = StepSnapshot()
                s.commit(4, {"w": torch.zeros(2)})
                snaps.append(s)
            workers = peers[0].cluster.workers
            run_all([lambda b=b, p=p: b.replicate_ring(
                p.channel, workers, tag="g") for b, p in zip(bs, peers)])
            peers[2].close()
            res = run_all([lambda r=r: _catch(
                lambda: peers[r].recover_from_failure(
                    faults.PeerFailureError(2, workers[2], phase="recv"),
                    snapshot=snaps[r], zero_boundary=bs[r]))
                for r in (0, 1)], timeout=60)
            for r in res:
                assert isinstance(r, ValueError) and "blend" in str(r), r
            assert peers[0].size() == 2  # the shrink itself landed
            with pytest.raises(ValueError, match="StepSnapshot"):
                peers[0].recover_from_failure(zero_boundary=bs[0])
        finally:
            _close(peers[:2])

    def test_recv_timeout_becomes_peer_failure_error(self, monkeypatch):
        """A second death mid-exchange surfaces as the typed
        PeerFailureError, blaming the old rank that went quiet."""
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        peers = _port_peers(2)
        try:
            b = ZeroBoundary()
            b.commit_local(5, {"m": torch.zeros(5)}, total=10, old_n=2,
                           my_old=0)
            workers = peers[0].cluster.workers
            real = peers[0].channel.recv

            def quiet(src, name, *a, **k):
                raise TimeoutError(f"recv {name!r} timed out")

            monkeypatch.setattr(peers[0].channel, "recv", quiet)
            monkeypatch.setattr(peers[0].channel, "recv_into",
                                lambda *a, **k: quiet(*a[:2]))
            with pytest.raises(faults.PeerFailureError) as ei:
                b.recarve(1, peer=peers[0], old_workers=workers,
                          new_workers=workers.select([0]), tag="tt")
            assert ei.value.rank == 1
            del real
        finally:
            _close(peers)

    def test_elastic_step_grow_with_joiners_raises(self):
        server = ConfigServer(port=0, host="127.0.0.1").start()
        peers = _port_peers(2, {envs.CONFIG_SERVER: server.url})
        try:
            urllib.request.urlopen(urllib.request.Request(
                server.url, data=peers[0].cluster.to_json().encode(),
                method="PUT"), timeout=10).read()
            b = [ZeroBoundary() for _ in peers]
            res = run_all([lambda p=p, bb=bb: _catch(lambda: elastic_step(
                p, ElasticState(step=0), "3:100", params={},
                zero_boundary=bb)) for p, bb in zip(peers, b)], timeout=60)
            assert all(isinstance(r, ValueError) and "joiner" in str(r)
                       for r in res)
        finally:
            _close(peers)
            server.stop()


def _catch(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the test reads it
        return e


# ==========================================================================
# the quick GPT through a kill, a shrink, a replay and a cold restore
# ==========================================================================
_GPT = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq=16, dropout=0.0, dtype="float32")
LR, MOMENTUM = 0.05, 0.9
BUCKET = 4096


def _gpt():
    """tests/test_reshard.py:202's quick GPT, the same weights in both
    packages: ``(flat params, port grad, reference grad)``, a grad
    ``(flat, rank) -> flat`` of the mean loss over rank r's two rows of
    the batch (leaves in sorted-key order, alike in both trees)."""
    jmodel = jtr.Transformer(jtr.TransformerConfig(**_GPT))
    jp = jmodel.init(jax.random.PRNGKey(0))
    tcfg = ttr.TransformerConfig(**_GPT)
    tmodel = ttr.Transformer(tcfg)
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    ids = np.random.RandomState(2).randint(0, 512, size=(8, 16))
    leaves, treedef = tree_flatten(tp)
    sizes = [l.numel() for l in leaves]
    shapes = [l.shape for l in leaves]
    flat0 = torch.cat([l.reshape(-1) for l in leaves]).numpy().copy()

    def unflat(flat):
        parts, off = [], 0
        for m, shape in zip(sizes, shapes):
            parts.append(torch.from_numpy(flat[off:off + m].copy())
                         .reshape(shape))
            off += m
        return tree_unflatten(treedef, parts)

    def port_grad(flat, r):
        p = [l.requires_grad_(True) for l in tree_flatten(unflat(flat))[0]]
        rows = torch.from_numpy(ids[2 * r:2 * r + 2])
        loss = tmodel.loss(tree_unflatten(treedef, p), (rows, rows),
                           train=False)
        return torch.cat([g.reshape(-1) for g in
                          torch.autograd.grad(loss, p)]).numpy()

    def ref_grad(flat, r):
        jparams = jax.tree_util.tree_map(
            jnp.asarray, interop.params_to_jax(unflat(flat)))
        rows = jnp.asarray(ids[2 * r:2 * r + 2], jnp.int32)
        g = jax.grad(lambda p: jmodel.loss(p, (rows, rows), train=False))(
            jparams)
        return np.concatenate([np.asarray(x).reshape(-1)
                               for x in jax.tree_util.tree_leaves(g)])

    return flat0, port_grad, ref_grad


def _geometry(total, n):
    chunk = math.ceil(total / n)
    nb, rem = divmod(chunk, BUCKET)
    return chunk, [BUCKET] * nb + ([rem] if rem else [])


def _zero_step(pkg, peer, r, n, flat, grad, mom, k):
    """Rank ``r`` of ``n``'s host-plane ZeRO-2 step ``k`` (numpy f32
    momentum SGD on its chunk): the padded gradient mean reduce-scattered
    in buckets, the chunk updated, the params regathered.  Returns
    ``(new flat params, new momentum chunk)``."""
    total = flat.shape[0]
    chunk, widths = _geometry(total, n)
    g = np.zeros(n * chunk, np.float32)
    g[:total] = grad
    red = np.empty(chunk, np.float32)
    spans = pkg.zero.host_bucket_spans(chunk, widths)

    def keep(b, x):
        off, w = spans[b]
        red[off:off + w] = _np(x)

    eng = peer.engine()
    pkg.zero.host_bucket_pipeline(eng, g, widths, keep, op="mean",
                                  name=f"g{k}")
    mom = (red + np.float32(MOMENTUM) * mom).astype(np.float32)
    padded = np.zeros(n * chunk, np.float32)
    padded[:total] = flat
    own = (padded[r * chunk:(r + 1) * chunk]
           - np.float32(LR) * mom).astype(np.float32)
    full = pkg.zero.host_bucket_all_gather(eng, own, widths, name=f"p{k}")
    return _np(full).reshape(-1)[:total].copy(), mom


PORT.zero, REF.zero = zero, jzero
PORT.Boundary, REF.Boundary = ZeroBoundary, JZeroBoundary
PORT.persist, REF.persist = persist, jpersist
PORT.hooks, REF.hooks = port_hooks, jhooks
PORT.tensor = staticmethod(torch.from_numpy)
REF.tensor = staticmethod(np.asarray)


def _e2e(pkg, grad, flat0, root, monkeypatch):
    """Four peers of ``pkg``, host-plane ZeRO-2 with per-step commits
    (chunk-mode boundary with buddy mirrors, replay snapshot, manifest):
    steps 1-2 at four ranks; rank 3 dies at step 3's first engine
    collective; the survivors recover (the momentum re-carved, rank 3's
    chunk from its buddy) and run steps 3-4 from the agreed step 2; a
    ``preempt:all`` at the step-4 boundary; two fresh peers agree on and
    restore the step-4 manifest and take step 5.  Returns ``{step: flat
    params}``, the step-2 and step-4 momentum (the survivors' chunks
    concatenated) and the restored momentum."""
    total = flat0.shape[0]
    kill = (2 * len(_geometry(total, 4)[1]) + 1) * 2 + 1
    monkeypatch.setenv("KF_CHAOS_SPEC", f"die:coll={kill},rank=3,mode=raise;"
                       "preempt:all,step=4,mode=raise")
    monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "3")
    pkg.chaos.reset()
    peers = pkg.peers(4)
    zbs = [pkg.Boundary() for _ in range(4)]
    snaps = [pkg.Snapshot() for _ in range(4)]
    planes = [pkg.persist.PersistPlane(root, r, period_s=0.0, keep=10)
              for r in range(4)]
    moms = [np.zeros(_geometry(total, 4)[0], np.float32) for _ in range(4)]
    state = {"flat": flat0}
    flats, out = {}, {}

    def grads(n):
        """Every rank's gradient, on this thread before the ranks' start:
        no rank reaches the step's first collective a gradient late."""
        state["grads"] = [grad(state["flat"], r) for r in range(n)]

    def body(r, n, k, announce=True):
        p = peers[r]
        new, moms[r] = _zero_step(pkg, p, r, n, state["flat"],
                                  state["grads"][r], moms[r], k)
        zbs[r].commit_local(k, {"m": pkg.tensor(moms[r])}, total=total,
                            old_n=n, my_old=r)
        zbs[r].replicate_ring(p.channel, p.cluster.workers, tag=f"s{k}")
        snaps[r].commit(k, {"p": pkg.tensor(new)})
        planes[r].commit(k, zbs[r], replicated={"p": new} if r == 0 else None)
        planes[r].persist_fence()
        if announce:
            pkg.hooks.elastic_step(p, pkg.hooks.ElasticState(step=k), None,
                                   {"p": new})
        return new

    try:
        for k in (1, 2):
            grads(4)
            state["flat"] = flats[k] = run_all(
                [lambda r=r: body(r, 4, k) for r in range(4)], timeout=60)[0]
        out["mom2"] = np.concatenate(moms)
        res = [None] * 4

        def kill_body(r):
            try:
                body(r, 4, 3)
                res[r] = "no failure"
            except pkg.chaos.InjectedDeath:
                planes[r].close()
                peers[r].close()
                res[r] = "died"
            except pkg.faults.PeerFailureError as err:
                res[r] = peers[r].recover_from_failure(
                    err, snapshot=snaps[r], zero_boundary=zbs[r])

        grads(4)
        _join([threading.Thread(target=kill_body, args=(r,), daemon=True)
               for r in range(4)])
        assert res[3] == "died"
        for r in range(3):
            shrunk, replay = res[r]
            assert shrunk and replay[0] == 2
            np.testing.assert_array_equal(_np(replay[1]["p"]), flats[2])
            assert peers[r].size() == 3 and peers[r].cluster_version == 1
            moms[r] = _np(zbs[r].chunks()[1][0]).copy()
            planes[r].close()
            planes[r] = pkg.persist.PersistPlane(
                root, r, cluster_version=1, period_s=0.0, keep=10)
        grads(3)
        state["flat"] = flats[3] = run_all(
            [lambda r=r: body(r, 3, 3) for r in range(3)], timeout=60)[0]
        grads(3)

        def last(r):
            try:
                body(r, 3, 4)
                return "no preemption"
            except pkg.chaos.InjectedDeath:
                planes[r].close()
                peers[r].close()
                return _np(snaps[r].last()[1]["p"])

        got = run_all([lambda r=r: last(r) for r in range(3)], timeout=60)
        assert all(isinstance(g, np.ndarray) for g in got), got
        flats[4] = got[0]
        out["mom4"] = np.concatenate(moms[:3])
        monkeypatch.delenv("KF_CHAOS_SPEC")
        pkg.chaos.reset()
        peers = pkg.peers(2)

        def restore(r):
            plane = pkg.persist.PersistPlane(root, r)
            s, v = pkg.persist.choose_manifest(root) if r == 0 else (-1, -1)
            s, v = plane.agree_manifest(peers[r].channel,
                                        peers[r].cluster.workers, r, s, v)
            plane.close()
            return pkg.persist.restore_from_manifest(
                pkg.persist.agreed_manifest_path(root, s, v), r, 2)

        sts = run_all([lambda r=r: restore(r) for r in range(2)], timeout=60)
        for st in sts:
            assert (st.step, st.meta["old_n"]) == (4, 3)
            np.testing.assert_array_equal(_np(st.replicated["p"]), flats[4])
        out["restored_mom"] = np.concatenate([_np(st.vec[0]) for st in sts])
        flat4 = _np(sts[0].replicated["p"]).copy()
        g4 = [grad(flat4, r) for r in range(2)]
        flats[5] = run_all([lambda r=r: _zero_step(
            pkg, peers[r], r, 2, flat4, g4[r], _np(sts[r].vec[0]).copy(),
            5)[0] for r in range(2)], timeout=60)[0]
        return flats, out
    finally:
        _close(peers)


def _repad(vec, total, n):
    chunk = math.ceil(total / n)
    pad = np.zeros(n * chunk, np.float32)
    pad[:total] = vec[:total]
    return [pad[r * chunk:(r + 1) * chunk].copy() for r in range(n)]


def _fixed(n, flat, mom, steps, grad):
    """A fixed world of ``n`` fresh port peers from ``flat`` and the
    momentum ``mom`` hand-repadded into ``n`` chunks, no commits."""
    moms = _repad(mom, flat.shape[0], n)
    peers = _port_peers(n)
    try:
        for k in steps:
            gs = [grad(flat, r) for r in range(n)]
            outs = run_all([lambda r=r: _zero_step(
                PORT, peers[r], r, n, flat, gs[r], moms[r], k)
                for r in range(n)], timeout=60)
            flat, moms = outs[0][0], [o[1] for o in outs]
        return flat
    finally:
        _close(peers)


class TestQuickGPTThroughFailure:
    def test_kill_shrink_replay_cold_restore(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        flat0, port_grad, ref_grad = _gpt()
        total = flat0.shape[0]
        flats, out = _e2e(PORT, port_grad, flat0, str(tmp_path / "port"),
                          monkeypatch)
        # the re-carve and the restore, against hand repads
        # steps 3-4 from (step-2 params, step-2 momentum repadded into
        # three chunks) on a fixed world: bitwise
        np.testing.assert_array_equal(
            _fixed(3, flats[2], out["mom2"], (3, 4), port_grad), flats[4])
        np.testing.assert_array_equal(
            out["restored_mom"],
            np.concatenate(_repad(out["mom4"], total, 2)))
        np.testing.assert_array_equal(
            _fixed(2, flats[4], out["mom4"], (5,), port_grad), flats[5])
        # the reference's run of the same scenario
        jflats, jout = _e2e(REF, ref_grad, flat0, str(tmp_path / "ref"),
                            monkeypatch)
        for k in range(1, 6):
            np.testing.assert_allclose(flats[k], jflats[k], atol=TRAIN_ATOL,
                                       err_msg=f"step {k}")
        np.testing.assert_allclose(out["mom4"], jout["mom4"],
                                   atol=TRAIN_ATOL)
