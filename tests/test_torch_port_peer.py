"""Port parity: the peer runtime.

``utils/envs.py``'s bootstrap parse, ``utils/stall.py``,
``utils/affinity.py``, ``store/`` and its p2p exchange, the new
``Communicator`` methods, ``initializer.py``'s host-plane broadcasts,
``elastic/resize.py``'s consensus fetch, ``peer.py`` and the ``python/``
entry points -- each held against the JAX package (``kungfu_tpu``) on the
same inputs, bitwise where the reference pins bytes.

Peers take ports found free: the port's through
``kungfu_tpu_torch.peer.start_local_cluster``, the reference's through
:func:`_ref_peers`, and either retries the whole cluster on
``EADDRINUSE``.  Channels run with ``KF_TPU_USE_UNIXSOCK=0``.  Every
thread join and receive is bounded.
"""

import errno
import logging
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kungfu_tpu.python as jkf
from kungfu_tpu import initializer as jinit
from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.elastic import resize as jresize
from kungfu_tpu.elastic import slices as jslices
from kungfu_tpu.elastic.configserver import ConfigServer as JConfigServer
from kungfu_tpu.peer import Peer as JPeer
from kungfu_tpu.store import store as jstore
from kungfu_tpu.utils import affinity as jaffinity
from kungfu_tpu.utils import envs as jenvs
from kungfu_tpu.utils import stall as jstall
import kungfu_tpu_torch as kf
from kungfu_tpu_torch import initializer
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.elastic import resize, slices
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.peer import Peer, start_local_cluster
from kungfu_tpu_torch.plan import Cluster, PeerList
from kungfu_tpu_torch.store import store
from kungfu_tpu_torch.utils import affinity, envs, stall
from tests._util import run_all


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for k in ("KF_CHAOS_SPEC", "KF_TPU_HOST_TRANSPORT", "KF_MONITOR_ADDR",
              "KF_CONFIG_ENABLE_MONITORING", "MEGASCALE_NUM_SLICES",
              "KF_SLICE_RANKS", "KF_CONFIG_ENABLE_CLUSTER_MONITOR",
              "KF_CONFIG_ENABLE_STALL_DETECTION", "KF_PERSIST_DIR",
              "KF_PERSIST_PERIOD", "KF_PERSIST_RESTORE",
              "KF_CONFIG_USE_AFFINITY"):
        monkeypatch.delenv(k, raising=False)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env_dict(r, ports, extra=None):
    """Worker ``r``'s bootstrap env on ``ports``, ``single_machine_env``'s
    shape."""
    return {**envs.single_machine_env(r, len(ports), ports=ports),
            **(extra or {})}


def _ref_peers(n, extra=None, attempts=5):
    """``n`` started reference peers on ports found free; the whole
    cluster retries on EADDRINUSE."""
    for _ in range(attempts):
        ports = _free_ports(n)
        peers = []
        try:
            for r in range(n):
                peers.append(JPeer(jenvs.parse_config_from_env(
                    _env_dict(r, ports, extra))))
                peers[-1].start()
            return peers
        except OSError as e:
            for p in peers:
                p.close()
            if getattr(e, "errno", None) not in (None, errno.EADDRINUSE):
                raise
    raise OSError("no free ports for a reference cluster")


def _mixed_pair(attempts=5):
    """A two-worker cluster of one reference peer (rank 0) and one port
    peer (rank 1)."""
    for _ in range(attempts):
        ports = _free_ports(2)
        ref = mine = None
        try:
            ref = JPeer(jenvs.parse_config_from_env(_env_dict(0, ports)))
            ref.start()
            mine = Peer(envs.parse_config_from_env(_env_dict(1, ports)),
                        devices=["cpu"])
            mine.start()
            return ref, mine
        except OSError:
            for p in (ref, mine):
                if p is not None:
                    p.close()
    raise OSError("no free ports for a mixed cluster")


def _close(peers):
    for p in peers:
        p.close()


# -- utils/envs.py -----------------------------------------------------------
_ENVS = {
    "single-process": {},
    "rank1-of-3": {**jenvs.single_machine_env(1, 3)},
    "no-runners": {"KF_SELF_SPEC": "10.0.0.2:10001",
                   "KF_INIT_PEERS": "10.0.0.1:10000,10.0.0.2:10001"},
    "everything": {
        **jenvs.single_machine_env(0, 2, host="10.1.2.3"),
        "KF_PARENT_ID": "10.1.2.3:38080",
        "KF_ALLREDUCE_STRATEGY": "RING",
        "KF_DEVICE_STRATEGY": "ring",
        "KF_CONFIG_SERVER": "http://10.1.2.3:9100/get",
        "KF_INIT_CLUSTER_VERSION": "7",
        "KF_JOB_START_TIMESTAMP": "1234.5",
        "KF_PROC_START_TIMESTAMP": "1240.25",
        "KF_COORDINATOR": "10.1.2.3:8476",
        "KF_NUM_PROCESSES": "2",
        "KF_PROCESS_ID": "1",
    },
    "world-peers": {
        **jenvs.single_machine_env(1, 2),
        "KF_WORLD_PEERS": "127.0.0.1:10000,127.0.0.1:10001,127.0.0.1:10002",
    },
    "device-strategy-only": {"KF_DEVICE_STRATEGY": "two_stage"},
}


def _fields(cfg):
    return {
        "self_id": str(cfg.self_id), "cluster": cfg.cluster.to_json(),
        "digest": cfg.cluster.digest(),
        "parent": None if cfg.parent is None else str(cfg.parent),
        "strategy": cfg.strategy.value,
        "device_strategy": cfg.device_strategy,
        "init_version": cfg.init_version,
        "config_server": cfg.config_server,
        "single_process": cfg.single_process,
        "coordinator": cfg.coordinator,
        "num_processes": cfg.num_processes, "process_id": cfg.process_id,
        "world_peers": (None if cfg.world_peers is None
                        else str(cfg.world_peers)),
        "detached": cfg.detached, "size": cfg.size,
    }


class TestEnvs:
    @pytest.mark.parametrize("key", sorted(_ENVS))
    def test_parse_config_matches_reference(self, key):
        env = _ENVS[key]
        got, want = envs.parse_config_from_env(env), \
            jenvs.parse_config_from_env(env)
        assert _fields(got) == _fields(want)
        if "KF_JOB_START_TIMESTAMP" in env:
            assert (got.job_start, got.proc_start) == \
                (want.job_start, want.proc_start)
        if not got.single_process:
            assert got.rank == want.rank

    @pytest.mark.parametrize("rank,size,host", [(0, 1, "127.0.0.1"),
                                                (2, 4, "127.0.0.1"),
                                                (1, 3, "10.0.0.9")])
    def test_single_machine_env(self, rank, size, host):
        assert envs.single_machine_env(rank, size, host) == \
            jenvs.single_machine_env(rank, size, host)

    def test_errors_match(self):
        bad = {**jenvs.single_machine_env(0, 2),
               "KF_WORLD_PEERS": "127.0.0.1:10005"}
        for parse in (envs.parse_config_from_env,
                      jenvs.parse_config_from_env):
            with pytest.raises(ValueError, match="not a slot"):
                parse(bad)
        with pytest.raises(ValueError):
            envs.single_machine_env(0, 2, ports=[1])

    @pytest.mark.parametrize("values", [
        {}, {"KF_PERSIST_DIR": "/x", "KF_PERSIST_PERIOD": "0",
             "KF_PERSIST_ASYNC_DEPTH": "5", "KF_PERSIST_KEEP": "1",
             "KF_PERSIST_RESTORE": "yes"},
        {"KF_PERSIST_PERIOD": "junk", "KF_PERSIST_RESTORE": "0"}])
    def test_persist_knobs(self, monkeypatch, values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        assert envs.persist_knobs() == jenvs.persist_knobs()

    @pytest.mark.parametrize("v", [None, "1", "true", "YES", "on", "0", "x"])
    def test_parse_bool(self, monkeypatch, v):
        if v is not None:
            monkeypatch.setenv("KF_CONFIG_ENABLE_STALL_DETECTION", v)
        name = "KF_CONFIG_ENABLE_STALL_DETECTION"
        assert envs.parse_bool_env(name) == jenvs.parse_bool_env(name)
        for name in ("SELF_SPEC", "INIT_PEERS", "INIT_RUNNERS", "PARENT_ID",
                     "INIT_CLUSTER_VERSION", "ALLREDUCE_STRATEGY",
                     "DEVICE_STRATEGY", "CONFIG_SERVER", "COORDINATOR",
                     "NUM_PROCESSES", "PROCESS_ID", "WORLD_PEERS",
                     "ENABLE_STALL_DETECTION", "PERSIST_DIR",
                     "PERSIST_RESTORE", "MEGASCALE_NUM_SLICES"):
            assert getattr(envs, name) == getattr(jenvs, name)


# -- utils/stall.py, utils/affinity.py ----------------------------------------
class TestStall:
    def _messages(self, mod, monkeypatch, **kw):
        got = []
        monkeypatch.setattr(mod._log, "warning",
                            lambda fmt, *a: got.append(fmt % a))
        with mod.stall_detector("op", **kw):
            time.sleep(0.35)
        return [m.split(" ")[1] for m in got]

    def test_stalls_and_recovers_as_reference(self, monkeypatch):
        a = self._messages(stall, monkeypatch, period=0.1, force=True)
        b = self._messages(jstall, monkeypatch, period=0.1, force=True)
        assert a[0] == b[0] == "stalled" and a[-1] == b[-1] == "recovered"
        assert 2 <= a.count("stalled") <= 4 and 2 <= b.count("stalled") <= 4

    def test_off_without_knob(self, monkeypatch):
        assert self._messages(stall, monkeypatch, period=0.05) == []
        monkeypatch.setenv("KF_CONFIG_ENABLE_STALL_DETECTION", "1")
        assert "stalled" in self._messages(stall, monkeypatch, period=0.05)

    def test_default_period(self):
        assert stall.DEFAULT_PERIOD_S == jstall.DEFAULT_PERIOD_S


class TestAffinity:
    @pytest.mark.parametrize("cpus,size", [(range(8), 4), (range(7), 3),
                                           (range(2), 5), (range(1, 13), 5)])
    def test_partition(self, cpus, size):
        for r in range(size):
            assert affinity.partition_cpus(list(cpus), r, size) == \
                jaffinity.partition_cpus(list(cpus), r, size)

    def test_off_by_default_and_bad_args(self):
        assert affinity.bind_local_rank(0, 1) is None
        for bad in ((0, 0), (3, 2)):
            with pytest.raises(ValueError):
                affinity.partition_cpus([0, 1], *bad)


# -- store/ ---------------------------------------------------------------------
class TestStore:
    def test_size_check(self):
        for mod in (store, jstore):
            s = mod.Store()
            s.save("w", b"1234")
            with pytest.raises(ValueError):
                s.save("w", b"12345")
            assert s.get("w") == b"1234" and s.get("missing") is None

    @pytest.mark.parametrize("window", [1, 3, 8])
    def test_versioned_window(self, window):
        got = []
        for mod in (store, jstore):
            vs = mod.VersionedStore(window=window)
            for v in range(10):
                vs.save("model", bytes([v] * 4), version=str(v))
                vs.save("other", bytes([v]), version=str(v % 4))
            got.append((vs.versions(), vs.get("model"), vs.get("model", "1"),
                        vs.get("other"), vs.get("model", "9")))
        assert got[0] == got[1]

    def test_copy_false_keeps_the_buffer(self):
        buf = bytearray(b"abcd")
        vs = store.VersionedStore()
        vs.save("b", buf, copy=False)
        buf[0] = ord("z")
        assert bytes(vs.get("b")) == b"zbcd"

    def test_local_store(self):
        store.reset_local_store()
        a = store.get_local_store()
        assert store.get_local_store() is a
        store.reset_local_store()
        assert store.get_local_store() is not a


class TestP2P:
    @pytest.mark.parametrize("transport", ["python", "native"])
    def test_request_between_port_peers(self, monkeypatch, transport):
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", transport)
        peers = start_local_cluster(2, devices=["cpu"])
        try:
            blob = np.arange(1000, dtype=np.float32)
            peers[0].save("model", blob.tobytes(), version="3")
            # kf. names are answered from the control store
            peers[0]._ctrl_store.save("kf.ctrl", b"control", version="1")
            peers[0].save("kf.ctrl", b"gossip", version="1")
            got = peers[1].request(0, "model", version="3", timeout=10)
            assert got == blob.tobytes()
            assert peers[1].request(0, "missing", timeout=10) is None
            assert peers[1].request(0, "kf.ctrl", timeout=10) == b"control"
            buf = np.empty(1000, np.float32)
            assert peers[1].request_into(0, "model", buf, timeout=10) is buf
            np.testing.assert_array_equal(buf, blob)
            small = np.empty(10, np.float32)
            assert peers[1].request_into(0, "model", small,
                                         timeout=10) == blob.tobytes()
            assert peers[1].request_into(0, "missing", small,
                                         timeout=10) is None
            # a self-request answers from the own store
            assert peers[0].request(0, "model", timeout=10) == blob.tobytes()
        finally:
            _close(peers)

    @pytest.mark.parametrize("direction", ["port-pulls-ref", "ref-pulls-port"])
    def test_request_across_packages(self, direction):
        ref, mine = _mixed_pair()
        try:
            blob = (np.arange(777, dtype=np.float32) * 3).tobytes()
            if direction == "port-pulls-ref":
                server, client, target = ref, mine, 0
            else:
                server, client, target = mine, ref, 1
            server.save("model", blob, version="5")
            assert client.request(target, "model", version="5",
                                  timeout=10) == blob
            assert client.request(target, "nope", timeout=10) is None
            buf = np.empty(777, np.float32)
            assert client.request_into(target, "model", buf,
                                       timeout=10) is buf
            assert buf.tobytes() == blob
        finally:
            _close([ref, mine])


# -- the device plane ---------------------------------------------------------
def _rows(n, same, seed=0):
    rng = np.random.default_rng(seed)
    row = rng.standard_normal((3, 5)).astype(np.float32)
    x = np.stack([row] * n)
    if not same:
        x[n - 1, 2, 4] += 1.0
    return x


class TestCommunicator:
    @pytest.mark.parametrize("same", [True, False])
    @pytest.mark.parametrize("n", [4, 8])
    def test_consensus(self, n, same):
        x = _rows(n, same)
        tc = Communicator(devices=["cpu"] * n)
        jc = JCommunicator(devices=jax.devices()[:n])
        assert tc.consensus(torch.from_numpy(x)) == jc.consensus(x) == same
        b = np.stack([np.ones(4, bool)] * n)
        assert tc.consensus({"b": torch.from_numpy(b), "x": torch.from_numpy(
            x)}) == jc.consensus({"b": b, "x": x}) == same

    @pytest.mark.parametrize("digests", [
        [b"abc"] * 4, [b"abc", b"abc", b"abd", b"abc"],
        [b"abc", b"abc\0", b"abc", b"abc"], [b""] * 4, [b"", b"", b"", b"x"]])
    def test_consensus_bytes(self, digests):
        tc = Communicator(devices=["cpu"] * 4)
        jc = JCommunicator(devices=jax.devices()[:4])
        assert tc.consensus_bytes(digests) == jc.consensus_bytes(digests)

    def test_consensus_bytes_errors(self):
        tc = Communicator(devices=["cpu"] * 4)
        jc = JCommunicator(devices=jax.devices()[:4])
        for c in (tc, jc):
            with pytest.raises(TypeError):
                c.consensus_bytes(b"abc")
            with pytest.raises(ValueError):
                c.consensus_bytes([b"a"] * 3)

    @pytest.mark.parametrize("root", [0, 3])
    def test_broadcast_value(self, root):
        v = np.random.default_rng(1).standard_normal((6, 7)).astype(
            np.float32)
        tc = Communicator(devices=["cpu"] * 4)
        jc = JCommunicator(devices=jax.devices()[:4])
        got = tc.broadcast_value(torch.from_numpy(v), root_slot=root)
        np.testing.assert_array_equal(got.numpy(), jc.broadcast_value(
            v, root_slot=root))
        for c in (tc, jc):
            with pytest.raises(ValueError):
                c.broadcast_value(v, root_slot=4)

    @pytest.mark.parametrize("n,local", [(8, 4), (8, 2), (4, 4)])
    def test_local_broadcast(self, n, local):
        x = np.random.default_rng(2).standard_normal((n, 3, 2)).astype(
            np.float32)
        tc = Communicator(devices=["cpu"] * n, local_size=local)
        jc = JCommunicator(devices=jax.devices()[:n], local_size=local)
        got = tc.local_broadcast({"a": torch.from_numpy(x)})["a"].numpy()
        want = np.asarray(jc.local_broadcast({"a": x})["a"])
        np.testing.assert_array_equal(got, want)

    def test_strategy_change_hook(self):
        seen = []
        tc = Communicator(devices=["cpu"] * 2, on_strategy_change=seen.append)
        tc.set_strategy("ring")
        assert seen == ["psum", "ring"]


# -- initializer.py --------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "h": rng.standard_normal(6).astype(np.float32)}


def _as_torch(tree, bf16=False):
    out = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    if bf16:
        out["h"] = out["h"].to(torch.bfloat16)
    return out


def _as_jax(tree, bf16=False):
    out = {k: jnp.asarray(v) for k, v in tree.items()}
    if bf16:
        out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t, np.float32) if t.dtype == jnp.bfloat16 \
        else np.asarray(t)


class TestInitializer:
    @pytest.mark.parametrize("root", [0, 2])
    def test_broadcast_parameters_matches_reference(self, root):
        port = start_local_cluster(3, devices=["cpu"])
        ref = _ref_peers(3)
        try:
            got = run_all([lambda p=p, r=r: initializer.broadcast_parameters(
                _as_torch(_tree(r), bf16=True), p, root=root)
                for r, p in enumerate(port)], timeout=60)
            want = run_all([lambda p=p, r=r: jinit.broadcast_parameters(
                _as_jax(_tree(r), bf16=True), p, root=root)
                for r, p in enumerate(ref)], timeout=60)
        finally:
            _close(port + ref)
        for g, w in zip(got, want):
            for k in g:
                assert g[k].dtype == (torch.bfloat16 if k == "h"
                                      else torch.float32)
                np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]))
            np.testing.assert_array_equal(g["w"].numpy(), _tree(root)["w"])

    def test_broadcast_without_a_cluster_returns_params(self):
        port = start_local_cluster(1, devices=["cpu"])
        try:
            t = _as_torch(_tree())
            assert initializer.broadcast_parameters(t, port[0]) is t
        finally:
            _close(port)

    def test_resync_parameters(self):
        port = start_local_cluster(2, devices=["cpu"])
        ref = _ref_peers(2)
        try:
            got = initializer.resync_parameters(_as_torch(_tree(5)), port[0])
            want = jinit.resync_parameters(_as_jax(_tree(5)), ref[0])
        finally:
            _close(port + ref)
        for k in got:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        comm = Communicator(devices=["cpu"])
        out = initializer.resync_parameters(_as_torch(_tree(1)), comm=comm)
        np.testing.assert_array_equal(out["b"].numpy(), _tree(1)["b"])


# -- elastic/resize.py, elastic/slices.py ----------------------------------------
class TestResizeProtocol:
    def test_fetch_with_consensus_two_peers(self):
        """Mirror of tests/test_elastic.py::TestResizeProtocol."""
        server = ConfigServer(port=0, host="127.0.0.1").start()
        try:
            peers = start_local_cluster(
                2, env={envs.CONFIG_SERVER: server.url}, devices=["cpu"])
            try:
                cluster = peers[0].cluster
                req = server.url.replace("/get", "/put")
                import urllib.request

                urllib.request.urlopen(urllib.request.Request(
                    req, data=cluster.to_json().encode(), method="PUT"),
                    timeout=10).read()
                res = run_all([lambda p=p: resize.fetch_cluster_with_consensus(
                    p, timeout=30) for p in peers], timeout=40)
                assert res[0] == res[1]
                assert res[0][1] == 1 and res[0][0] == cluster
            finally:
                _close(peers)
        finally:
            server.stop()

    def test_resize_through_the_config_server(self):
        hosts = "127.0.0.1"
        server = ConfigServer(port=0, host=hosts).start()
        try:
            peers = start_local_cluster(
                2, env={envs.CONFIG_SERVER: server.url}, devices=["cpu"])
            try:
                import urllib.request

                urllib.request.urlopen(urllib.request.Request(
                    server.url, data=peers[0].cluster.to_json().encode(),
                    method="PUT"), timeout=10).read()
                # shrink to one: rank 0 PUTs, both agree, rank 1 detaches
                out = run_all([lambda p=p: p.resize_cluster(1)
                               for p in peers], timeout=40)
                assert out == [True, True]
                assert peers[0].size() == 1 and not peers[0].detached
                assert peers[1].detached and peers[1].rank() == -1
                assert peers[0].cluster_version == 2
            finally:
                _close(peers)
        finally:
            server.stop()

    @pytest.mark.parametrize("slices_,rps,ask", [
        (None, None, 5), ("2", None, 5), ("2", None, 3), ("4", "2", 5),
        ("2", "3", 1)])
    def test_slice_aligned_size(self, monkeypatch, slices_, rps, ask):
        if slices_:
            monkeypatch.setenv("MEGASCALE_NUM_SLICES", slices_)
        if rps:
            monkeypatch.setenv("KF_SLICE_RANKS", rps)

        class Fake:
            def __init__(self, mod):
                self.mod = mod

            def slice_topology(self):
                boot = self.mod.bootstrap_topology(4)
                return None if boot is None else boot.for_size(
                    boot.size if rps else 4)

        assert resize.slice_aligned_size(Fake(slices), ask) == \
            jresize.slice_aligned_size(Fake(jslices), ask)

    def test_fetch_honours_config_down(self, monkeypatch):
        from kungfu_tpu_torch import chaos

        monkeypatch.setenv("KF_CHAOS_SPEC", "config_down:after=0,count=2")
        chaos.reset()
        server = ConfigServer(port=0, host="127.0.0.1",
                              cluster=Cluster.single_process()).start()
        try:
            ctl = chaos.controller_for(0)
            import urllib.error

            for _ in range(2):
                with pytest.raises(urllib.error.URLError):
                    resize.fetch_cluster(server.url, ctl)
            cluster, version = resize.fetch_cluster(server.url, ctl)
            assert version == 0 and cluster == Cluster.single_process()
        finally:
            server.stop()
            chaos.reset()


# -- peer.py and python/ ---------------------------------------------------------
class TestPeer:
    def test_identity_matches_reference(self):
        port = start_local_cluster(3, devices=["cpu"])
        ref = _ref_peers(3)
        try:
            for p, j in zip(port, ref):
                assert (p.rank(), p.size(), p.local_rank(), p.local_size(),
                        p.chaos_rank(), p.cluster_version, p.detached,
                        p.slice_topology()) == \
                    (j.rank(), j.size(), j.local_rank(), j.local_size(),
                     j.chaos_rank(), j.cluster_version, j.detached,
                     j.slice_topology())
                assert p.channel is not None and p.engine() is p.engine()
        finally:
            _close(port + ref)

    def test_barrier_consensus_and_engine(self):
        peers = start_local_cluster(3, devices=["cpu"])
        try:
            run_all([p.barrier for p in peers], timeout=30)
            assert run_all([lambda p=p: p.consensus_bytes(b"same")
                            for p in peers], timeout=30) == [True] * 3
            assert run_all([lambda p=p: p.consensus_bytes(
                bytes([p.rank()])) for p in peers], timeout=30) == [False] * 3
            outs = run_all([lambda p=p: p.engine().all_reduce(
                torch.full((5,), float(p.rank() + 1))) for p in peers],
                timeout=30)
            for o in outs:
                assert torch.equal(o, torch.full((5,), 6.0))
            p0 = peers[0]
            p0.world_barrier()  # no provisioned world: nothing to wait on
        finally:
            _close(peers)

    def test_communicator_per_version_with_rank0_strategy(self, monkeypatch):
        monkeypatch.setenv("KF_DEVICE_STRATEGY", "ring")
        peers = start_local_cluster(2, devices=["cpu"],
                                    env={"KF_DEVICE_STRATEGY": "ring"})
        try:
            c0 = peers[0].communicator()
            assert c0.device.type == "cpu" and c0.strategy == "ring"
            c0.set_strategy("two_stage")  # recorded on the peer
            assert peers[0]._comm_strategy == "two_stage"
            # a new cluster version rebuilds it, keeping the strategy;
            # rank 1 adopts rank 0's through the control store
            for p in peers:
                p.cluster_version += 1
            comms = run_all([p.communicator for p in peers], timeout=40)
            assert comms[0] is not c0 and comms[0].version == 1
            assert [c.strategy for c in comms] == ["two_stage"] * 2
        finally:
            _close(peers)

    def test_default_device_is_the_card(self):
        peers = start_local_cluster(1)
        try:
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    peers[0].communicator()
        finally:
            _close(peers)

    def test_resize_without_a_config_server(self):
        peers = start_local_cluster(2, devices=["cpu"])
        try:
            assert peers[0].resize_cluster(3)
            assert peers[0].size() == 3 and peers[0].cluster_version == 1
            with pytest.raises(RuntimeError):
                peers[0].resize_cluster_from_url()
            with pytest.raises(RuntimeError):
                peers[0].propose_new_size(2)
        finally:
            _close(peers)

    def test_start_local_cluster_retries_a_taken_port(self, monkeypatch):
        import kungfu_tpu_torch.peer as peer_mod

        real = peer_mod._free_ports
        taken = socket.socket()
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        calls = []

        def first_taken(n, host):
            calls.append(n)
            ports = real(n, host)
            if len(calls) == 1:
                ports[1] = taken.getsockname()[1]
            return ports

        monkeypatch.setattr(peer_mod, "_free_ports", first_taken)
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        try:
            peers = start_local_cluster(2, devices=["cpu"])
            assert len(calls) == 2 and all(p.channel for p in peers)
            _close(peers)
        finally:
            taken.close()


class TestPythonAPI:
    """``kf.init()`` is a process singleton: one peer a test."""

    def _both(self, env, devices=None):
        got = {}
        for name, mod, cfg in (
                ("port", kf, envs.parse_config_from_env(env)),
                ("ref", jkf, jenvs.parse_config_from_env(env))):
            if name == "port":
                mod.init(cfg, devices=devices or ["cpu"])
            else:
                mod.init(cfg)
            try:
                got[name] = (mod.current_rank(), mod.cluster_size(),
                             mod.current_local_rank(),
                             mod.current_local_size(), mod.detached(),
                             mod.uid())
                mod.run_barrier()
                got[name + "-resize"] = (mod.resize(2), mod.cluster_size(),
                                         mod.uid())
            finally:
                mod.finalize()
        return got

    def test_single_process(self):
        got = self._both({})
        assert got["port"] == got["ref"] == (0, 1, 0, 1, False, 0)
        assert got["port-resize"] == got["ref-resize"]

    def test_one_worker_with_a_channel(self):
        got = self._both(envs.single_machine_env(0, 1,
                                                 ports=_free_ports(1)))
        assert got["port"] == got["ref"]
        assert got["port-resize"] == got["ref-resize"]

    def test_communicator_and_singleton(self):
        p = kf.init(envs.parse_config_from_env({}), devices=["cpu"])
        try:
            assert kf.init() is p
            assert kf.current_communicator().size == 1
        finally:
            kf.finalize()


class TestNotPorted:
    """Knobs and methods whose modules are not ported raise, naming the
    ROADMAP item that brings them."""

    @pytest.mark.parametrize("extra", [
        {"KF_WORLD_PEERS": "127.0.0.1:10000,127.0.0.1:10001"},
        {"KF_COORDINATOR": "127.0.0.1:8476", "KF_NUM_PROCESSES": "2"}])
    def test_multi_process_worlds(self, extra):
        env = {**envs.single_machine_env(0, 2), **extra}
        with pytest.raises(NotImplementedError, match="multi-card"):
            Peer(envs.parse_config_from_env(env), devices=["cpu"])

    @pytest.mark.parametrize("knob", ["KF_CONFIG_ENABLE_MONITORING",
                                      "KF_CONFIG_ENABLE_CLUSTER_MONITOR"])
    def test_monitoring_knobs(self, monkeypatch, knob):
        """NetMonitor still waits for A9; the cluster monitor is ported
        (A3 took the aggregator): without a config server it starts no
        reporter, as the reference's does (the reporting cases are in
        test_torch_port_aggregator.py)."""
        monkeypatch.setenv(knob, "1")
        p = Peer(envs.parse_config_from_env({}), devices=["cpu"])
        if knob == "KF_CONFIG_ENABLE_MONITORING":
            with pytest.raises(NotImplementedError, match="A9"):
                p.start()
            return
        j = JPeer(jenvs.parse_config_from_env({}))
        p.start()
        j.start()
        try:
            assert p._reporter is None and j._reporter is None
        finally:
            p.close()
            j.close()

    @pytest.mark.parametrize("call", [
        lambda p: p.get_peer_latencies(), lambda p: p.get_egress_rates(),
        lambda p: p.check_interference(), lambda p: p.set_tree([0])])
    def test_adaptation_methods(self, call):
        """Ported since: on a single-process peer each answers as the
        reference's does (the cluster cases are in
        test_torch_port_adapt.py)."""
        p = Peer(envs.parse_config_from_env({}), devices=["cpu"])
        j = JPeer(jenvs.parse_config_from_env({}))
        assert call(p) == call(j)

    def test_stage_recovery(self):
        """Ported since (the cross-host pipeline): a stage boundary
        without a snapshot is refused before anything moves, as the
        reference's is, and the stage restore plan is the reference's
        (the live drills are in test_torch_port_pp.py)."""
        from kungfu_tpu.elastic import persist as jpersist
        from kungfu_tpu_torch.elastic import persist

        p = Peer(envs.parse_config_from_env({}), devices=["cpu"])
        j = JPeer(jenvs.parse_config_from_env({}))
        for peer in (p, j):
            with pytest.raises(ValueError, match="StepSnapshot"):
                peer.recover_from_failure(stage_boundary=object())
        for old_n, new_n in [(4, 2), (2, 1), (3, 4)]:
            assert persist.stage_restore_plan(12, old_n, new_n) == \
                jpersist.stage_restore_plan(12, old_n, new_n)

    def test_orbax_backend(self, monkeypatch, tmp_path):
        from kungfu_tpu_torch import checkpoint

        monkeypatch.setenv("KF_TPU_CKPT_BACKEND", "orbax")
        with pytest.raises(NotImplementedError, match="npz"):
            checkpoint.save_checkpoint(str(tmp_path), 0, {"a": torch.ones(1)})
        monkeypatch.setenv("KF_TPU_CKPT_BACKEND", "npz")
        (tmp_path / "ckpt_00000003.orbax").mkdir()
        with pytest.raises(NotImplementedError, match="orbax"):
            checkpoint.restore_checkpoint(str(tmp_path), {"a": torch.ones(1)})

    def test_hooks_are_inert(self):
        from kungfu_tpu_torch.monitor import aggregator, ledger

        assert ledger.record_decision("shrink", "world", 4, 3) is None
        p = Peer(envs.parse_config_from_env({}), devices=["cpu"])
        assert aggregator.post_control_if_enabled(p, "shrink") is False
