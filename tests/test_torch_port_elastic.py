"""Port parity: the elastic half of ZeRO and the host plane under it
(``kungfu_tpu_torch.{plan,comm.host,comm.faults,elastic,checkpoint}`` and
the re-carve functions of ``parallel/zero.py``) against the JAX package
on the conftest's virtual CPU devices.

Re-carving is data movement, so every state comparison here is bitwise:
a ZeRO state trained by the reference is carried into the port's ``[n,
chunk]`` rows with ``interop.tree_from_jax`` and re-carved in both
packages.  The cluster documents, their digests, the re-carve plans,
the host channel's frames and ``StepSnapshot``'s blobs are compared
byte for byte.  The mirrors of ``tests/test_reshard.py`` and
``tests/test_zero.py`` keep their names.  Every socket binds a port the
OS assigns (a reference channel retries on ``EADDRINUSE``), so the file
is safe under xdist.
"""

import errno
import json
import math
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu import checkpoint as jckpt
from kungfu_tpu import plan as jplan
from kungfu_tpu.comm import host as jhost
from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.elastic import configserver as jcfgsrv
from kungfu_tpu.elastic import reshard as jreshard
from kungfu_tpu.elastic import resize as jresize
from kungfu_tpu.elastic import schedule as jschedule
from kungfu_tpu.parallel import zero as jzero
from kungfu_tpu_torch import interop
from kungfu_tpu_torch import plan
from kungfu_tpu_torch.checkpoint import StepSnapshot
from kungfu_tpu_torch.comm import host
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.comm.faults import PeerFailureError
from kungfu_tpu_torch.elastic import (ConfigServer, ZeroBoundary,
                                      fetch_cluster, parse_schedule,
                                      place_stacked, recarve_after_shrink,
                                      step_based_schedule, total_steps)
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.optimizers import adam
from kungfu_tpu_torch.parallel import zero
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

from tests._util import run_all

LR = 1e-2


# -- the MLP of tests/test_reshard.py, in both packages ----------------------

def _np_params(sizes=((13, 7), (7,), (7, 5)), seed=0):
    rng = np.random.RandomState(seed)
    return {f"w{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(sizes)}


def _np_batch(n=16):
    rng = np.random.RandomState(1)
    return (rng.randn(n, 13).astype(np.float32),
            rng.randn(n, 5).astype(np.float32))


def _jloss(p, b):
    h = jnp.tanh(b[0] @ p["w0"] + p["w1"])
    return jnp.mean((h @ p["w2"] - b[1]) ** 2)


def _tloss(p, b):
    h = torch.tanh(b[0] @ p["w0"] + p["w1"])
    return ((h @ p["w2"] - b[1]) ** 2).mean()


def _tparams(np_params):
    return {k: torch.from_numpy(v.copy()) for k, v in np_params.items()}


def _tbatch():
    return tuple(torch.from_numpy(a) for a in _np_batch())


def _jcomm(n, version=0):
    return JCommunicator(devices=jax.devices()[:n], local_size=n,
                         version=version)


def _tcomm(n, version=0):
    return Communicator(devices=["cpu"] * n, local_size=n, version=version)


def _total(np_params):
    return sum(v.size for v in np_params.values())


def _jleaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [t.detach().numpy() for t in tree_leaves(tree)]


def _assert_rows_equal(port_tree, ref_tree):
    """The port's ``[n, chunk]`` rows and 0-d leaves bitwise equal to the
    reference's global ``[n*chunk]`` vectors and scalars."""
    got, want = _tleaves(port_tree), _jleaves(ref_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, f"leaf {i}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g.reshape(w.shape), w,
                                      err_msg=f"leaf {i}")


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, f"leaf {i}"
        assert torch.equal(x, y), f"leaf {i} differs"


def _hand_repad(opt, total, new_n):
    """The independent reference for the port: every ``[n, chunk]`` leaf
    unpadded to ``total`` and re-padded to ``[new_n, ceil(total/new_n)]``
    by plain slicing; 0-d leaves unchanged."""
    chunk = math.ceil(total / new_n)

    def leaf(t):
        if t.dim() != 2:
            return t
        buf = torch.zeros(chunk * new_n, dtype=t.dtype)
        buf[:total] = t.reshape(-1)[:total]
        return buf.view(new_n, chunk)

    return tree_map(leaf, opt)


_REF_STATES = {}


def _ref_state(n, steps=2, stage=2):
    """(reference ZeRO adam state on n devices after ``steps`` steps,
    params after them), cached per (n, steps, stage)."""
    key = (n, steps, stage)
    if key not in _REF_STATES:
        z = jzero.zero_train_step(_jloss, optax.adam(LR), _jcomm(n),
                                  stage=stage)
        params = jax.tree_util.tree_map(jnp.asarray, _np_params())
        batch = tuple(map(jnp.asarray, _np_batch()))
        o = z.init_opt(params)
        p = z.init_params(params)
        for _ in range(steps):
            p, o, _ = z.step(p, o, batch)
        _REF_STATES[key] = (z, o, p)
    return _REF_STATES[key]


def _carried(n, steps=2):
    """The reference's state after ``steps`` ZeRO-2 steps on n devices,
    carried into the port's layout; with the port's params after them."""
    _, o_j, p_j = _ref_state(n, steps)
    params = _tparams(_np_params())
    tz = zero.zero_train_step(_tloss, adam(LR), _tcomm(n), stage=2)
    o_t = interop.tree_from_jax(_jleaves(o_j), tz.init_opt(params))
    p_t = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p_j.items()}
    return o_t, p_t, o_j, p_j


def _train_port(n, steps=2, stage=2, params=None):
    params = _tparams(_np_params()) if params is None else params
    z = zero.zero_train_step(_tloss, adam(LR), _tcomm(n), stage=stage)
    o = z.init_opt(params)
    p = z.init_params(params)
    for _ in range(steps):
        p, o, _ = z.step(p, o, _tbatch())
    return z, p, o, params


# -- sockets ----------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_channel(retries=20):
    """A reference PyHostChannel on a port found free, retried on
    EADDRINUSE (the reference's channel takes no port 0)."""
    for _ in range(retries):
        pid = jplan.PeerID("127.0.0.1", _free_port())
        try:
            return jhost.PyHostChannel(pid, bind_host="127.0.0.1")
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
    raise RuntimeError("no free port for a reference channel")


@pytest.fixture
def no_unixsock(monkeypatch):
    """Reference channels without their /tmp Unix-socket listener."""
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")


class _FakePeer:
    """What the re-carve reads of a peer (as tests/test_reshard.py fakes
    it): its channel and id, and for the snapshot/p2p paths its rank,
    membership and cluster version."""

    def __init__(self, chan, workers=None, version=0):
        self.channel = chan
        self.config = type("C", (), {"self_id": chan.self_id})()
        self.cluster = type("Cl", (), {"workers": workers})()
        self.cluster_version = version

    def rank(self):
        return self.cluster.workers.rank(self.channel.self_id)


def _mk_world(n):
    chans = [host.PyHostChannel(plan.PeerID("127.0.0.1", 0),
                                bind_host="127.0.0.1") for _ in range(n)]
    peers = plan.PeerList.of(*(c.self_id for c in chans))
    return peers, chans, [_FakePeer(c, peers) for c in chans]


def _close(chans):
    for c in chans:
        c.close()


# ==========================================================================
# plan: peers, peer lists, host lists, the cluster document
# ==========================================================================

class TestPlan:
    @pytest.mark.parametrize("spec", ["10.0.0.1:10000", " h:1 ", "a:65535"])
    def test_parse_peer_id(self, spec):
        got, want = plan.parse_peer_id(spec), jplan.parse_peer_id(spec)
        assert (got.host, got.port, str(got)) == (want.host, want.port,
                                                  str(want))
        assert got.sock_file() == want.sock_file()
        assert got.named_addr("x") == want.named_addr("x")

    @pytest.mark.parametrize("spec", ["nocolon", "a:b", ":1"])
    def test_parse_peer_id_bad(self, spec):
        with pytest.raises(ValueError):
            jplan.parse_peer_id(spec)
        with pytest.raises(ValueError):
            plan.parse_peer_id(spec)

    def test_peerlist_queries(self):
        spec = "a:10000,a:10001,b:10000,b:10001"
        got, want = plan.PeerList.parse(spec), jplan.PeerList.parse(spec)
        assert str(got) == str(want) == spec
        assert len(got) == 4
        for p in want:
            q = plan.PeerID(p.host, p.port)
            assert q in got
            assert got.rank(q) == want.rank(p)
            assert got.local_rank(q) == want.local_rank(p)
            assert got.local_size(q) == want.local_size(p)
        assert got.rank(plan.PeerID("c", 1)) is None
        assert got.hosts() == want.hosts()
        assert got.partition_by_host() == want.partition_by_host()
        assert got.local_masters() == want.local_masters()
        assert str(got.on_host("b")) == str(want.on_host("b"))
        assert str(got.select([3, 0])) == str(want.select([3, 0]))
        assert str(plan.PeerList.of(got[1], got[2])) == "a:10001,b:10000"

    def test_peerlist_diff(self):
        a = plan.PeerList.parse("h:10000,h:10001")
        b = plan.PeerList.parse("h:10001,h:10002")
        added, removed = a.diff(b)
        assert added == [plan.PeerID("h", 10002)]
        assert removed == [plan.PeerID("h", 10000)]

    @pytest.mark.parametrize("spec", ["1.2.3.4", "1.2.3.4:8",
                                      "1.2.3.4:8:pub"])
    def test_hostspec(self, spec):
        got, want = plan.HostSpec.parse(spec), jplan.HostSpec.parse(spec)
        assert (got.ip, got.slots, got.public_addr, str(got)) == (
            want.ip, want.slots, want.public_addr, str(want))

    def test_host_list(self):
        got, want = plan.parse_host_list("a:2,b:2"), jplan.parse_host_list(
            "a:2,b:2")
        assert got.cap() == want.cap() == 4
        assert str(got.gen_peer_list(3)) == str(want.gen_peer_list(3))
        assert str(got.gen_runner_list()) == str(want.gen_runner_list())
        assert str(got) == str(want)
        assert got.lookup("b").slots == 2
        with pytest.raises(ValueError):
            plan.parse_host_list("a:1").gen_peer_list(2)
        with pytest.raises(ValueError):
            plan.parse_host_list("a:1,a:2")

    @staticmethod
    def _clusters(spec, np_):
        hl, jhl = plan.HostList.parse(spec), jplan.HostList.parse(spec)
        return (plan.Cluster(hl.gen_runner_list(), hl.gen_peer_list(np_)),
                jplan.Cluster(jhl.gen_runner_list(), jhl.gen_peer_list(np_)))

    @pytest.mark.parametrize("spec,np_", [("a:4,b:4", 4), ("127.0.0.1:8", 2),
                                          ("a:1", 1), ("a:3,b:2,c:1", 6)])
    def test_cluster_json_and_digest_bytes(self, spec, np_):
        got, want = self._clusters(spec, np_)
        assert got.to_json() == want.to_json()
        assert got.digest() == want.digest()
        assert len(got.digest()) == 16
        back = plan.Cluster.from_json(want.to_json())
        assert back == got and back.digest() == want.digest()
        assert got.size() == want.size() == np_

    @pytest.mark.parametrize("spec,np_,new", [
        ("a:4,b:4", 4, 2), ("a:4,b:4", 2, 4), ("a:1", 1, 3),
        ("a:2,b:2", 4, 0), ("a:4,b:4", 4, 4), ("a:1,b:1,c:1", 1, 5)])
    def test_resize_matches_reference(self, spec, np_, new):
        got, want = self._clusters(spec, np_)
        g, w = got.resize(new), want.resize(new)
        assert g.to_json() == w.to_json()
        assert g.digest() == w.digest()
        assert (got.digest() == g.digest()) == (want.digest() == w.digest())

    def test_resize_negative_and_validate(self):
        got, _ = self._clusters("a:4,b:4", 4)
        with pytest.raises(ValueError):
            got.resize(-1)
        orphan = json.dumps({"runners": ["a:38080"], "workers": ["b:10000"]})
        with pytest.raises(ValueError):
            jplan.Cluster.from_json(orphan)
        with pytest.raises(ValueError):
            plan.Cluster.from_json(orphan)
        dup = json.dumps({"runners": ["a:38080"],
                          "workers": ["a:10000", "a:10000"]})
        with pytest.raises(ValueError, match="duplicate"):
            plan.Cluster.from_json(dup)

    def test_single_process(self):
        assert (plan.Cluster.single_process().to_json()
                == jplan.Cluster.single_process().to_json())


# ==========================================================================
# elastic/schedule.py
# ==========================================================================

class TestSchedule:
    @pytest.mark.parametrize("config", ["1:100,2:50", "4:3,2:3,4:2",
                                        " 2:1 , 8:4 ,", "3:7"])
    def test_parse_and_total(self, config):
        assert parse_schedule(config) == jschedule.parse_schedule(config)
        assert total_steps(config) == jschedule.total_steps(config)

    @pytest.mark.parametrize("step", [0, 2, 3, 5, 6, 7, 8, 500])
    def test_lookup(self, step):
        config = "4:3,2:3,4:2"
        assert (step_based_schedule(config, step)
                == jschedule.step_based_schedule(config, step))

    @pytest.mark.parametrize("config", ["0:10", "", "2:0", "2:-1"])
    def test_bad(self, config):
        with pytest.raises(ValueError):
            jschedule.parse_schedule(config)
        with pytest.raises(ValueError):
            parse_schedule(config)


# ==========================================================================
# elastic/configserver.py and resize.fetch_cluster
# ==========================================================================

def _cluster(np_=2):
    hl = plan.HostList.parse("127.0.0.1:8")
    return plan.Cluster(hl.gen_runner_list(), hl.gen_peer_list(np_))


def _http(port, path="/get", method="GET", body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body.encode() if body else None,
                                 method=method)
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.read()


class TestConfigServer:
    @pytest.fixture
    def servers(self):
        """The port's and the reference's server, each on a port the OS
        assigned, holding the same two-worker cluster."""
        c = _cluster(2)
        ours = ConfigServer(port=0, cluster=c).start()
        ref = jcfgsrv.ConfigServer(
            port=0, cluster=jplan.Cluster.from_json(c.to_json())).start()
        yield ours, ref
        ours.stop()
        ref.stop()

    def test_port_zero_reports_bound_port(self, servers):
        ours, _ = servers
        assert ours.port > 0
        assert ours.url == f"http://127.0.0.1:{ours.port}/get"
        assert json.loads(_http(ours.port))["version"] == 0

    def test_get_put_documents_match_reference(self, servers):
        ours, ref = servers
        assert _http(ours.port) == _http(ref.port)
        new = _cluster(4).to_json()
        a = _http(ours.port, "/put", "PUT", new)
        b = _http(ref.port, "/put", "PUT", new)
        assert a == b and json.loads(a) == {"version": 1}
        doc = json.loads(_http(ours.port))
        assert doc["version"] == 1 and len(doc["cluster"]["workers"]) == 4
        assert _http(ours.port) == _http(ref.port)
        assert ours.snapshot()[0] == 1

    def test_put_invalid_rejected(self, servers):
        ours, _ = servers
        bad = json.dumps({"runners": ["a:38080"], "workers": ["b:10000"]})
        with pytest.raises(urllib.error.HTTPError) as e:
            _http(ours.port, "/put", "PUT", bad)
        assert e.value.code == 400
        assert json.loads(_http(ours.port))["version"] == 0

    def test_reset_delete_and_monitor_routes(self, servers):
        ours, ref = servers
        for port in (ours.port, ref.port):
            _http(port, "/put", "PUT", _cluster(3).to_json())
            out = _http(port, "/reset", "POST", _cluster(1).to_json())
            assert json.loads(out) == {"version": 0}
            for route in ("/cluster", "/metrics", "/alerts"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _http(port, route)
                assert e.value.code == 404
            _http(port, "/", "DELETE")
            with pytest.raises(urllib.error.HTTPError) as e:
                _http(port)
            assert e.value.code == 404

    def test_fetch_cluster_matches_reference(self, servers):
        ours, ref = servers
        _http(ours.port, "/put", "PUT", _cluster(4).to_json())
        got, v = fetch_cluster(ours.url)
        want, jv = jresize.fetch_cluster(ours.url)
        assert v == jv == 1
        assert got.to_json() == want.to_json()
        assert got.digest() == want.digest()
        # and the port reads the reference's server alike
        got2, v2 = fetch_cluster(ref.url)
        assert (got2.to_json(), v2) == (_cluster(2).to_json(), 0)

    def test_stop_route(self):
        srv = ConfigServer(port=0, cluster=_cluster(1)).start()
        assert json.loads(_http(srv.port, "/stop")) == {}
        srv._thread.join(5)
        assert not srv._thread.is_alive()


# ==========================================================================
# comm/host.py: the Python host channel and its wire
# ==========================================================================

class TestHostChannel:
    @pytest.fixture
    def world(self):
        peers, chans, _ = _mk_world(3)
        yield peers, chans
        _close(chans)

    def test_port_zero_binds_os_port(self, world):
        peers, chans = world
        assert all(p.port > 0 for p in peers)
        assert len({p.port for p in peers}) == 3

    def test_send_recv(self, world):
        peers, (a, b, _) = world
        a.send(peers[1], "hello", b"payload")
        assert b.recv(peers[0], "hello") == b"payload"

    def test_ping(self, world):
        peers, (a, _, _) = world
        assert a.ping(peers[1]) and a.ping(peers[2])
        assert not a.ping(plan.PeerID("127.0.0.1", _free_port()),
                          timeout=0.3)

    def test_recv_timeout(self, world):
        peers, (_, b, _) = world
        with pytest.raises(TimeoutError):
            b.recv(peers[0], "never", timeout=0.2)

    def test_token_fencing(self, world):
        peers, (a, b, _) = world
        b.set_token(5)
        a.send(peers[1], "stale", b"x")
        with pytest.raises(TimeoutError):
            b.recv(peers[0], "stale", timeout=0.5)
        got = []
        b.on_control(lambda name, payload, src: got.append((name, payload)))
        a.send(peers[1], "update", b"cfg", host.ConnType.CONTROL)
        for _ in range(50):
            if got:
                break
            time.sleep(0.05)
        assert got == [("update", b"cfg")]

    def test_recv_into(self, world):
        peers, (a, b, _) = world
        payload = np.arange(1024, dtype=np.float32)
        a.send(peers[1], "ri", payload)  # a buffer, sent without a copy
        buf = torch.empty(1024)
        assert b.recv_into(peers[0], "ri", host.tensor_buffer(buf))
        np.testing.assert_array_equal(buf.numpy(), payload)
        a.send(peers[1], "ri2", payload.tobytes())
        small = torch.empty(10)
        assert not b.recv_into(peers[0], "ri2", host.tensor_buffer(small))
        np.testing.assert_array_equal(
            np.frombuffer(b.recv(peers[0], "ri2"), np.float32), payload)

    def test_bf16_buffer(self, world):
        peers, (a, b, _) = world
        x = torch.randn(33, generator=torch.Generator().manual_seed(0)).to(
            torch.bfloat16)
        a.send(peers[1], "bf", host.tensor_buffer(x))
        y = torch.empty(33, dtype=torch.bfloat16)
        assert b.recv_into(peers[0], "bf", host.tensor_buffer(y))
        assert torch.equal(x, y)
        with pytest.raises(ValueError, match="contiguous"):
            host.tensor_buffer(torch.zeros(4, 4).t())

    def test_large_payload(self, world):
        peers, (a, b, _) = world
        x = torch.arange(3 << 20, dtype=torch.float32)  # 12 MiB
        a.send(peers[1], "big", host.tensor_buffer(x))
        y = torch.empty_like(x)
        assert b.recv_into(peers[0], "big", host.tensor_buffer(y))
        assert torch.equal(x, y)

    def test_gather_broadcast(self, world):
        peers, chans = world
        outs = run_all([lambda i=i, c=c: c.gather_bytes(
            bytes([i]) * 3, peers, "g") for i, c in enumerate(chans)])
        assert outs[0] == [b"\x00" * 3, b"\x01" * 3, b"\x02" * 3]
        assert outs[1:] == [None, None]
        outs = run_all([lambda i=i, c=c: c.broadcast_bytes(
            b"root" if i == 0 else None, peers, "b")
            for i, c in enumerate(chans)])
        assert outs == [b"root"] * 3
        with pytest.raises(ValueError):
            chans[0].broadcast_bytes(None, peers, "b2")

    def test_barrier_allgather_consensus(self, world):
        peers, chans = world
        run_all([lambda c=c: c.barrier(peers) for c in chans])
        outs = run_all([lambda i=i, c=c: c.allgather_bytes(
            f"blob{i}".encode(), peers, "ag") for i, c in enumerate(chans)])
        assert outs == [[b"blob0", b"blob1", b"blob2"]] * 3
        outs = run_all([lambda c=c: c.consensus_bytes(b"same", peers, "c1")
                        for c in chans])
        assert outs == [True] * 3
        outs = run_all([lambda i=i, c=c: c.consensus_bytes(
            b"same" if i < 2 else b"diff", peers, "c2")
            for i, c in enumerate(chans)])
        assert outs == [False] * 3

    def test_concurrent_senders_stress(self, world):
        """Sixteen threads (more than cores) share one channel's pooled
        connections and the receiver's queues under a short switch
        interval: every frame arrives whole, under its own name."""
        import sys

        peers, (a, b, c) = world
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def sender(t):
                for i in range(20):
                    dst = peers[1] if (t + i) % 2 else peers[2]
                    a.send(dst, f"s.{t}.{i}", bytes([t, i]) * (1 + 97 * i))
                return True

            assert all(run_all([lambda t=t: sender(t) for t in range(16)],
                               timeout=60))
            for t in range(16):
                for i in range(20):
                    rx = b if (t + i) % 2 else c
                    got = rx.recv(peers[0], f"s.{t}.{i}", timeout=10)
                    assert got == bytes([t, i]) * (1 + 97 * i)
        finally:
            sys.setswitchinterval(old)

    def test_wire_matches_reference(self):
        for args in [(0, 3, b"127.0.0.1:1", b"n", 0),
                     (7, 1, b"h:65535", b"kf.zrc.t.l1.o0", 1 << 30)]:
            assert (host.HeaderCodec.pack_head(*args)
                    == jhost.HeaderCodec.pack_head(*args))
        items = [b"", b"a", bytes(range(200))]
        assert host._pack_list(items) == jhost._pack_list(items)
        assert host._unpack_list(jhost._pack_list(items)) == items
        assert host.MAGIC == jhost.MAGIC and host.MAX_FRAME == jhost.MAX_FRAME

    def test_messages_cross_to_and_from_reference(self, no_unixsock):
        """A port channel and a reference channel exchange a message
        each way (and a ping), so the two speak one wire."""
        ref = _ref_channel()
        ours = host.PyHostChannel(plan.PeerID("127.0.0.1", 0),
                                  bind_host="127.0.0.1")
        try:
            ref_as_port = plan.PeerID(ref.self_id.host, ref.self_id.port)
            ours_as_ref = jplan.PeerID(ours.self_id.host, ours.self_id.port)
            payload = np.arange(4097, dtype=np.float32)
            ours.send(ref_as_port, "to.ref", payload)
            got = ref.recv(ours_as_ref, "to.ref", timeout=10)
            np.testing.assert_array_equal(np.frombuffer(got, np.float32),
                                          payload)
            ref.send(ours_as_ref, "to.port", payload.tobytes()[::-1])
            assert ours.recv(ref_as_port, "to.port",
                             timeout=10) == payload.tobytes()[::-1]
            assert ours.ping(ref_as_port) and ref.ping(ours_as_ref)
        finally:
            ours.close()
            ref.close()

    def test_factory(self, monkeypatch):
        monkeypatch.delenv("KF_TPU_HOST_TRANSPORT", raising=False)
        ch = host.HostChannel(plan.PeerID("127.0.0.1", 0),
                              bind_host="127.0.0.1")
        try:
            assert isinstance(ch, host.PyHostChannel)
        finally:
            ch.close()
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        ch = host.HostChannel(plan.PeerID("127.0.0.1", 0),
                              bind_host="127.0.0.1")
        ch.close()
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "native")
        with pytest.raises(NotImplementedError, match="native"):
            host.HostChannel(plan.PeerID("127.0.0.1", 0))

    def test_close_ends_stream_threads(self):
        peers, chans, _ = _mk_world(2)
        chans[0].send(peers[1], "x", b"1")
        assert chans[1].recv(peers[0], "x") == b"1"
        before = threading.active_count()
        _close(chans)
        deadline = time.monotonic() + 5
        while threading.active_count() >= before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert threading.active_count() < before


# ==========================================================================
# checkpoint.StepSnapshot: the replay point and its wire form
# ==========================================================================

def _snap_tree_np():
    rng = np.random.default_rng(0)
    return {"b": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "a": rng.standard_normal(5).astype(np.float32),
            "count": np.array(7, np.int32),
            "h": rng.standard_normal(6).astype(np.float32)}


def _port_tree(tree_np, bf16_key="h"):
    out = tree_map(lambda a: torch.from_numpy(np.array(a)), tree_np)
    out[bf16_key] = out[bf16_key].to(torch.bfloat16)
    return out


def _ref_tree(tree_np, bf16_key="h"):
    out = jax.tree_util.tree_map(jnp.asarray, tree_np)
    out[bf16_key] = out[bf16_key].astype(jnp.bfloat16)
    return out


class TestStepSnapshot:
    def test_commit_and_last_copy(self):
        t = {"w": torch.arange(4.0), "c": torch.tensor(3)}
        s = StepSnapshot()
        assert s.last() is None and s.serialize() == b""
        s.commit(5, t, meta={"k": 1})
        t["w"].add_(100)  # the next step overwrites the live buffers
        step, got, meta = s.last()
        assert step == 5 and meta == {"k": 1} and s.step() == 5
        assert torch.equal(got["w"], torch.arange(4.0))
        got["w"].zero_()  # a caller mutating the restored tree
        assert torch.equal(s.last()[1]["w"], torch.arange(4.0))
        s.clear()
        assert s.last() is None

    def test_blob_bytes_match_reference(self):
        tree = _snap_tree_np()
        ours, ref = StepSnapshot(), jckpt.StepSnapshot()
        ours.commit(11, _port_tree(tree), meta={"v": 2})
        ref.commit(11, _ref_tree(tree), meta={"v": 2})
        assert ours.serialize() == ref.serialize()

    def test_port_blob_adopts_in_reference(self):
        tree = _snap_tree_np()
        ours = StepSnapshot()
        ours.commit(3, _port_tree(tree))
        ref = jckpt.StepSnapshot()
        ref.commit(0, jax.tree_util.tree_map(jnp.zeros_like,
                                             _ref_tree(tree)))
        step, got, _ = ref.adopt(ours.serialize())
        assert step == 3
        want = _ref_tree(tree)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            # the reference reads a 0-d leaf back 1-d (its wire form)
            g, w = np.ravel(g), np.ravel(np.asarray(w))
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))

    def test_reference_blob_adopts_in_port(self):
        tree = _snap_tree_np()
        ref = jckpt.StepSnapshot()
        ref.commit(9, _ref_tree(tree), meta={"m": "x"})
        ours = StepSnapshot()
        ours.commit(0, tree_map(torch.zeros_like, _port_tree(tree)))
        step, got, meta = ours.adopt(ref.serialize())
        assert (step, meta) == (9, {"m": "x"})
        _assert_trees_equal(got, _port_tree(tree))
        assert got["h"].dtype == torch.bfloat16

    def test_adopt_guards(self):
        blob = StepSnapshot()
        blob.commit(1, {"a": torch.zeros(2)})
        with pytest.raises(ValueError, match="committed"):
            StepSnapshot().adopt(blob.serialize())
        other = StepSnapshot()
        other.commit(0, {"a": torch.zeros(2), "b": torch.zeros(1)})
        with pytest.raises(ValueError, match="leaves"):
            other.adopt(blob.serialize())
        assert other.adopt(b"") is None


# ==========================================================================
# parallel/zero.py: reshard_plan and the three re-carve paths
# ==========================================================================

PLAN_GRID = [(10, 4, 1), (10, 1, 4), (7, 3, 5), (100, 4, 2), (5, 8, 3),
             (16, 4, 4), (1, 1, 1), (3, 8, 8), (15, 8, 5), (133, 4, 2),
             (133, 2, 4), (1000, 3, 7), (1001, 7, 3), (134404608, 4, 2),
             (134404608, 2, 4), (17, 16, 1)]


class TestReshardPlan:
    @pytest.mark.parametrize("total,old_n,new_n", PLAN_GRID)
    def test_segments_match_reference(self, total, old_n, new_n):
        assert (zero.reshard_plan(total, old_n, new_n)
                == jzero.reshard_plan(total, old_n, new_n))

    @pytest.mark.parametrize("total,old_n,new_n", PLAN_GRID[:12])
    def test_plan_partitions_exactly(self, total, old_n, new_n):
        p = zero.reshard_plan(total, old_n, new_n)
        oc, nc = -(-total // old_n), -(-total // new_n)
        cover = np.zeros(total, bool)
        for (o, r, s, ln) in p:
            assert ln > 0 and not cover[s:s + ln].any()
            cover[s:s + ln] = True
            assert o * oc <= s and s + ln <= min((o + 1) * oc, total)
            assert r * nc <= s and s + ln <= min((r + 1) * nc, total)
        assert cover.all()

    def test_identity_and_invalid(self):
        assert all(o == r for (o, r, _, _) in zero.reshard_plan(64, 4, 4))
        for bad in ((10, 0, 2), (10, 2, 0)):
            with pytest.raises(ValueError):
                zero.reshard_plan(*bad)


RESIZES = [(4, 2), (2, 4), (8, 3), (4, 1)]


class TestZeroReshardParity:
    """The reference's ZeRO-2 state after two steps, carried into the
    port: every re-carve path of both packages gives the same bits."""

    @pytest.mark.parametrize("old_n,new_n", RESIZES)
    def test_zero1_reshard_matches_reference(self, old_n, new_n):
        o_t, p_t, o_j, p_j = _carried(old_n)
        got = zero.zero1_reshard(o_t, p_t, _tcomm(new_n))
        _assert_rows_equal(got, jzero.zero1_reshard(o_j, p_j, _jcomm(new_n)))
        _assert_trees_equal(got, _hand_repad(o_t, _total(_np_params()),
                                             new_n))

    @pytest.mark.parametrize("old_n,new_n", RESIZES)
    def test_four_paths_agree(self, old_n, new_n):
        """zero1_reshard, snapshot -> restore, p2p (single controller)
        and ZeroBoundary's full mode: one result, bitwise."""
        o_t, p_t, o_j, p_j = _carried(old_n)
        c = _tcomm(new_n)
        want = zero.zero1_reshard(o_t, p_t, c)
        fresh = zero.zero_train_step(_tloss, adam(LR), c).init_opt(p_t)
        restored = zero.zero_restore(zero.zero_snapshot(o_t), fresh, p_t,
                                     new_comm=c)
        p2p = zero.zero_reshard_p2p(o_t, p_t, c)
        b = ZeroBoundary()
        b.commit(2, o_t, p_t)
        b.recarve(new_n)
        for got in (restored, p2p, b.place(c)):
            _assert_trees_equal(got, want)
        _assert_rows_equal(p2p, jzero.zero_reshard_p2p(o_j, p_j,
                                                       _jcomm(new_n)))

    def test_snapshot_blob_matches_reference(self):
        import io

        o_t, _, o_j, _ = _carried(4)
        with np.load(io.BytesIO(zero.zero1_snapshot(o_t))) as a, \
                np.load(io.BytesIO(jzero.zero1_snapshot(o_j))) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype

    def test_reference_blob_restores_in_port(self):
        o_t, p_t, o_j, p_j = _carried(4)
        c2 = _tcomm(2)
        fresh = zero.zero_train_step(_tloss, adam(LR), c2).init_opt(p_t)
        got = zero.zero1_restore(jzero.zero1_snapshot(o_j), fresh, p_t,
                                 new_comm=c2)
        _assert_trees_equal(got, zero.zero1_reshard(o_t, p_t, c2))

    def test_restore_detects_missing_chunks(self):
        import io

        o_t, p_t, _, _ = _carried(4)
        with np.load(io.BytesIO(zero.zero1_snapshot(o_t))) as z:
            kept = {k: z[k] for k in z.files if not k.endswith("_o0")}
        bio = io.BytesIO()
        np.savez(bio, **kept)
        fresh = zero.zero_train_step(_tloss, adam(LR), _tcomm(4)).init_opt(p_t)
        with pytest.raises(ValueError, match="missing"):
            zero.zero1_restore(bio.getvalue(), fresh, p_t, new_comm=_tcomm(4))

    def test_reshard_with_snapshot_routes_to_host_plane(self):
        """zero1_reshard(snapshot=...) rebuilds through zero1_restore,
        structure from the state, values from the blob
        (tests/test_zero.py:211, :257)."""
        o_t, p_t, _, _ = _carried(4)
        blob = zero.zero1_snapshot(o_t)
        _assert_trees_equal(zero.zero1_reshard(o_t, p_t, _tcomm(4),
                                               snapshot=blob), o_t)
        fresh = zero.zero_train_step(_tloss, adam(LR), _tcomm(2)).init_opt(p_t)
        _assert_trees_equal(zero.zero1_reshard(fresh, p_t, _tcomm(2),
                                               snapshot=blob),
                            zero.zero1_reshard(o_t, p_t, _tcomm(2)))

    def test_wrong_param_tree_raises(self):
        o_t, p_t, _, _ = _carried(4)
        smaller = {"w0": p_t["w0"]}
        with pytest.raises(ValueError, match="SAME param tree"):
            zero.zero1_reshard(o_t, smaller, _tcomm(2))
        with pytest.raises(ValueError, match="SAME param tree"):
            ZeroBoundary().commit(0, o_t, smaller)


class TestReshardEdgeCases:
    """tests/test_zero.py:530: the padded total shrinking below an old
    rank's shard offset, 1-rank worlds, and old worlds larger than the
    parameter count."""

    def test_padded_total_shrinks_below_old_shard(self):
        np_p = {"w": np.random.RandomState(3).randn(3, 5).astype(np.float32)}
        params = _tparams(np_p)
        z = zero.zero_train_step(lambda p, b: (p["w"] ** 2).sum(), adam(LR),
                                 _tcomm(8))
        o = z.init_opt(params)
        o = tree_map(lambda t: t + 1 if t.dim() == 2 else t, o)
        o5 = zero.zero1_reshard(o, params, _tcomm(5))
        for a, b in zip(tree_leaves(o), tree_leaves(o5)):
            if a.dim():
                assert b.shape == (5, 3)
                assert torch.equal(a.reshape(-1)[:15], b.reshape(-1))
        fresh = zero.zero_train_step(lambda p, b: 0, adam(LR),
                                     _tcomm(5)).init_opt(params)
        got = zero.zero1_restore(zero.zero1_snapshot(o), fresh, params,
                                 new_comm=_tcomm(5))
        _assert_trees_equal(got, o5)

    def test_one_rank_world_roundtrip(self):
        o_t, p_t, _, _ = _carried(8)
        o1 = zero.zero1_reshard(o_t, p_t, _tcomm(1))
        total = _total(_np_params())
        for l in tree_leaves(o1):
            if l.dim():
                assert l.shape == (1, total)  # no padding at n = 1
        _assert_trees_equal(zero.zero1_reshard(o1, p_t, _tcomm(8)), o_t)

    def test_old_world_larger_than_param_count(self):
        params = {"w": torch.from_numpy(
            np.random.RandomState(5).randn(5).astype(np.float32))}
        o = zero.zero_train_step(lambda p, b: 0, adam(LR),
                                 _tcomm(8)).init_opt(params)
        o = tree_map(lambda t: t - 2 if t.dim() == 2 else t, o)
        o3 = zero.zero1_reshard(o, params, _tcomm(3))
        fresh = zero.zero_train_step(lambda p, b: 0, adam(LR),
                                     _tcomm(3)).init_opt(params)
        got = zero.zero1_restore(zero.zero1_snapshot(o), fresh, params,
                                 new_comm=_tcomm(3))
        _assert_trees_equal(got, o3)
        _assert_trees_equal(zero.zero_reshard_p2p(o, params, _tcomm(3)), o3)


def _one_row(state, r=0):
    """Rank r's own rows of a stacked ZeRO state: what one process of a
    host-plane world holds."""
    return tree_map(lambda t: t[r:r + 1] if t.dim() == 2 else t, state)


class TestZeroReshardP2P:
    def test_single_controller_matches_zero1_reshard(self):
        o_t, p_t, _, _ = _carried(8)
        _assert_trees_equal(zero.zero_reshard_p2p(o_t, p_t, _tcomm(4)),
                            zero.zero1_reshard(o_t, p_t, _tcomm(4)))

    def test_grow_matches_direct(self):
        o_t, p_t, _, _ = _carried(4, steps=1)
        _assert_trees_equal(zero.zero_reshard_p2p(o_t, p_t, _tcomm(8),
                                                  old_n=4),
                            zero.zero1_reshard(o_t, p_t, _tcomm(8)))

    @pytest.mark.parametrize("old_n,new_n", [(4, 2), (2, 4), (4, 4)])
    def test_channel_exchange_matches_single_controller(self, old_n, new_n):
        """One rank per channel: leavers serve and return None, joiners
        receive the replicated leaves from old rank 0; the rows stack to
        the single-controller result."""
        o_t, p_t, _, _ = _carried(old_n)
        want = zero.zero_reshard_p2p(o_t, p_t, _tcomm(new_n))
        m = max(old_n, new_n)
        peers, chans, fakes = _mk_world(m)
        old_workers = peers.select(range(old_n))
        new_workers = peers.select(range(new_n))
        for f in fakes:
            f.cluster.workers = old_workers
        fresh = _one_row(zero.zero_train_step(_tloss, adam(LR), _tcomm(
            new_n)).init_opt(p_t))

        def rank_state(r):
            if r >= old_n:
                return fresh  # a joiner: structure only
            return _one_row(o_t, r)

        try:
            outs = run_all([lambda r=r: zero.zero_reshard_p2p(
                rank_state(r), p_t, _tcomm(new_n), peer=fakes[r],
                new_workers=new_workers, tag="t")
                for r in range(m)], timeout=60)
        finally:
            _close(chans)
        assert all(out is None for out in outs[new_n:])
        leaves = [tree_leaves(out) for out in outs[:new_n]]
        for i, w in enumerate(tree_leaves(want)):
            got = (torch.cat([ls[i] for ls in leaves]) if w.dim() == 2
                   else leaves[0][i])
            assert torch.equal(got, w), f"leaf {i}"


class TestSnapshotOverChannel:
    def test_gather_then_broadcast_matches_channel_less(self):
        """zero1_snapshot gathers each rank's row to rank 0 over the
        channel; zero1_restore broadcasts it and every member rebuilds
        its own rows of the new world."""
        o_t, p_t, _, _ = _carried(4)
        peers, chans, fakes = _mk_world(4)
        rows = [_one_row(o_t, r) for r in range(4)]
        try:
            blobs = run_all([lambda r=r: zero.zero1_snapshot(
                rows[r], peer=fakes[r]) for r in range(4)], timeout=60)
            assert blobs[1:] == [None] * 3
            fresh = _one_row(zero.zero_train_step(_tloss, adam(LR), _tcomm(
                4)).init_opt(p_t))
            outs = run_all([lambda r=r: zero.zero1_restore(
                blobs[r], fresh, p_t, peer=fakes[r])
                for r in range(4)], timeout=60)
        finally:
            _close(chans)
        for r, out in enumerate(outs):
            _assert_trees_equal(out, rows[r])
        with pytest.raises(ValueError, match="rank 0"):
            zero.zero1_restore(None, fresh, p_t, peer=fakes[0])

    def test_reshard_over_channel_matches_single_controller(self):
        """zero1_reshard on the members of a new two-rank world: rank 0
        holds the old world's snapshot, each member gets its own row."""
        o_t, p_t, _, _ = _carried(4)
        want = zero.zero1_reshard(o_t, p_t, _tcomm(2))
        blob = zero.zero1_snapshot(o_t)
        _, chans, fakes = _mk_world(2)
        try:
            outs = run_all([lambda r=r: zero.zero1_reshard(
                _one_row(o_t, r), p_t, _tcomm(2), peer=fakes[r],
                snapshot=blob if r == 0 else None) for r in range(2)],
                timeout=60)
        finally:
            _close(chans)
        for r, out in enumerate(outs):
            _assert_trees_equal(out, _one_row(want, r))


# ==========================================================================
# elastic/reshard.py: ZeroBoundary, full mode (tests/test_reshard.py:66)
# ==========================================================================

class TestZeroBoundaryFullMode:
    def test_commit_recarve_place_matches_hand_repad(self):
        _, p, o, params = _train_port(4)
        b = ZeroBoundary()
        b.commit(2, o, params)
        assert b.step() == 2 and b.old_n == 4
        b.recarve(2)
        _assert_trees_equal(b.place(_tcomm(2)),
                            _hand_repad(o, _total(_np_params()), 2))

    @pytest.mark.parametrize("old_n,new_n", RESIZES)
    def test_matches_reference_boundary(self, old_n, new_n):
        o_t, p_t, o_j, p_j = _carried(old_n)
        b, jb = ZeroBoundary(), jreshard.ZeroBoundary()
        b.commit(2, o_t, p_t)
        jb.commit(2, o_j, p_j)
        b.recarve(new_n)
        jb.recarve(new_n)
        _assert_rows_equal(b.place(_tcomm(new_n)), jb.place(_jcomm(new_n)))

    @pytest.mark.parametrize("old_n,new_n", [(4, 2), (2, 4)])
    def test_live_resize_bitwise_vs_fixed_world(self, old_n, new_n):
        """Training through a live re-carve continues bitwise as a
        fixed-size world restored from the same committed boundary."""
        _, p, o, params = _train_port(old_n)
        total = _total(_np_params())
        b = ZeroBoundary()
        b.commit(2, o, params)
        b.recarve(new_n)
        c = _tcomm(new_n)
        z_el = zero.zero_train_step(_tloss, adam(LR), c)
        p_el, o_el, _ = z_el.step(tree_map(torch.clone, p), b.place(c),
                                  _tbatch())
        z_fx = zero.zero_train_step(_tloss, adam(LR), _tcomm(new_n))
        p_fx, o_fx, _ = z_fx.step(tree_map(torch.clone, p),
                                  _hand_repad(o, total, new_n), _tbatch())
        _assert_trees_equal(p_el, p_fx)
        _assert_trees_equal(o_el, o_fx)

    def test_recarve_before_commit_raises(self):
        with pytest.raises(ValueError, match="commit"):
            ZeroBoundary().recarve(2)
        with pytest.raises(ValueError, match="commit"):
            ZeroBoundary().place(_tcomm(2))

    def test_place_wrong_world_raises(self):
        _, _, o, params = _train_port(4, steps=1)
        b = ZeroBoundary()
        b.commit(1, o, params)
        with pytest.raises(ValueError, match="recarve"):
            b.place(_tcomm(2))

    def test_grow_2_to_8(self):
        _, _, o, params = _train_port(2, steps=1)
        b = ZeroBoundary()
        b.commit(1, o, params)
        b.recarve(8)
        _assert_trees_equal(b.place(_tcomm(8)),
                            _hand_repad(o, _total(_np_params()), 8))

    def test_commit_copies(self):
        _, _, o, params = _train_port(4, steps=1)
        b = ZeroBoundary()
        b.commit(1, o, params)
        want = tree_map(torch.clone, o)
        for l in tree_leaves(o):
            l.add_(1)  # the next step overwrites the live state
        b.recarve(4)
        _assert_trees_equal(b.place(_tcomm(4)), want)

    def test_stage3_param_shard_recarves_too(self):
        """ZeRO-3's param shard is one more flat vector; ``total`` comes
        from the param tree, not from the padded shard."""
        z4, p_shard, o, params = _train_port(4, steps=1, stage=3)
        total = _total(_np_params())
        b = ZeroBoundary()
        b.commit(1, {"p": p_shard}, params)
        b.recarve(2)
        got = b.place(_tcomm(2))["p"]
        assert torch.equal(got, _hand_repad({"p": p_shard}, total, 2)["p"])
        z2 = zero.zero_train_step(_tloss, adam(LR), _tcomm(2), stage=3)
        z2.init_opt(params)
        z2.init_params(params)  # binds the stage-3 geometry
        _assert_trees_equal(z2.gather_params(got), z4.gather_params(p_shard))
        z2.step(got, z2.init_opt(params), _tbatch())

    def test_stacked_scalar_is_not_a_chunk(self):
        """A ``[n]`` leaf (a per-replica scalar, ``stack_for_replicas``)
        moves as it is; only ``[n, ceil(total/n)]`` leaves re-carve."""
        _, _, o, params = _train_port(4, steps=1)
        tree = {"o": o, "per_rank": torch.arange(4, dtype=torch.int32)}
        b = ZeroBoundary()
        b.commit(1, tree, params)
        b.recarve(2)
        got = b.place(_tcomm(2))
        assert torch.equal(got["per_rank"], tree["per_rank"])
        _assert_trees_equal(got["o"], _hand_repad(o, _total(_np_params()), 2))

    def test_export_carve_and_chunks(self):
        _, _, o, params = _train_port(2, steps=1)
        b = ZeroBoundary()
        b.commit(1, o, params)
        step, total, old_n, my_old, chunk, full, vec, scal = b.export_carve()
        assert (step, total, old_n, my_old, full) == (1, 133, 2, 0, True)
        assert chunk == 67 and set(vec) == {1, 2} and set(scal) == {0}
        assert b.chunks()[0] == 1


class TestGPTMemoryBudget:
    """tests/test_reshard.py:195 at the same small width: a GPT whose
    replicated optimizer state exceeds one rank's budget trains under
    ZeRO-2 through a live 4 -> 2 shrink."""

    BUDGET_BYTES = 768 << 10

    def test_gpt_trains_sharded_through_live_shrink(self):
        cfg = ttr.TransformerConfig(vocab_size=512, d_model=64, n_layers=2,
                                    n_heads=4, d_ff=128, max_seq=16,
                                    dtype="float32")
        model = ttr.Transformer(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        ids = torch.from_numpy(np.random.RandomState(2).randint(
            0, 512, size=(8, 16)))
        batch = (ids, ids)

        def loss_fn(p, b):
            return model.loss(p, b, train=False,
                              attn_fn=ttr.default_attention)

        assert zero.opt_state_bytes(adam(1e-3).init(params)) > self.BUDGET_BYTES
        z4 = zero.zero_train_step(loss_fn, adam(1e-3), _tcomm(4), stage=2)
        o = z4.init_opt(params)
        assert zero.opt_state_bytes_per_device(o, 4) < self.BUDGET_BYTES
        p = params
        for _ in range(2):
            p, o, _ = z4.step(p, o, batch)
        total = sum(l.numel() for l in tree_leaves(params))
        b = ZeroBoundary()
        b.commit(2, o, params)
        b.recarve(2)
        got = b.place(_tcomm(2))
        _assert_trees_equal(got, _hand_repad(o, total, 2))
        z2 = zero.zero_train_step(loss_fn, adam(1e-3), _tcomm(2), stage=2)
        _, _, loss = z2.step(p, got, batch)
        assert math.isfinite(float(loss))


# ==========================================================================
# chunk mode: one boundary per rank, segments over real host channels
# (tests/test_reshard.py:292)
# ==========================================================================

def _chunks_of(full, total, n):
    chunk = math.ceil(total / n)
    buf = torch.zeros(chunk * n, dtype=full.dtype)
    buf[:total] = full[:total]
    return [buf[r * chunk:(r + 1) * chunk] for r in range(n)]


class TestZeroBoundaryChunkMode:
    TOTAL = 10

    def _vectors(self):
        rng = np.random.RandomState(9)
        return {"mu": torch.from_numpy(rng.randn(self.TOTAL).astype(np.float32)),
                "nu": torch.from_numpy(rng.randn(self.TOTAL).astype(np.float32))}

    def _boundaries(self, vecs, n, step=5):
        mu = _chunks_of(vecs["mu"], self.TOTAL, n)
        nu = _chunks_of(vecs["nu"], self.TOTAL, n)
        out = []
        for r in range(n):
            b = ZeroBoundary()
            b.commit_local(step, {"mu": mu[r], "nu": nu[r],
                                  "count": torch.tensor(step)},
                           total=self.TOTAL, old_n=n, my_old=r)
            out.append(b)
        return out

    def _check(self, bs, vecs, n, step=5):
        want_mu = _chunks_of(vecs["mu"], self.TOTAL, n)
        want_nu = _chunks_of(vecs["nu"], self.TOTAL, n)
        for r, b in enumerate(bs):
            got_step, vec, _ = b.chunks()
            assert got_step == step
            # dict keys flatten sorted: leaf 0 = count, 1/2 = mu/nu
            assert torch.equal(vec[1], want_mu[r])
            assert torch.equal(vec[2], want_nu[r])

    def test_recarve_4_to_2(self):
        vecs = self._vectors()
        peers, chans, fakes = _mk_world(4)
        bs = self._boundaries(vecs, 4)
        try:
            new_workers = plan.PeerList.of(peers[0], peers[1])
            run_all([lambda b=b, f=f: b.recarve(
                2, peer=f, old_workers=peers, new_workers=new_workers,
                tag="t42") for b, f in zip(bs, fakes)], timeout=60)
        finally:
            _close(chans)
        self._check(bs[:2], vecs, 2)
        for r in (2, 3):
            assert bs[r].chunks()[1] == {}  # leavers dropped their shard

    def test_recarve_2_to_4_with_joiners(self):
        vecs = self._vectors()
        peers, chans, fakes = _mk_world(4)
        old_workers = plan.PeerList.of(peers[0], peers[1])
        bs = self._boundaries(vecs, 2, step=7)
        for _ in range(2):
            b = ZeroBoundary()
            b.join({"mu": torch.zeros(3), "nu": torch.zeros(3),
                    "count": torch.tensor(0)},
                   {"w": torch.zeros(self.TOTAL)}, old_n=2)
            bs.append(b)
        try:
            run_all([lambda b=b, f=f: b.recarve(
                4, peer=f, old_workers=old_workers, new_workers=peers,
                tag="t24") for b, f in zip(bs, fakes)], timeout=60)
        finally:
            _close(chans)
        self._check(bs, vecs, 4, step=7)
        _, _, scal = bs[2].chunks()  # a joiner adopted the scalar
        assert int(list(scal.values())[0]) == 7

    def _dead_world(self, stride, dead, survivors):
        vecs = self._vectors()
        peers, chans, fakes = _mk_world(4)
        bs = self._boundaries(vecs, 4)
        try:
            sent = run_all([lambda b=b, f=f: b.replicate_ring(
                f.channel, peers, tag="rb", stride=stride)
                for b, f in zip(bs, fakes)], timeout=60)
            for r in dead:
                chans[r].close()  # the dead ranks are gone
            new_workers = peers.select(survivors)
            run_all([lambda r=r: bs[r].recarve(
                2, peer=fakes[r], old_workers=peers,
                new_workers=new_workers, tag="tdead", dead=dead)
                for r in survivors], timeout=60)
        finally:
            _close(chans)
        assert sent == [3 * 4 * 2] * 4  # two chunk leaves of 3 f32 each
        self._check([bs[r] for r in survivors], vecs, 2)
        return [bs[r] for r in survivors]

    def test_dead_ranks_served_from_ring_buddies(self):
        got = self._dead_world(1, (1, 3), [0, 2])
        c2 = _tcomm(2)
        stacked = place_stacked(got, c2)
        full = self._vectors()
        assert torch.equal(stacked["mu"].reshape(-1)[:self.TOTAL], full["mu"])
        assert stacked["count"].item() == 5

    def test_cross_slice_stride_survives_whole_slice_death(self):
        self._dead_world(2, (2, 3), [0, 1])

    def test_matches_reference_chunk_mode(self, no_unixsock):
        """The same dead-rank re-carve in the reference, over its own
        channels, gives the port's bits."""
        vecs = self._vectors()
        mine = self._dead_world(1, (1, 3), [0, 2])
        chans = [_ref_channel() for _ in range(4)]
        peers = jplan.PeerList.of(*(c.self_id for c in chans))
        fakes = [type("P", (), {"channel": c, "config": type(
            "C", (), {"self_id": c.self_id})()})() for c in chans]
        np_vecs = {k: v.numpy() for k, v in vecs.items()}
        bs = []
        for r in range(4):
            b = jreshard.ZeroBoundary()
            chunk = math.ceil(self.TOTAL / 4)
            pad = {k: np.concatenate([v, np.zeros(chunk * 4 - self.TOTAL,
                                                  v.dtype)])
                   for k, v in np_vecs.items()}
            b.commit_local(5, {"mu": pad["mu"][r * chunk:(r + 1) * chunk],
                               "nu": pad["nu"][r * chunk:(r + 1) * chunk],
                               "count": np.int64(5)},
                           total=self.TOTAL, old_n=4, my_old=r)
            bs.append(b)
        try:
            run_all([lambda b=b, f=f: b.replicate_ring(f.channel, peers,
                                                       tag="rb")
                     for b, f in zip(bs, fakes)], timeout=60)
            new_workers = jplan.PeerList.of(peers[0], peers[2])
            run_all([lambda r=r: bs[r].recarve(
                2, peer=fakes[r], old_workers=peers,
                new_workers=new_workers, tag="td", dead=(1, 3))
                for r in (0, 2)], timeout=60)
        finally:
            _close(chans)
        for ours, ref in zip(mine, (bs[0], bs[2])):
            got, want = ours.chunks()[1], ref.chunks()[1]
            for i in (1, 2):
                np.testing.assert_array_equal(got[i].numpy(), want[i])

    def test_dead_rank_without_buddy_raises(self):
        vecs = self._vectors()
        peers, chans, fakes = _mk_world(4)
        bs = self._boundaries(vecs, 4)
        try:
            new_workers = peers.select([0, 1, 2])
            with pytest.raises(ValueError, match="buddy"):
                bs[2].recarve(3, peer=fakes[2], old_workers=peers,
                              new_workers=new_workers, tag="tnb", dead=(3,))
        finally:
            _close(chans)

    def test_dead_rank_and_dead_predecessor_unrecoverable(self):
        vecs = self._vectors()
        peers, chans, fakes = _mk_world(4)
        bs = self._boundaries(vecs, 4)
        try:
            with pytest.raises(ValueError, match="predecessor"):
                bs[0].recarve(2, peer=fakes[0], old_workers=peers,
                              new_workers=peers.select([0, 1]), tag="tdd",
                              dead=(2, 3))
        finally:
            _close(chans)

    def test_commit_local_validates_chunk_shape(self):
        with pytest.raises(ValueError, match="chunk"):
            ZeroBoundary().commit_local(0, {"mu": torch.zeros(5)}, total=10,
                                        old_n=4, my_old=0)

    def test_stride_bounds_validated(self):
        bs = self._boundaries(self._vectors(), 4)
        for bad in (0, 4, -1):
            with pytest.raises(ValueError, match="stride"):
                bs[0].replicate_ring(None, None, tag="bad", stride=bad)

    def test_place_stacked_guards(self):
        bs = self._boundaries(self._vectors(), 2)
        with pytest.raises(ValueError, match="world"):
            place_stacked(bs, _tcomm(3))
        with pytest.raises(ValueError, match="rank order"):
            place_stacked(bs[::-1], _tcomm(2))
        stacked = place_stacked(bs, _tcomm(2))
        assert torch.equal(stacked["nu"].reshape(-1)[:self.TOTAL],
                           self._vectors()["nu"])

    def test_recarve_after_shrink(self):
        """The shrink hook derives the dead set from the survivor list
        and tags the exchange with the cluster version."""
        vecs = self._vectors()
        peers, chans, fakes = _mk_world(4)
        bs = self._boundaries(vecs, 4)
        survivors = peers.select([0, 2])
        try:
            run_all([lambda b=b, f=f: b.replicate_ring(f.channel, peers,
                                                       tag="rs")
                     for b, f in zip(bs, fakes)], timeout=60)
            for r in (1, 3):
                chans[r].close()
            for f in fakes:
                f.cluster.workers = survivors
                f.cluster_version = 3
            run_all([lambda r=r: recarve_after_shrink(
                fakes[r], bs[r], peers, expect_step=5) for r in (0, 2)],
                timeout=60)
        finally:
            _close(chans)
        self._check([bs[0], bs[2]], vecs, 2)


# ==========================================================================
# the guards of the exchange (tests/test_reshard.py:503), against the
# reference's errors
# ==========================================================================

class TestRecarveGuards:
    TOTAL = 10

    def _committed(self, step=5, old_n=2, my_old=0, ref=False):
        chunk = math.ceil(self.TOTAL / old_n)
        if ref:
            b = jreshard.ZeroBoundary()
            b.commit_local(step, {"mu": np.zeros(chunk, np.float32)},
                           total=self.TOTAL, old_n=old_n, my_old=my_old)
            return b
        b = ZeroBoundary()
        b.commit_local(step, {"mu": torch.zeros(chunk)}, total=self.TOTAL,
                       old_n=old_n, my_old=my_old)
        return b

    def test_step_mismatch_raises(self):
        b = ZeroBoundary()
        b.commit(5, {"mu": torch.zeros(1, self.TOTAL)},
                 {"w": torch.zeros(self.TOTAL)})
        jb = jreshard.ZeroBoundary()
        jb.commit(5, {"mu": jnp.zeros(self.TOTAL)}, {"w": jnp.zeros(self.TOTAL)})
        with pytest.raises(ValueError, match="blend"):
            jb.recarve(1, expect_step=4)
        with pytest.raises(ValueError, match="blend"):
            b.recarve(1, expect_step=4)
        b.recarve(1, expect_step=5)  # the agreed step passes

    def _stub_peer(self, workers, chan):
        return type("P", (), {"channel": chan, "config": type(
            "C", (), {"self_id": workers[0]})()})()

    @pytest.mark.parametrize("old_n,my_old", [(4, 0), (2, 1)])
    def test_epoch_mismatch_raises(self, old_n, my_old):
        class _Chan:
            def send(self, *a, **k):
                raise AssertionError("no bytes may move on a stale epoch")

            recv = recv_into = send

        for ref, mod in ((True, jplan), (False, plan)):
            workers2 = mod.PeerList.of(mod.PeerID("127.0.0.1", 1),
                                       mod.PeerID("127.0.0.1", 2))
            b = self._committed(old_n=old_n, my_old=my_old, ref=ref)
            with pytest.raises(ValueError, match="stale"):
                b.recarve(2, peer=self._stub_peer(workers2, _Chan()),
                          old_workers=workers2, new_workers=workers2,
                          tag="te")

    def test_recv_timeout_becomes_peer_failure_error(self):
        class _HungChan:
            def send(self, *a, **k):
                pass

            def recv(self, src, name, *a, **k):
                raise TimeoutError(f"recv {name!r} timed out")

            recv_into = recv

        from kungfu_tpu.comm.faults import PeerFailureError as JPeerFailure

        for ref, mod, err in ((True, jplan, JPeerFailure),
                              (False, plan, PeerFailureError)):
            workers = mod.PeerList.of(mod.PeerID("127.0.0.1", 1),
                                      mod.PeerID("127.0.0.1", 2))
            b = self._committed(old_n=2, my_old=0, ref=ref)
            with pytest.raises(err) as ei:
                b.recarve(1, peer=self._stub_peer(workers, _HungChan()),
                          old_workers=workers,
                          new_workers=mod.PeerList.of(workers[0]), tag="tt")
            assert ei.value.rank == 1
            assert isinstance(ei.value, ConnectionError)

    def test_fault_messages_match_reference(self):
        from kungfu_tpu.comm import faults as jfaults
        from kungfu_tpu_torch.comm import faults

        cases = [("PeerFailureError", (2,), dict(peer="h:1", op="x",
                                                 phase="recv", cause="t")),
                 ("SliceExcludedError", (1, [3, 2]), {}),
                 ("ServeOverloadError", (4, 4), {}),
                 ("RequestLostError", ("r", [1, 2], "why"), {}),
                 ("QuorumLostError", (1, 3), {})]
        for name, args, kw in cases:
            assert (str(getattr(faults, name)(*args, **kw))
                    == str(getattr(jfaults, name)(*args, **kw)))
