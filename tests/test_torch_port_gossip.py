"""Port parity: pair-averaging gossip (``optimizers/async_sgd.py``).

Mirrors ``tests/test_optimizers.py``'s ``TestPairAveraging`` and
``TestAsyncPairAveraging`` on the port, and holds the port against the
JAX package (``kungfu_tpu``) on the same inputs: the fused bytes a peer
publishes (f32 and bf16, bitwise), the sequence of targets each
selector picks, a mixed pair of one port and one reference peer pulling
from each other, and blocking gossip in lockstep on
``benchmarks/system.py``'s quick BERT, three port peers against three
reference peers, params within 1e-6 relative L2 per leaf after three
steps.

Peers take ports found free (``start_local_cluster`` for the port's,
:func:`_ref_peers` for the reference's, the whole cluster retried on
``EADDRINUSE``); reference channels run with ``KF_TPU_USE_UNIXSOCK=0``.
No assertion reads a host speed: the async tests hold a fake wire
closed and assert that the steps finish, and what they averaged.
"""

import errno
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.optimizers import async_sgd as jasync
from kungfu_tpu.peer import Peer as JPeer
from kungfu_tpu.store import store as jstore
from kungfu_tpu.utils import envs as jenvs
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.optimizers import (AsyncPairAveragingOptimizer,
                                         PairAveragingOptimizer, sgd)
from kungfu_tpu_torch.optimizers.async_sgd import _ModelPuller
from kungfu_tpu_torch.peer import Peer, start_local_cluster
from kungfu_tpu_torch.store import store
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                        tree_unflatten)
from tests._util import run_all

#: three blocking gossip steps of f32 params: the averages are the same
#: two-term f32 sums on both sides, the updates differ by the two
#: frameworks' gradient summation orders times the learning rate
PARAMS_REL_L2 = 1e-6
LOCKSTEP_STEPS = 3
#: benchmarks/system.py:71-74's quick BERT, in f32
_BERT = dict(vocab_size=1000, d_model=128, n_layers=2, n_heads=4, d_ff=256,
             max_seq=128, causal=False, pos="learned", dtype="float32")
ROWS, SEQ = 2, 32


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for k in ("KF_CHAOS_SPEC", "KF_TPU_HOST_TRANSPORT",
              "KF_CONFIG_ENABLE_MONITORING",
              "KF_CONFIG_ENABLE_CLUSTER_MONITOR"):
        monkeypatch.delenv(k, raising=False)
    store.reset_local_store()
    jstore.reset_local_store()
    yield
    store.reset_local_store()
    jstore.reset_local_store()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env_dict(r, ports):
    return envs.single_machine_env(r, len(ports), ports=ports)


def _ref_peers(n, attempts=5):
    """``n`` started reference peers on ports found free."""
    for _ in range(attempts):
        ports = _free_ports(n)
        peers = []
        try:
            for r in range(n):
                peers.append(JPeer(jenvs.parse_config_from_env(
                    _env_dict(r, ports))))
                peers[-1].start()
            return peers
        except OSError as e:
            for p in peers:
                p.close()
            if getattr(e, "errno", None) not in (None, errno.EADDRINUSE):
                raise
    raise OSError("no free ports for a reference cluster")


def _mixed_pair(attempts=5):
    """A reference peer (rank 0) and a port peer (rank 1) of one cluster."""
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


def _close(things):
    for t in things:
        t.close()


class _FakeRankPeer:
    """Rank and size only: what the selector and the serializer read."""

    def __init__(self, rank=0, size=4):
        self._rank, self._size = rank, size

    def rank(self):
        return self._rank

    def size(self):
        return self._size


# -- the reference's single-process and two-peer cases ------------------------
class TestPairAveraging:
    def test_single_process_gossip_loop(self):
        """One peer: plain SGD, the model published; the reference's
        single-process peer gives the same params."""
        peer = Peer(envs.parse_config_from_env({}), devices=["cpu"])
        peer.start()
        opt = PairAveragingOptimizer(sgd(0.1), peer=peer)
        params = {"w": torch.arange(4, dtype=torch.float32)}
        state = opt.init(params)
        params, state = opt.step(params, {"w": torch.ones(4)}, state)
        np.testing.assert_allclose(params["w"].numpy(), np.arange(4) - 0.1,
                                   rtol=1e-6)
        assert peer.store.get("model") is not None
        assert opt.local_steps == 1 and opt.averaged_steps == 0

        jpeer = JPeer(jenvs.parse_config_from_env({}))
        jpeer.start()
        jopt = jasync.PairAveragingOptimizer(optax.sgd(0.1), peer=jpeer)
        jp = {"w": jnp.arange(4, dtype=jnp.float32)}
        jp, _ = jopt.step(jp, {"w": jnp.ones(4, jnp.float32)}, jopt.init(jp))
        assert np.array_equal(np.asarray(jp["w"]), params["w"].numpy())
        assert (bytes(peer.store.get("model"))
                == bytes(jpeer.store.get("model")))

    def test_two_peer_gossip_averaging(self):
        """Two port peers on loopback: pull and average."""
        peers = start_local_cluster(2, devices=["cpu"])
        try:
            opts = [PairAveragingOptimizer(sgd(0.0), peer=p,
                                           selector="roundrobin")
                    for p in peers]
            params = [{"w": torch.zeros(4)}, {"w": torch.full((4,), 2.0)}]
            states = run_all([lambda i=i: opts[i].init(params[i])
                              for i in range(2)], timeout=30)
            p0, _ = opts[0].step(params[0], {"w": torch.zeros(4)}, states[0])
            np.testing.assert_allclose(p0["w"].numpy(), np.ones(4), rtol=1e-6)
            assert opts[0].averaged_steps == 1
            assert opts[0].pull_bytes == 16
        finally:
            _close(peers)


# -- _ModelPuller without a wire ----------------------------------------------
class _FakePullPeer:
    """``request_into`` fills the buffer with an incrementing value, or
    misses when told to."""

    def __init__(self):
        self.pulls = 0
        self.miss = False
        self.delay = 0.0

    def request_into(self, target, name, buf, version=None, timeout=None,
                     send_retries=None):
        import time

        if self.delay:
            time.sleep(self.delay)
        if self.miss:
            return None
        self.pulls += 1
        buf[:] = float(self.pulls)
        return buf


class TestAsyncPairAveraging:
    def _puller(self, peer, **kw):
        kw.setdefault("min_interval", 0.0)
        return _ModelPuller(peer, "m", 32, lambda: 1, **kw)

    def test_puller_lands_and_reuses(self):
        peer = _FakePullPeer()
        p = self._puller(peer, min_interval=60.0)  # exactly one landing
        p.start()
        try:
            assert p.wait_landed(5.0)
            buf, seq = p.take()
            assert seq == 1
            np.testing.assert_allclose(buf, 1.0)
            buf2, seq2 = p.take()  # no new landing: the same model
            assert seq2 == 1 and buf2 is buf
        finally:
            p.close()
        assert not p.is_alive()

    def test_puller_freshest_wins(self):
        import time

        peer = _FakePullPeer()
        p = self._puller(peer)
        p.start()
        try:
            assert p.wait_landed(5.0)
            deadline = time.monotonic() + 5.0
            while peer.pulls < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            buf, seq = p.take()
            assert seq >= 2  # straight to the freshest landing
            np.testing.assert_allclose(buf, float(buf[0]))
            _, later = p.take()
            assert later >= seq
        finally:
            p.close()

    def test_slot_rotation(self):
        """Three slots: the read slot is never the one being written,
        and a take hands the previous read slot back."""
        peer = _FakePullPeer()
        p = self._puller(peer, paced=True)
        p.start()
        try:
            seen = []
            for _ in range(6):
                p.kick()
                assert p.wait_landed(5.0)
                buf, seq = p.take()
                with p._lock:
                    read, free, ready = p._read, list(p._free), p._ready
                assert p._slots[read] is buf
                assert read not in free and read != ready
                assert sorted(free + [read] + ([ready] if ready is not None
                                               else [])) == [0, 1, 2]
                seen.append(read)
                np.testing.assert_allclose(buf, float(seq))
            assert len(set(seen)) >= 2  # the slots rotate
        finally:
            p.close()

    def test_puller_miss_path(self):
        peer = _FakePullPeer()
        peer.miss = True
        p = self._puller(peer)
        p.start()
        try:
            assert not p.wait_landed(0.3)
            assert p.take() is None
            assert p.misses > 0
        finally:
            p.close()
        assert not p.is_alive()

    def test_puller_teardown_with_slow_wire(self):
        """close() joins within its bound with a pull in flight."""
        peer = _FakePullPeer()
        peer.delay = 0.5
        p = self._puller(peer, pull_timeout=1.0)
        p.start()
        p.close()
        assert not p.is_alive()

    def test_staleness_bound_blocks_for_fresh_landing(self):
        """On a silent wire, wait_landed returns False at its bound."""
        peer = _FakePullPeer()
        p = _ModelPuller(peer, "m", 16, lambda: 1, min_interval=30.0)
        p.start()
        try:
            assert p.wait_landed(5.0)
            p.take()
            assert not p.wait_landed(0.3)
        finally:
            p.close()

    def test_async_step_does_not_wait_on_the_wire(self):
        """After the first landing the wire stays closed: the steps
        finish anyway, each averaging with the one landed model (0 and 7
        average to 3.5), and the staleness bound is not reached."""
        release = threading.Event()

        class _FakeGossipPeer:
            def __init__(self):
                self.blobs = {}
                self.served = 0

            def rank(self):
                return 0

            def size(self):
                return 2

            def save(self, name, blob, version=None, copy=True):
                self.blobs[name] = np.asarray(blob).copy()

            def barrier(self):
                pass

            def request_into(self, target, name, buf, version=None,
                             timeout=None, send_retries=None):
                if self.served:
                    release.wait(timeout)
                    return None
                self.served += 1
                buf[:] = np.full(buf.nbytes // 4, 7.0, np.float32).view(
                    np.uint8)
                return buf

        peer = _FakeGossipPeer()
        opt = AsyncPairAveragingOptimizer(sgd(0.0), peer=peer,
                                          pull_timeout=5.0, max_staleness=16)
        params = {"w": torch.zeros(1024)}
        state = opt.init(params)
        g = {"w": torch.zeros(1024)}
        try:
            def run():
                nonlocal params, state
                for _ in range(6):
                    params, state = opt.step(params, g, state)

            run_all([run], timeout=60)
            assert opt.averaged_steps == 6 and opt.local_steps == 0
            assert opt._consumed_same == 5
            assert opt._puller.seq == 1
            # 0 -> 3.5 -> 5.25 -> ...: every step averaged with the 7s
            want = 0.0
            for _ in range(6):
                want = 0.5 * want + 3.5
            np.testing.assert_allclose(params["w"].numpy(), want, rtol=1e-6)
        finally:
            release.set()
            opt.close()

    def test_two_peer_async_gossip_averaging(self):
        peers = start_local_cluster(2, devices=["cpu"])
        opts = []
        try:
            opts = [AsyncPairAveragingOptimizer(
                sgd(0.0), peer=p, selector="roundrobin", pull_timeout=10.0)
                for p in peers]
            params = [{"w": torch.zeros(4)}, {"w": torch.full((4,), 2.0)}]
            states = run_all([lambda i=i: opts[i].init(params[i])
                              for i in range(2)], timeout=30)
            # the first step blocks for the first landing: 0.5*(0+2)
            p0, _ = opts[0].step(params[0], {"w": torch.zeros(4)}, states[0])
            np.testing.assert_allclose(p0["w"].numpy(), np.ones(4), rtol=1e-6)
            assert opts[0].averaged_steps == 1
            assert opts[0].pull_bytes >= 16
        finally:
            _close(opts)
            _close(peers)

    def test_async_gossip_survives_peer_departure(self):
        """A peer leaves mid-gossip: pulls from it miss, the pullers
        live, and the survivors keep averaging."""
        peers = start_local_cluster(3, devices=["cpu"])
        opts = []
        try:
            opts = [AsyncPairAveragingOptimizer(
                sgd(0.0), peer=p, selector="roundrobin", pull_timeout=2.0,
                max_staleness=2) for p in peers]
            params = [{"w": torch.full((4,), float(i))} for i in range(3)]
            states = run_all([lambda i=i: opts[i].init(params[i])
                              for i in range(3)], timeout=30)
            g = {"w": torch.zeros(4)}
            for i in range(3):
                params[i], states[i] = opts[i].step(params[i], g, states[i])
            opts[2].close()
            peers[2].close()
            before = [opts[i].averaged_steps for i in range(2)]
            for _ in range(4):
                for i in range(2):
                    params[i], states[i] = opts[i].step(params[i], g,
                                                        states[i])
            for i in range(2):
                assert opts[i]._puller.is_alive()
                assert opts[i].averaged_steps > before[i]
        finally:
            _close(opts[:2])
            _close(peers[:2])

    def test_bf16_wire_gossip(self):
        """``fuse_dtype=bfloat16``: the model travels as raw bytes."""
        peers = start_local_cluster(2, devices=["cpu"])
        opts = []
        try:
            opts = [AsyncPairAveragingOptimizer(
                sgd(0.0), peer=p, selector="roundrobin",
                fuse_dtype=torch.bfloat16) for p in peers]
            params = [{"w": torch.zeros(64)}, {"w": torch.full((64,), 2.0)}]
            states = run_all([lambda i=i: opts[i].init(params[i])
                              for i in range(2)], timeout=30)
            p0, _ = opts[0].step(params[0], {"w": torch.zeros(64)}, states[0])
            np.testing.assert_allclose(p0["w"].numpy(), np.ones(64))
            puller = opts[0]._puller
            with puller._lock:  # bf16: half the f32 bytes a landing
                assert puller.pull_bytes == 128 * puller.seq > 0
        finally:
            _close(opts)
            _close(peers)


# -- against the JAX package ---------------------------------------------------
def _bert_params(seed=0):
    """The quick BERT's params from one JAX init: ``(jax tree, port
    tree)`` holding the same numbers."""
    jmodel = jtr.Transformer(jtr.TransformerConfig(**_BERT))
    jp = jmodel.init(jax.random.PRNGKey(seed))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 ttr.TransformerConfig(**_BERT), device="cpu")
    return jp, tp


class TestAgainstReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_publish_bytes_match_reference(self, dtype):
        """The fused buffer a port peer publishes is the reference's,
        byte for byte, for the same params."""
        jp, tp = _bert_params()
        mine = PairAveragingOptimizer(sgd(0.0), peer=_FakeRankPeer(),
                                      fuse_dtype=getattr(torch, dtype))
        ref = jasync.PairAveragingOptimizer(optax.sgd(0.0),
                                            peer=_FakeRankPeer(),
                                            fuse_dtype=getattr(jnp, dtype))
        got = mine._serialize(tp)
        want = ref._serialize(jp)
        assert got.dtype == np.uint8 and want.dtype == np.uint8
        assert got.tobytes() == want.tobytes()
        assert mine._model_nbytes(tp) == ref._model_nbytes(jp) == got.nbytes

    @pytest.mark.parametrize("selector", ["random", "roundrobin"])
    def test_target_sequence_matches_reference(self, selector):
        for rank in range(4):
            mine = PairAveragingOptimizer(sgd(0.0), peer=_FakeRankPeer(rank),
                                          selector=selector, seed=3)
            ref = jasync.PairAveragingOptimizer(
                optax.sgd(0.0), peer=_FakeRankPeer(rank), selector=selector,
                seed=3)
            got = [mine._select_peer() for _ in range(40)]
            assert got == [ref._select_peer() for _ in range(40)]
            assert rank not in got and len(set(got)) == 3

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_mixed_pair_gossips(self, dtype):
        """A reference peer and a port peer pull from each other: the
        reference steps first (0 and the port's 2 average to 1), then the
        port (2 and the reference's 1 to 1.5); each publishes the bytes
        the other package's serializer makes for its params."""
        ref, mine = _mixed_pair()
        try:
            jopt = jasync.PairAveragingOptimizer(
                optax.sgd(0.0), peer=ref, selector="roundrobin",
                fuse_dtype=getattr(jnp, dtype))
            opt = PairAveragingOptimizer(sgd(0.0), peer=mine,
                                         selector="roundrobin",
                                         fuse_dtype=getattr(torch, dtype))
            jp = {"w": jnp.zeros(64, jnp.float32)}
            tp = {"w": torch.full((64,), 2.0)}
            jstate, tstate = run_all([lambda: jopt.init(jp),
                                      lambda: opt.init(tp)], timeout=30)
            jp1, _ = jopt.step(jp, {"w": jnp.zeros(64, jnp.float32)}, jstate)
            tp1, _ = opt.step(tp, {"w": torch.zeros(64)}, tstate)
            np.testing.assert_array_equal(np.asarray(jp1["w"]), np.ones(64))
            np.testing.assert_array_equal(tp1["w"].numpy(),
                                          np.full(64, 1.5))
            assert jopt.averaged_steps == opt.averaged_steps == 1
            assert bytes(ref.store.get("model")) == \
                opt._serialize({"w": torch.ones(64)}).tobytes()
            assert bytes(mine.store.get("model")) == \
                jopt._serialize({"w": jnp.full(64, 1.5, jnp.float32)}) \
                .tobytes()
        finally:
            _close([mine, ref])

    def test_lockstep_gossip_matches_reference(self):
        """Blocking gossip on the quick BERT, three port peers against
        three reference peers, roundrobin, in lockstep: each peer's params
        after three steps within 1e-6 relative L2 per leaf."""
        n = 3
        jmodel = jtr.Transformer(jtr.TransformerConfig(**_BERT))
        tmodel = ttr.Transformer(ttr.TransformerConfig(**_BERT))
        jbase, _ = _bert_params()
        rng = np.random.default_rng(7)
        # one seeded init, each rank's leaves perturbed by its own draw
        jparams = [jax.tree_util.tree_map(
            lambda a, r=r: np.asarray(a) + np.random.default_rng(100 + r)
            .standard_normal(a.shape).astype(np.float32) * 1e-2, jbase)
            for r in range(n)]
        tparams = [interop.params_from_jax(p, ttr.TransformerConfig(**_BERT),
                                           device="cpu") for p in jparams]
        jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in jparams]
        batches = [[rng.integers(0, _BERT["vocab_size"], size=(ROWS, SEQ))
                    for _ in range(2)] for _ in range(LOCKSTEP_STEPS * n)]

        jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss(
            p, b, attn_fn=jtr.default_attention)))

        def tgrad(p, b):
            leaves, treedef = tree_flatten(p)
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            loss = tmodel.loss(tree_unflatten(treedef, leaves), b,
                               attn_fn=ttr.default_attention)
            return tree_unflatten(treedef,
                                  list(torch.autograd.grad(loss, leaves)))

        jpeers = _ref_peers(n)
        tpeers = start_local_cluster(n, devices=["cpu"])
        try:
            jopts = [jasync.PairAveragingOptimizer(
                optax.sgd(0.05, momentum=0.9), peer=p, selector="roundrobin")
                for p in jpeers]
            topts = [PairAveragingOptimizer(sgd(0.05, momentum=0.9), peer=p,
                                            selector="roundrobin")
                     for p in tpeers]
            # lockstep: every peer pulls before any publishes, and every
            # peer has published before the next step's pulls, so each
            # pull reads its target's previous version
            pulled, after_step = threading.Barrier(n), threading.Barrier(n)
            for o in jopts + topts:
                def pull(target, orig=o._pull):
                    got = orig(target)
                    pulled.wait(60)
                    return got

                o._pull = pull
            jst = run_all([lambda i=i: jopts[i].init(jparams[i])
                           for i in range(n)], timeout=60)
            tst = run_all([lambda i=i: topts[i].init(tparams[i])
                           for i in range(n)], timeout=60)
            for k in range(LOCKSTEP_STEPS):
                bs = batches[k * n:(k + 1) * n]
                jg = [jgrad(jparams[i], tuple(jnp.asarray(x, jnp.int32)
                                              for x in bs[i]))
                      for i in range(n)]
                tg = [tgrad(tparams[i], tuple(torch.from_numpy(x)
                                              for x in bs[i]))
                      for i in range(n)]

                def jstep(i):
                    out = jopts[i].step(jparams[i], jg[i], jst[i])
                    after_step.wait(60)
                    return out

                def tstep(i):
                    out = topts[i].step(tparams[i], tg[i], tst[i])
                    after_step.wait(60)
                    return out

                jouts = run_all([lambda i=i: jstep(i) for i in range(n)],
                                timeout=60)
                touts = run_all([lambda i=i: tstep(i) for i in range(n)],
                                timeout=60)
                jparams, jst = [o[0] for o in jouts], [o[1] for o in jouts]
                tparams, tst = [o[0] for o in touts], [o[1] for o in touts]
            assert all(o.averaged_steps == LOCKSTEP_STEPS for o in topts)
            assert all(o.averaged_steps == LOCKSTEP_STEPS for o in jopts)
            for i in range(n):
                jl = [np.asarray(a) for a in
                      jax.tree_util.tree_leaves(jparams[i])]
                tl = [t.detach().numpy() for t in tree_leaves(tparams[i])]
                assert len(jl) == len(tl)
                for j, (a, b) in enumerate(zip(jl, tl)):
                    rel = (np.linalg.norm(b.astype(np.float64) - a)
                           / np.linalg.norm(a.astype(np.float64)))
                    assert rel <= PARAMS_REL_L2, (i, j, rel)
            # the peers gossiped: their params are no longer their own
            assert not np.array_equal(
                tree_leaves(tparams[0])[0].numpy(),
                tree_leaves(tparams[1])[0].numpy())
        finally:
            _close(tpeers)
            _close(jpeers)
