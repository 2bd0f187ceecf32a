"""Port parity: the serving plane (router, workers, fleet, policies, KV
snapshots) against the JAX package.

Mirrors ``tests/test_serve.py``'s router, replay-budget and policy
tests, ``tests/test_pp.py``'s ``ServeFleet`` tests and
``tests/test_persist.py``'s KV snapshot and warm-cache tests on the
port, and holds the port against ``kungfu_tpu`` on the same inputs:

* ``remaining_budget`` on the reference's cases;
* the router's ``req.srv`` frames byte for byte, replays included, over
  a recording channel;
* live clusters of port peers (``start_local_cluster``, the Python
  transport): completion and typed overload, a chaos worker kill
  replayed on a survivor token-identical to the reference engine's
  ``drain``, ``die_slice`` excluding a whole slice, a dropped request
  replayed without a strike-out, and all workers dead as a typed loss
  carrying the committed tokens;
* a mixed pair both ways: a port worker behind a reference router and a
  reference worker behind a port router;
* the serving policies' decision sequences over 200 seeded observations;
* ``ServeFleet``'s slice scale-in and a real spawn and retire;
* KV snapshots written by either package and restored by the other (f32
  and bf16 as 16-bit patterns, digests, torn and corrupt pages) and the
  warm cache through a cold restart, through the persist plane on disk;
* the engine's scheduling surface (``width``, ``wait_for_work``, the
  ``plan=`` guard), ``SLORules`` and the serving knobs' defaults.

The tiny model of ``tests/test_serve.py:26`` runs in f32 on the CPU,
its weights carried across by ``kungfu_tpu_torch.interop``.  Peers take
ports found free; reference peers retry on ``EADDRINUSE`` and run with
``KF_TPU_USE_UNIXSOCK=0``.
"""

import errno
import json
import socket
import time
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kungfu_tpu import chaos as jchaos
from kungfu_tpu.comm.faults import RequestLostError as JRequestLostError
from kungfu_tpu.comm.faults import ServeOverloadError as JServeOverloadError
from kungfu_tpu.elastic import persist as jpersist
from kungfu_tpu.elastic.slices import SliceTopology as JSliceTopology
from kungfu_tpu.models.transformer import Transformer as JTransformer
from kungfu_tpu.models.transformer import TransformerConfig as JConfig
from kungfu_tpu.monitor import timeline as jtimeline
from kungfu_tpu.parallel.train import ParallelPlan as JPlan
from kungfu_tpu.peer import Peer as JPeer
from kungfu_tpu.plan import PeerID as JPeerID
from kungfu_tpu.plan import PeerList as JPeerList
from kungfu_tpu.policy import base as jbase
from kungfu_tpu.policy import serve as jpolicy
from kungfu_tpu.serve import router as jrouter
from kungfu_tpu.serve import scale as jscale
from kungfu_tpu.serve import slo as jslo
from kungfu_tpu.serve.engine import InferenceEngine as JEngine
from kungfu_tpu.serve.kvcache import KVCachePool as JPool
from kungfu_tpu.serve.kvcache import PageSpec as JPageSpec
from kungfu_tpu.utils import envs as jenvs
from kungfu_tpu_torch.parallel.train import ParallelPlan
from kungfu_tpu_torch import chaos, interop
from kungfu_tpu_torch import policy as tpolicy
from kungfu_tpu_torch.comm.faults import (RequestLostError,
                                          ServeOverloadError)
from kungfu_tpu_torch.elastic import persist
from kungfu_tpu_torch.elastic.slices import SliceTopology
from kungfu_tpu_torch.models.transformer import Transformer, TransformerConfig
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.peer import Peer, start_local_cluster
from kungfu_tpu_torch.plan import PeerID, PeerList
from kungfu_tpu_torch.policy import base as tbase
from kungfu_tpu_torch.policy import serve as tserve
from kungfu_tpu_torch.serve import router as trouter
from kungfu_tpu_torch.serve import scale as tscale
from kungfu_tpu_torch.serve import slo
from kungfu_tpu_torch.serve.engine import InferenceEngine
from kungfu_tpu_torch.serve.kvcache import KVCachePool, PageSpec
from kungfu_tpu_torch.utils import envs

_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=128, dtype="float32")
JCFG, CFG = JConfig(**_KW), TransformerConfig(**_KW)


@pytest.fixture(scope="module")
def weights():
    jparams = JTransformer(JCFG).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, interop.params_from_jax(tree, CFG, device="cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
    monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
    for k in ("KF_CHAOS_SPEC", "KF_CONFIG_ENABLE_MONITORING",
              "KF_CONFIG_ENABLE_CLUSTER_MONITOR"):
        monkeypatch.delenv(k, raising=False)
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _engine(weights, rank=None, pages=128, max_batch=4, **kw):
    _, tparams = weights
    return InferenceEngine(
        Transformer(CFG), tparams,
        pool=KVCachePool(PageSpec.for_model(CFG, page_tokens=8), pages),
        max_batch=max_batch, max_seq=CFG.max_seq, rank=rank, **kw)


def _jengine(weights, rank=None, pages=128, max_batch=4, **kw):
    jparams, _ = weights
    return JEngine(JTransformer(JCFG), jparams,
                   pool=JPool(JPageSpec.for_model(JCFG, page_tokens=8),
                              pages),
                   max_batch=max_batch, max_seq=JCFG.max_seq, rank=rank,
                   **kw)


def _ref_drain(weights, prompts, n):
    """The reference engine's greedy tokens for each prompt."""
    eng = _jengine(weights)
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p, n)
    done = {e["rid"]: e["tokens"] for e in eng.drain() if e["kind"] == "done"}
    return [done[f"r{i}"] for i in range(len(prompts))]


# -- live clusters -------------------------------------------------------------
def _cluster(weights, n, worker_ranks=None, router_rank=None,
             commit_every=4, **router_kw):
    peers = start_local_cluster(n, devices=["cpu"])
    router_rank = n - 1 if router_rank is None else router_rank
    worker_ranks = (worker_ranks if worker_ranks is not None
                    else [r for r in range(n) if r != router_rank])
    servers = []
    for r in worker_ranks:
        eng = _engine(weights, rank=r)
        eng.warmup(prompt_lens=(4,))
        servers.append(trouter.ServeWorker(peers[r], eng,
                                           commit_every=commit_every).start())
    router = trouter.ServeRouter(peers[router_rank],
                                 worker_ranks=worker_ranks, **router_kw)
    return peers, servers, router


def _teardown(peers, servers, router):
    router.close()
    for s in servers:
        if not s.dead:
            s.stop()
    for p in peers:
        try:
            p.close()
        except Exception:  # noqa: BLE001 - dead peers already closed
            pass


class TestRemainingBudget:
    @pytest.mark.parametrize("max_new,committed,eos", [
        (10, [5, 6, 2], 2), (10, [5, 6, 2], None), (10, [5, 2, 6], 2),
        (10, [], 2), (3, [1, 2, 3], None), (4, [7], 7), (0, [], None)])
    def test_matches_reference(self, max_new, committed, eos):
        got = trouter.remaining_budget(max_new, committed, eos)
        assert got == jrouter.remaining_budget(max_new, committed, eos)

    def test_reference_cases(self):
        rb = trouter.remaining_budget
        assert rb(10, [5, 6, 2], eos_id=2) == 0
        assert rb(10, [5, 6, 2], eos_id=None) == 7
        assert rb(10, [5, 2, 6], eos_id=2) == 7
        assert rb(10, [], eos_id=2) == 10
        assert rb(3, [1, 2, 3], eos_id=None) == 0


# -- frames ----------------------------------------------------------------------
class _RecChan:
    """Records every send; the router's handler is kept to feed frames."""

    def __init__(self):
        self.sent = []
        self.handler = None

    def on_p2p_request(self, handler):
        self.handler = handler

    def send(self, peer, name, payload, conn_type=None, retries=None):
        self.sent.append((str(peer), name, bytes(payload), int(conn_type)))


def _rec_router(mod, peerlist, peerid):
    workers = peerlist.parse("127.0.0.1:20000,127.0.0.1:20001,"
                             "127.0.0.1:20002")
    chan = _RecChan()
    peer = SimpleNamespace(
        channel=chan, chaos_rank=lambda: 2,
        config=SimpleNamespace(cluster=SimpleNamespace(workers=workers),
                               self_id=peerid("127.0.0.1", 20002)))
    router = mod.ServeRouter(peer, worker_ranks=[0, 1], queue_depth=8,
                             deadline_s=60.0, watch_period_s=60.0)
    return router, chan


class TestFrames:
    def test_dispatch_progress_and_replay_frames(self, monkeypatch):
        """The same requests, progress and replays through both routers
        give the same frames, byte for byte."""
        logs = []
        for mod, tl, pl, pid in ((trouter, timeline, PeerList, PeerID),
                                 (jrouter, jtimeline, JPeerList, JPeerID)):
            seq = iter(range(1, 100))
            monkeypatch.setattr(tl, "new_span_id",
                                lambda seq=seq: f"s2.{next(seq)}")
            router, chan = _rec_router(mod, pl, pid)
            try:
                hs = [router.submit([1, 2, 3, i], 12, rid=f"q{i}")
                      for i in range(3)]
                # worker 0 commits four tokens of q0, then q0 replays
                w0 = "127.0.0.1:20000"
                chan.handler(f"{mod.PROG_PREFIX}q0",
                             b'{"rid": "q0", "att": 0, "tokens": '
                             b'[7, 8, 9, 10], "ttft_s": 0.01}', w0)
                router._replay(hs[0])
                # a late frame of the replayed-away attempt is rejected
                chan.handler(f"{mod.PROG_PREFIX}q0",
                             b'{"rid": "q0", "att": 0, "tokens": [1]}', w0)
                router.mark_worker_dead(1)
                logs.append((list(chan.sent),
                             [(h.worker, h.committed, h.replays)
                              for h in hs], router.dead_workers,
                             router.replayed))
            finally:
                router.close()
        assert logs[0] == logs[1]
        sent = logs[0][0]
        assert [s[1] for s in sent] == ["req.srv.q0", "req.srv.q1",
                                        "req.srv.q2", "req.srv.q0",
                                        "req.srv.q1"]
        assert b'"committed": [7, 8, 9, 10]' in sent[3][2]

    def test_timeline_marks_match(self, monkeypatch):
        """The router's ``request`` and ``serve`` marks keep the
        reference's kinds, names and fields (timings aside)."""
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        logs = []
        for mod, tl, pl, pid in ((trouter, timeline, PeerList, PeerID),
                                 (jrouter, jtimeline, JPeerList, JPeerID)):
            seq = iter(range(1, 100))
            monkeypatch.setattr(tl, "new_span_id",
                                lambda seq=seq: f"s2.{next(seq)}")
            tl.reset()
            router, chan = _rec_router(mod, pl, pid)
            try:
                hs = [router.submit([1, 2, i], 4, rid=f"m{i}")
                      for i in range(3)]
                router.queue_depth = 3
                with pytest.raises((ServeOverloadError,
                                    JServeOverloadError)):
                    router.submit([9], 4, rid="over")
                router._replay(hs[1])
                router.mark_worker_dead(0)
                router.admit_worker(0)
                done = {"rid": "m2", "att": hs[2].replays, "tokens": [5],
                        "ok": True}
                chan.handler(f"{mod.DONE_PREFIX}m2",
                             json.dumps(done).encode(),
                             str(router._addr[hs[2].worker]))
                assert hs[2].wait(1) == [5]
            finally:
                router.close()
            logs.append([(e["kind"], e["name"], e["rank"],
                          {k: v for k, v in e["attrs"].items()
                           if k != "e2e_ms"})
                         for e in tl.snapshot()
                         if e["kind"] in ("request", "serve")])
            tl.reset()
        assert logs[0] == logs[1]
        assert [(k, n) for k, n, _, _ in logs[0]] == [
            ("request", "accept")] * 3 + [
            ("request", "reject"), ("request", "replay"),
            ("serve", "worker-dead")] + [("request", "replay")] * 2 + [
            ("serve", "readmit"), ("request", "complete")]

    def test_completion_frame_settles_handle(self):
        router, chan = _rec_router(trouter, PeerList, PeerID)
        try:
            h = router.submit([4, 5], 3, rid="c0")
            chan.handler(f"{trouter.DONE_PREFIX}c0",
                         b'{"rid": "c0", "att": 0, "tokens": [1, 2, 3], '
                         b'"ok": true, "ttft_s": 0.5, "queue_s": 0.0, '
                         b'"reused_tokens": 0, "computed_tokens": 2}',
                         "127.0.0.1:20000")
            assert h.wait(1) == [1, 2, 3] and router.completed == 1
            assert h.ttft_s == 0.5 and h.stats["computed_tokens"] == 2
        finally:
            router.close()


class TestRouterLive:
    def test_completion_and_typed_overload(self, weights):
        peers, servers, router = _cluster(weights, 3, queue_depth=2,
                                          deadline_s=10.0)
        try:
            h1 = router.submit([1, 2, 3], 30)
            h2 = router.submit([4, 5, 6], 30)
            with pytest.raises(ServeOverloadError):
                router.submit([7, 8, 9], 30)
            want = _ref_drain(weights, [[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                              30)
            assert h1.wait(30) == want[0] and h2.wait(30) == want[1]
            assert router.submit([7, 8, 9], 5).wait(30) == want[2][:5]
            assert router.completed == 3 and router.dead_workers == []
        finally:
            _teardown(peers, servers, router)

    def test_worker_kill_replays_on_survivor(self, weights, monkeypatch):
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:step=6,rank=0,mode=raise")
        peers, servers, router = _cluster(weights, 3, deadline_s=2.0,
                                          strike_limit=2)
        prompts = [[9, 8, 7, i] for i in range(4)]
        try:
            hs = [router.submit(p, 40) for p in prompts]
            outs = [h.wait(30) for h in hs]
            assert router.dead_workers == [0] and servers[0].dead
            assert router.replayed >= 1
            assert any(h.replays and h.committed for h in hs)
            assert outs == _ref_drain(weights, prompts, 40)
        finally:
            _teardown(peers, servers, router)

    def test_slice_kill_excludes_whole_slice(self, weights, monkeypatch):
        monkeypatch.setenv("KF_CHAOS_SPEC",
                           "die_slice:slice=1,step=6,mode=raise,rps=2")
        peers, servers, router = _cluster(
            weights, 5, worker_ranks=[0, 1, 2, 3], router_rank=4,
            deadline_s=2.0, strike_limit=1, topology=SliceTopology(2, 2))
        prompts = [[3, 2, 1, i] for i in range(6)]
        try:
            outs = [h.wait(30) for h in [router.submit(p, 40)
                                         for p in prompts]]
            assert router.dead_workers == [2, 3]
            assert router.live_workers == [0, 1]
            assert servers[2].dead and servers[3].dead
            assert router.replayed >= 1
            assert outs == _ref_drain(weights, prompts, 40)
        finally:
            _teardown(peers, servers, router)

    def test_dropped_request_replays_without_killing_worker(
            self, weights, monkeypatch):
        monkeypatch.setenv("KF_CHAOS_SPEC", "drop_request:count=1")
        peers, servers, router = _cluster(weights, 2, deadline_s=1.0,
                                          strike_limit=2)
        try:
            h = router.submit([5, 4, 3], 6)
            assert h.wait(30) == _ref_drain(weights, [[5, 4, 3]], 6)[0]
            assert router.replayed == 1 and h.replays == 1
            assert router.dead_workers == []
        finally:
            _teardown(peers, servers, router)

    def test_all_workers_dead_is_typed_loss(self, weights, monkeypatch):
        monkeypatch.setenv("KF_CHAOS_SPEC", "die:step=6,rank=0,mode=raise")
        peers, servers, router = _cluster(weights, 2, commit_every=2,
                                          deadline_s=1.5, strike_limit=1)
        try:
            h = router.submit([1, 2, 3], 60)
            with pytest.raises(RequestLostError) as ei:
                h.wait(30)
            assert ei.value.rid == h.rid
            assert router.live_workers == []
            want = _ref_drain(weights, [[1, 2, 3]], 60)[0]
            got = ei.value.committed
            assert got == h.committed and got == want[:len(got)]
        finally:
            _teardown(peers, servers, router)


# -- a mixed port/reference pair ----------------------------------------------
def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _mixed_pair(attempts=5):
    """A reference peer (rank 0) and a port peer (rank 1) of one cluster."""
    for _ in range(attempts):
        ports = _free_ports(2)
        ref = mine = None
        try:
            ref = JPeer(jenvs.parse_config_from_env(
                envs.single_machine_env(0, 2, ports=ports)))
            ref.start()
            mine = Peer(envs.parse_config_from_env(
                envs.single_machine_env(1, 2, ports=ports)), devices=["cpu"])
            mine.start()
            return ref, mine
        except OSError as e:
            for p in (ref, mine):
                if p is not None:
                    p.close()
            if getattr(e, "errno", None) not in (None, errno.EADDRINUSE):
                raise
    raise OSError("no free ports for a mixed cluster")


class TestMixedPair:
    PROMPTS = [[2, 4, 6, i] for i in range(3)]

    def test_port_worker_behind_reference_router(self, weights):
        ref, mine = _mixed_pair()
        eng = _engine(weights, rank=1)
        worker = trouter.ServeWorker(mine, eng, commit_every=4).start()
        router = jrouter.ServeRouter(ref, worker_ranks=[1], deadline_s=10.0)
        try:
            outs = [h.wait(30) for h in [router.submit(p, 20)
                                         for p in self.PROMPTS]]
            assert outs == _ref_drain(weights, self.PROMPTS, 20)
            assert router.completed == 3 and router.dead_workers == []
        finally:
            router.close()
            worker.stop()
            mine.close()
            ref.close()

    def test_reference_worker_behind_port_router(self, weights):
        ref, mine = _mixed_pair()
        eng = _jengine(weights, rank=0)
        worker = jrouter.ServeWorker(ref, eng, commit_every=4).start()
        router = trouter.ServeRouter(mine, worker_ranks=[0], deadline_s=10.0)
        try:
            outs = [h.wait(30) for h in [router.submit(p, 20)
                                         for p in self.PROMPTS]]
            assert outs == _ref_drain(weights, self.PROMPTS, 20)
            assert router.completed == 3 and router.dead_workers == []
        finally:
            router.close()
            worker.stop()
            mine.close()
            ref.close()


# -- policies ----------------------------------------------------------------
def _observations(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        queued = int(rng.integers(0, 8))
        e2e = None if rng.random() < 0.1 else float(rng.uniform(0, 2500))
        active = int(rng.integers(0, 3))
        out.append((queued, e2e, active))
    return out


class TestServePolicies:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_batch_width_decisions(self, seed):
        runs = []
        for mod, slomod in ((tserve, slo), (jpolicy, jslo)):
            applied = []
            ctl = mod.BatchWidthController(
                lambda w: (applied.append(w) or max(1, min(w, 6))),
                lo=1, hi=6, start=3, targets=slomod.SLOTargets(e2e_s=1.0),
                widen_at_queue=3, cooldown_steps=1)
            widths = [ctl.observe(q, e) for q, e, _ in _observations(seed)]
            runs.append((applied, widths))
        assert runs[0] == runs[1]
        assert len(set(runs[0][1])) > 2

    @pytest.mark.parametrize("seed", [0, 1])
    def test_autoscale_decisions(self, seed):
        runs = []
        for mod, base, slomod in ((tserve, tbase, slo),
                                  (jpolicy, jbase, jslo)):
            pol = mod.ServeAutoscalePolicy(
                targets=slomod.SLOTargets(e2e_s=1.0), scale_up_queue=3,
                min_workers=1, max_workers=5, cooldown_steps=2)
            size, got = 2, []
            for i, (q, e, a) in enumerate(_observations(seed)):
                ctx = base.PolicyContext(cluster_size=size)
                if i % 2:
                    pol.observe_view({"serving": {
                        "queued": q, "active": a, "e2e_ms": e}})
                else:
                    ctx.metrics.update(serve_queued=q, serve_active=a,
                                       serve_e2e_ms=e)
                pol.after_step(ctx)
                got.append(ctx.requested_size)
                if ctx.requested_size is not None:
                    size = ctx.requested_size
            runs.append(got)
        assert runs[0] == runs[1]
        assert {None} < set(runs[0])

    def test_serve_signals_from_views(self):
        rng = np.random.default_rng(3)
        views = [{"serving": None}, {}, {"serving": {}}]
        for _ in range(200):
            srv = {k: int(rng.integers(0, 9)) for k in (
                "active", "queued", "completed", "replayed", "kv_bytes")}
            srv["ttft_ms"] = float(rng.uniform(0, 900))
            srv["e2e_ms"] = None if rng.random() < 0.2 else float(
                rng.uniform(0, 9000))
            views.append({"serving": srv})
        for v in views:
            assert tserve.serve_signals(v) == jpolicy.serve_signals(v)

    def test_exported_from_the_package(self):
        assert tpolicy.BatchWidthController is tserve.BatchWidthController
        assert tpolicy.ServeAutoscalePolicy is tserve.ServeAutoscalePolicy
        assert tpolicy.serve_signals is tserve.serve_signals


# -- the fleet -------------------------------------------------------------------
class _StubSlicePeer:
    def __init__(self, workers):
        self.config = SimpleNamespace(
            cluster=SimpleNamespace(workers=workers),
            self_id=workers[4], config_server="")

    def slice_topology(self):
        return None

    def chaos_rank(self):
        return 4

    def rank(self):
        return 4


class _StubSliceRouter:
    """A slice-aware router's exclusion: the whole slice goes."""

    def __init__(self, peer, live, topology):
        self.peer = peer
        self.topology = topology
        self._live = set(live)
        self.busy: set = set()
        self.replays = 0

    @property
    def live_workers(self):
        return sorted(self._live)

    def outstanding(self, r):
        return 1 if r in self.busy else 0

    def mark_worker_dead(self, r, readmit=True):
        s = self.topology.slice_of(r)
        ex = [x for x in self.topology.ranks_in(s) if x in self._live]
        if any(x in self.busy for x in ex):
            self.replays += 1
        self._live -= set(ex)
        return ex

    def admit_worker(self, r):
        self._live.add(r)
        return True


class _W:
    dead = False

    def stop(self):
        self.dead = True


class TestServeFleet:
    @pytest.mark.parametrize("busy", [{2}, {1, 2}, set()])
    def test_slice_scale_in_matches_reference(self, busy):
        runs = []
        for mod, pl, pid, topo, plan in (
                (tscale, PeerList, PeerID, SliceTopology(2, 2), ParallelPlan),
                (jscale, JPeerList, JPeerID, JSliceTopology(2, 2), JPlan)):
            workers = pl.of(*(pid("127.0.0.1", 20000 + i) for i in range(5)))
            router = _StubSliceRouter(_StubSlicePeer(workers), [0, 1, 2, 3],
                                      topo)
            router.busy = set(busy)
            fleet = mod.ServeFleet(router, None, lambda r: _W(),
                                   plan=plan(dp=2))
            fleet.workers = {r: _W() for r in (0, 1, 2, 3)}
            fleet.scale_to(2)
            runs.append((router.live_workers, router.replays,
                         sorted(fleet.workers)))
        assert runs[0] == runs[1]
        assert runs[0][1] == 0
        if busy == {2}:
            assert runs[0][0] == [2, 3]

    def test_plan_guard(self):
        router = SimpleNamespace(peer=None)
        for bad, exc in ((dict(pp=2), ValueError),
                         (dict(zero_stage=1), ValueError)):
            with pytest.raises(exc):
                tscale.ServeFleet(router, None, lambda r: None,
                                  plan=ParallelPlan(**bad))
            with pytest.raises(exc):
                jscale.ServeFleet(router, None, lambda r: None,
                                  plan=JPlan(**bad))

    def test_intent_spawns_real_worker(self, weights):
        peers = start_local_cluster(3, devices=["cpu"])
        spawned = {}
        router = None

        def spawn(rank):
            eng = _engine(weights, rank=rank, max_batch=2,
                          plan=ParallelPlan(dp=1))
            eng.warmup(prompt_lens=(4,))
            w = trouter.ServeWorker(peers[rank], eng,
                                    commit_every=2).start()
            spawned[rank] = w
            return w

        try:
            router = trouter.ServeRouter(peers[2], worker_ranks=[0],
                                         queue_depth=8, deadline_s=10.0)
            spawn(0)
            fleet = tscale.ServeFleet(
                router, tserve.ServeAutoscalePolicy(
                    targets=slo.SLOTargets(ttft_s=0.5, e2e_s=1.0),
                    scale_up_queue=2, cooldown_steps=0),
                spawn, plan=ParallelPlan(dp=1))
            assert fleet.live() == [0]
            assert fleet.tick(serve_queued=4, serve_e2e_ms=5000.0) == [1]
            assert router.live_workers == [0, 1]
            assert 1 in spawned and not spawned[1].dead
            # the least-outstanding pick sends the next request to 1
            router._outstanding[0] = 5
            h = router.submit([1, 2, 3], 8)
            assert h.wait(30) == _ref_drain(weights, [[1, 2, 3]], 8)[0]
            assert h.worker == 1
            router._outstanding[0] = 0
            assert fleet.tick(serve_queued=0, serve_e2e_ms=10.0) == []
            assert router.live_workers == [0] and spawned[1].dead is False
            assert 1 not in fleet.workers
        finally:
            for w in spawned.values():
                if not w.dead:
                    w.stop()
            if router is not None:
                router.close()
            for p in peers:
                p.close()


# -- KV snapshots across the packages ------------------------------------------
_SPEC = dict(n_layers=2, n_heads=2, head_dim=4, page_tokens=4)


def _pools(dtype):
    return (KVCachePool(PageSpec(**_SPEC, dtype=dtype), capacity_pages=8),
            JPool(JPageSpec(**_SPEC, dtype=dtype), capacity_pages=8))


def _fill(pools, dtype, tokens, seed=0):
    """The same committed pages (bit for bit) in a port and a reference
    pool; bf16 data is made as 16-bit patterns."""
    rng = np.random.default_rng(seed)
    shape = (_SPEC["n_layers"], _SPEC["n_heads"], _SPEC["page_tokens"],
             _SPEC["head_dim"])
    n_pages = len(tokens) // _SPEC["page_tokens"]
    data = []
    for _ in range(n_pages):
        kv = []
        for _ in range(2):
            x = rng.standard_normal(shape).astype(np.float32)
            if dtype == "bfloat16":
                x = x.astype(ml_dtypes.bfloat16)
            kv.append(x)
        data.append(kv)
    tpool, jpool = pools
    for pool, conv in ((tpool, _to_torch), (jpool, lambda a: a)):
        pages = pool.alloc(n_pages)
        for pid, (k, v) in zip(pages, data):
            pool.put_page_data(pid, conv(k), conv(v))
        pool.commit_chain(tokens, pages)
        pool.release(pages)
    return data


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t):
    """A port snapshot entry as the reference reads it: bf16 travels as
    its 16-bit patterns, viewed as ml_dtypes' bfloat16."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return t


def _bits(a):
    return np.asarray(_to_numpy(a)).tobytes()


class TestKVSnapshotInterop:
    TOKENS = list(range(1, 13))  # three full pages of four

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_snapshots_equal(self, dtype):
        pools = _pools(dtype)
        _fill(pools, dtype, self.TOKENS)
        tsnap, jsnap = (p.snapshot_committed() for p in pools)
        assert sorted(tsnap) == sorted(jsnap)
        for name in jsnap:
            assert _bits(tsnap[name]) == _bits(jsnap[name]), name

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_restore_either_way_bitwise(self, dtype):
        pools = _pools(dtype)
        data = _fill(pools, dtype, self.TOKENS)
        tsnap, jsnap = (p.snapshot_committed() for p in pools)
        tfresh, jfresh = _pools(dtype)
        assert tfresh.restore_committed(jsnap) == (3, 0)
        assert jfresh.restore_committed(
            {k: _to_numpy(v) for k, v in tsnap.items()}) == (3, 0)
        for pool, conv in ((tfresh, _to_numpy), (jfresh, lambda a: a)):
            pages, n = pool.lookup(self.TOKENS)
            assert n == 12
            for pid, (k, v) in zip(pages, data):
                gk, gv = pool.page_data(pid)
                assert _bits(conv(gk)) == k.tobytes()
                assert _bits(conv(gv)) == v.tobytes()
            pool.release(pages)

    def test_bf16_patterns_restore(self):
        pools = _pools("bfloat16")
        _fill(pools, "bfloat16", self.TOKENS)
        jsnap = pools[1].snapshot_committed()
        patterns = {k: (v.view(np.uint16) if v.dtype.name == "bfloat16"
                        else v) for k, v in jsnap.items()}
        fresh, _ = _pools("bfloat16")
        assert fresh.restore_committed(patterns) == (3, 0)

    @pytest.mark.parametrize("fault", ["content", "digest", "prefix",
                                       "shape", "missing", "full"])
    def test_torn_and_corrupt_pages(self, fault):
        pools = _pools("float32")
        _fill(pools, "float32", self.TOKENS)
        snap = {k: np.array(_to_numpy(v)) for k, v in
                pools[1].snapshot_committed().items()}
        if fault == "content":
            snap["kv1_k"] = snap["kv1_k"] + np.float32(1e-3)
        elif fault == "digest":
            snap["kv0_c"][0] ^= 1
        elif fault == "prefix":
            snap["kv2_p"] = snap["kv2_p"][:-1]
        elif fault == "shape":
            snap["kv0_v"] = snap["kv0_v"][:, :1]
        elif fault == "missing":
            del snap["kv1_v"]
        got = []
        for fresh in _pools("float32"):
            if fault == "full":  # only live pages left: never stolen
                fresh.alloc(fresh.capacity)
            got.append(fresh.restore_committed(dict(snap)))
        assert got[0] == got[1]
        assert got[0][1] >= 1

    def test_idempotent_restore(self):
        pools = _pools("float32")
        _fill(pools, "float32", self.TOKENS)
        snap = pools[0].snapshot_committed()
        fresh, _ = _pools("float32")
        assert fresh.restore_committed(snap) == (3, 0)
        free = fresh.free_pages
        assert fresh.restore_committed(snap) == (3, 0)
        assert fresh.free_pages == free and fresh.stats()["cached"] == 3
        assert fresh.live_refs() == {}

    def test_warm_cache_through_cold_restart(self, weights, tmp_path):
        """tests/test_persist.py:375 on the port: the snapshot rides the
        port's persist plane to disk, the reference's restore reads the
        manifest, and both packages' fresh engines answer the same
        prompt with both full pages reused and the same tokens."""
        prompt = list(range(1, 20))  # 19 tokens: two full pages of 8
        old = _engine(weights, pages=64)
        old.submit("before", prompt, 6)
        ref = [e for e in old.drain() if e["kind"] == "done"][0]
        assert ref["tokens"] == _ref_drain(weights, [prompt], 6)[0]
        plane = persist.PersistPlane(str(tmp_path), 0, period_s=0.0)
        mdir = plane.persist_async(
            3, replicated=old.pool.snapshot_committed()).wait(30)
        plane.close()
        snaps = (persist.restore_from_manifest(mdir, 0, 1).replicated,
                 jpersist.restore_from_manifest(mdir, 0, 1).replicated)
        outs = []
        for eng, snap in ((_engine(weights, pages=64), snaps[0]),
                          (_jengine(weights, pages=64), snaps[1])):
            # the 24 tokens that ran the stack fill three pages
            assert eng.pool.restore_committed(snap) == (3, 0)
            eng.submit("after", prompt, 6)
            outs.append([e for e in eng.drain() if e["kind"] == "done"][0])
        for done in outs:
            assert done["reused_tokens"] == 16
            assert done["tokens"] == ref["tokens"]


# -- engine scheduling surface, SLO rules, knobs -------------------------------
class TestEngineSurface:
    def test_width_and_wait_for_work(self, weights):
        t, j = _engine(weights), _jengine(weights)
        for eng in (t, j):
            assert eng.width == 4
            assert eng.set_width(9) == 4 and eng.set_width(2) == 2
            assert eng.width == 2
            t0 = time.perf_counter()
            assert eng.wait_for_work(0.05) is False
            assert time.perf_counter() - t0 >= 0.04
            eng.submit("w", [1, 2, 3], 2)
            assert eng.wait_for_work(0.0) is True
            eng.drain()

    @pytest.mark.parametrize("plan,exc", [
        (dict(pp=2), NotImplementedError),
        (dict(tp=2), NotImplementedError),
        (dict(sp=2), NotImplementedError),
        (dict(zero_stage=2), ValueError),
        (dict(dp=4), None)])
    def test_plan_guard(self, weights, plan, exc):
        for make, cls in ((_engine, ParallelPlan), (_jengine, JPlan)):
            value = cls(**plan)
            if exc is None:
                assert make(weights, plan=value).plan is value
            else:
                with pytest.raises(exc):
                    make(weights, plan=value)


class TestSLOAndKnobs:
    @pytest.mark.parametrize("env", [{}, {
        "KF_SERVE_SLO_TTFT_MS": "250", "KF_SERVE_SLO_E2E_MS": "900",
        "KF_SENTINEL_SLO_SHORT": "3", "KF_SENTINEL_SLO_LONG": "11"}])
    def test_slo_rules(self, monkeypatch, env):
        for k in ("KF_SERVE_SLO_TTFT_MS", "KF_SERVE_SLO_E2E_MS",
                  "KF_SENTINEL_SLO_SHORT", "KF_SENTINEL_SLO_LONG"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got, want = slo.SLORules.from_env(), jslo.SLORules.from_env()
        assert vars(got) == vars(want)
        assert got.budgets() == want.budgets()
        assert slo.SLORules().budgets() == {"ttft_ms": 500.0,
                                            "e2e_ms": 5000.0}

    def test_knobs_and_defaults(self):
        for name in ("SERVE_QUEUE_DEPTH", "SERVE_MAX_TOKENS",
                     "SERVE_COMMIT_EVERY", "SERVE_REQUEST_DEADLINE",
                     "MONITOR_PUSH_PERIOD", "MONITOR_STALE_AFTER",
                     "XRAY_WINDOW_STEPS", "SENTINEL_SLO_SHORT",
                     "SENTINEL_SLO_LONG"):
            assert getattr(envs, name) == getattr(jenvs, name)
        for name in ("DEFAULT_QUEUE_DEPTH", "DEFAULT_COMMIT_EVERY",
                     "DEFAULT_DEADLINE_S", "SEND_RETRIES", "REQ_PREFIX",
                     "PROG_PREFIX", "DONE_PREFIX"):
            assert getattr(trouter, name) == getattr(jrouter, name)
        assert trouter.ServeWorker.KEEPALIVE_S == \
            jrouter.ServeWorker.KEEPALIVE_S
        for name in ("E2E_HIST", "QUEUE_GAUGE", "REQUESTS_COUNTER"):
            assert getattr(slo, name) == getattr(jslo, name)

    def test_e2e_and_queue_metrics(self):
        from kungfu_tpu_torch.monitor.registry import REGISTRY

        before = REGISTRY.histogram(slo.E2E_HIST).summary()["count"]
        slo.observe_e2e(0.25)
        slo.note_queue_depth(3)
        assert REGISTRY.histogram(slo.E2E_HIST).summary()["count"] == \
            before + 1
        assert REGISTRY.gauge(slo.QUEUE_GAUGE).value == 3

    def test_request_lost_error_carries_tokens(self):
        e, je = RequestLostError("r", [1, 2]), JRequestLostError("r", [1, 2])
        assert (e.rid, e.committed, str(e)) == (je.rid, je.committed,
                                                 str(je))
