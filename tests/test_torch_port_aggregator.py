"""Port parity: the live cluster plane (``monitor/aggregator.py``,
``monitor/xray.py``, the config server's ``/push`` and ``/cluster``, the
peer's rank reporter) against the JAX package.

* the same snapshots and control events ingested by both aggregators
  give equal ``cluster_view``s (serving, pulse, skew, straggler, xray,
  slices, controls), apart from the wall-clock fields (``wall``,
  ``age_s``);
* staleness under one fake clock, the shrink eviction, malformed pushes;
* the xray attribution, verdict, critical path and report over seeded
  events, equal to the reference's;
* ``RankReporter.snapshot_once`` carries ``kf_kv_cache_bytes`` and the
  serve histograms (``tests/test_serve.py:448``), and the delta and
  carry-over rules of a failed push;
* ``/push`` -> ``/cluster`` through the port's config server, from a
  port and from a reference reporter, and a port reporter pushing to the
  reference's server;
* a peer with ``KF_CONFIG_ENABLE_CLUSTER_MONITOR=1`` reporting on the
  CPU, ``post_control_if_enabled`` and ``publish_device_memory``.

Every server binds port 0.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kungfu_tpu.elastic.configserver import ConfigServer as JConfigServer
from kungfu_tpu.models.transformer import Transformer as JTransformer
from kungfu_tpu.models.transformer import TransformerConfig as JConfig
from kungfu_tpu.monitor import aggregator as jagg
from kungfu_tpu.monitor import xray as jxray
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.models.transformer import Transformer, TransformerConfig
from kungfu_tpu_torch.monitor import aggregator as tagg
from kungfu_tpu_torch.monitor import metrics
from kungfu_tpu_torch.monitor import xray as txray
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.peer import start_local_cluster
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.serve.engine import InferenceEngine
from kungfu_tpu_torch.serve.kvcache import KVCachePool, PageSpec

#: the wall-clock fields of a view: everything else must match
WALL_FIELDS = ("wall", "age_s")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("KF_CONFIG_ENABLE_CLUSTER_MONITOR", "KF_CONFIG_ENABLE_MONITORING",
              "KF_CONFIG_MONITOR_PUSH_PERIOD", "KF_CONFIG_MONITOR_STALE_AFTER",
              "KF_XRAY_WINDOW_STEPS", "MEGASCALE_SLICE_ID",
              "MEGASCALE_NUM_SLICES", "KF_CHAOS_SPEC"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL_FIELDS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _events(seed, ranks=4, steps=6):
    """Seeded flight-recorder events of every kind the view reads."""
    rng = np.random.default_rng(seed)
    out = []
    t = 100.0
    for step in range(steps):
        for r in range(ranks):
            ts = t + r * 1e-3
            for tag, op in (("grads", "all_reduce"), ("bucket0", "rs")):
                dur = float(rng.uniform(0.01, 0.05)) * (3 if r == 2 else 1)
                out.append({"ts": ts, "rank": r, "step": step,
                            "kind": "collective", "name": tag, "dur": dur,
                            "attrs": {"op": op, "tag": tag}})
                ts += dur + 0.002
            out.append({"ts": ts, "rank": r, "step": step, "kind": "input",
                        "name": "next", "dur": 0.004, "attrs": {}})
            if step % 2:
                out.append({"ts": ts, "rank": r, "step": step, "kind": "pp",
                            "name": "bubble", "dur": 0.003, "attrs": {}})
                out.append({"ts": ts, "rank": r, "step": step,
                            "kind": "overlap", "name": "issue", "dur": 0.0,
                            "attrs": {"tag": "bucket0"}})
            if rng.random() < 0.2:
                out.append({"ts": ts, "rank": r, "step": step,
                            "kind": "chaos", "name": "delay", "dur": 0.0,
                            "attrs": {"ms": 5}})
            out.append({"ts": ts, "rank": r,
                        "step": step, "kind": "device", "name": "psum",
                        "dur": float(rng.uniform(0.001, 0.002)),
                        "attrs": {"op": "psum", "tag": "loss"}})
        t += 0.5
    return out


def _snapshots(mod, seed=0, ranks=4):
    rng = np.random.default_rng(seed)
    events = _events(seed, ranks=ranks)
    snaps = []
    for r in range(ranks):
        gauges = {"kf_serve_active_requests": float(rng.integers(0, 4)),
                  "kf_serve_queue_depth": float(rng.integers(0, 9)),
                  "kf_kv_cache_bytes": float(rng.integers(1, 9) * 4096),
                  "kf_gns": 12.5 + r, "kf_grad_variance": 0.25,
                  'kf_grad_norm{group="attn"}': 1.0 + r,
                  'kf_grad_norm{group="mlp"}': 2.0,
                  "kf_mfu": 0.3 + 0.01 * r, "kf_model_flops_s": 1e12,
                  'kf_step_phase_seconds{phase="compute"}': 0.2 + r}
        counters = {'kf_serve_requests_total{what="complete"}': 5 + r,
                    'kf_serve_requests_total{what="replay"}': r,
                    'kf_serve_requests_total{what="reject"}': 1,
                    "kf_timeline_dropped_total": r % 2}
        latency = {"kf_serve_ttft_seconds": {"count": 3, "sum": 0.3 + r},
                   "kf_serve_e2e_seconds": {"count": 2, "sum": 1.5}}
        snaps.append(mod.make_snapshot(
            rank=r, slice=r // 2, pid=1000 + r, wall=50.0 + r,
            step=7, step_time_s=0.5, counters=counters, gauges=gauges,
            latency=latency,
            # rank 3's reporter forwards unstamped events: the
            # aggregator stamps them with the snapshot's rank
            events=[dict(e, rank=None) if r == 3 else e
                    for e in events if e["rank"] == r],
            net={"egress_bytes": 10 * r, "ingress_bytes": 5},
            strategy="STAR"))
    return snaps


CLUSTER_INFO = {"version": 3, "size": 4,
                "workers": [f"127.0.0.1:{10000 + i}" for i in range(4)]}


class TestSchema:
    def test_constants_match(self):
        for name in ("SNAPSHOT_FIELDS", "VIEW_FIELDS", "WIRE_VERSION",
                     "REPORT_KINDS", "DEFAULT_PUSH_PERIOD_S", "STALE_PERIODS",
                     "MIN_PUSH_PERIOD_S", "ENABLE_ENV", "PUSH_PERIOD_ENV",
                     "STALE_AFTER_ENV"):
            assert getattr(tagg, name) == getattr(jagg, name), name
        assert txray.XRAY_KINDS == jxray.XRAY_KINDS
        assert txray.PHASES == jxray.PHASES
        assert tagg.REPORT_KINDS >= txray.XRAY_KINDS

    def test_make_snapshot_field_and_sum(self):
        snap = tagg.make_snapshot(rank=1, step=3)
        assert snap == jagg.make_snapshot(rank=1, step=3)
        with pytest.raises(ValueError, match="unknown snapshot field"):
            tagg.make_snapshot(rank=1, bogus=2)
        m = {"a": 1, 'a{x="1"}': 2, "ab": 4}
        assert tagg.sum_metric(m, "a") == jagg.sum_metric(m, "a") == 3
        assert tagg.field({"step": 4}, "step") == 4

    @pytest.mark.parametrize("url", [
        "http://h:9100/get", "h:9100", "https://h:1/x/y/", "127.0.0.1:7/get"])
    def test_server_base(self, url):
        assert tagg.server_base(url) == jagg.server_base(url)

    @pytest.mark.parametrize("env", [{}, {"KF_CONFIG_MONITOR_PUSH_PERIOD":
                                          "0.01"},
                                     {"KF_CONFIG_MONITOR_PUSH_PERIOD": "-1",
                                      "KF_CONFIG_MONITOR_STALE_AFTER": "7"},
                                     {"KF_CONFIG_MONITOR_PUSH_PERIOD": "x"}])
    def test_period_and_staleness_knobs(self, monkeypatch, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tagg.push_period_from_env() == jagg.push_period_from_env()
        assert tagg.stale_after_from_env() == jagg.stale_after_from_env()

    def test_control_event(self):
        c, j = (m.control_event("shrink", rank=2, dead=[3])
                for m in (tagg, jagg))
        assert _strip(c) == _strip(j) and c["attrs"] == {"dead": [3]}


class TestClusterView:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_views_equal(self, seed):
        views = []
        for mod in (tagg, jagg):
            agg = mod.ClusterAggregator(stale_after=60.0)
            for snap in _snapshots(mod, seed):
                agg.ingest(json.loads(json.dumps(snap)))
            agg.ingest({**mod.control_event("resize", rank=0, version=3),
                        "wall": 1.0})
            views.append(agg.cluster_view(CLUSTER_INFO))
        got, want = (_strip(v) for v in views)
        assert got == want
        for section in ("serving", "pulse", "xray", "skew", "straggler",
                        "slowest_per_step", "slices", "controls"):
            assert got[section], section
        assert got["serving"]["kv_bytes"] == sum(
            int(s["gauges"]["kf_kv_cache_bytes"])
            for s in _snapshots(tagg, seed))
        assert got["cluster"]["quorum_margin"] == 1

    def test_staleness_shrink_and_bad_pushes(self):
        views = []
        for mod in (tagg, jagg):
            clock = [0.0]
            agg = mod.ClusterAggregator(stale_after=3.0,
                                        time_fn=lambda c=clock: c[0])
            snaps = _snapshots(mod, 4)
            for i, snap in enumerate(snaps):
                clock[0] = float(i)
                agg.ingest(snap)
            clock[0] = 5.5
            stale = agg.stale_ranks()
            agg.ingest({**mod.control_event("shrink", rank=0, dead=[3, "x"]),
                        "wall": 2.0})
            for bad in ([1], {"kfmon": 1, "rank": "a"}, {"x": 1},
                        {"kfmon": 1, "rank": 1, "bogus": 0}):
                with pytest.raises(ValueError):
                    agg.ingest(bad)
            views.append((stale, agg.stale_ranks(),
                          agg.cluster_view(CLUSTER_INFO)))
        assert views[0] == views[1]
        assert views[0][0] == [0, 1, 2]  # 5.5 - seen > 3
        assert [r["rank"] for r in views[0][2]["ranks"]] == [0, 1, 2]
        assert views[0][2]["slices"][0]["all_stale"] is True

    def test_empty_view_has_no_sections(self):
        v = _strip(tagg.ClusterAggregator().cluster_view())
        assert v == _strip(jagg.ClusterAggregator().cluster_view())
        assert v["serving"] is None and v["xray"] is None

    def test_a9_parts_raise(self):
        """The Prometheus rendering came with A9a and is the reference's
        byte for byte (the pushed cases are in
        test_torch_port_metrics.py); the sentinel came with A9b and no
        longer raises: attached, it adds the alerts section (its cases
        are in test_torch_port_sentinel.py)."""
        agg = tagg.ClusterAggregator()
        assert agg.render_prometheus() == \
            jagg.ClusterAggregator().render_prometheus()
        assert agg.render_prometheus(CLUSTER_INFO) == \
            jagg.ClusterAggregator().render_prometheus(CLUSTER_INFO)

        class _Stub:
            def alerts_view(self):
                return {"active": ["watermark:mfu"]}

        assert "alerts" not in agg.cluster_view()
        agg.attach_sentinel(_Stub())
        assert agg.cluster_view()["alerts"] == {"active": ["watermark:mfu"]}
        assert "kf_cluster_alerts_active 1" in agg.render_prometheus()


class TestXray:
    @pytest.mark.parametrize("seed", [0, 1, 5])
    def test_attribution_matches(self, seed):
        ev = _events(seed)
        assert txray.step_attribution(ev) == jxray.step_attribution(ev)
        assert txray.verdict(ev) == jxray.verdict(ev)
        for step in (None, 1, 2):
            assert (txray.critical_path(ev, step)
                    == jxray.critical_path(ev, step))
        assert txray.online_view(ev, 3) == jxray.online_view(ev, 3)
        assert txray.render_report(ev) == jxray.render_report(ev)
        r = ev[0]["rank"]
        mine = [e for e in ev if e["rank"] == r]
        assert txray.rank_phase_split(mine) == jxray.rank_phase_split(mine)

    def test_window_env(self, monkeypatch):
        monkeypatch.setenv("KF_XRAY_WINDOW_STEPS", "2")
        assert txray.window_steps_from_env() == 2
        ev = _events(0)
        assert txray.online_view(ev) == jxray.online_view(ev)
        assert len(txray.online_view(ev)["steps"]) == 2
        assert txray.online_view([]) is None


class TestRankReporter:
    def test_snapshot_carries_kv_gauge_and_serve_histograms(self):
        """tests/test_serve.py:448 on the port."""
        cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=2, d_ff=64, max_seq=128,
                                dtype="float32")
        jparams = JTransformer(JConfig(**vars(cfg))).init(
            jax.random.PRNGKey(0))
        params = interop.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        eng = InferenceEngine(
            Transformer(cfg), params,
            pool=KVCachePool(PageSpec.for_model(cfg, page_tokens=8), 128),
            max_batch=4, max_seq=128)
        rep = tagg.RankReporter(rank=0, server_url="http://127.0.0.1:1",
                                slice_id=None)
        rep.snapshot_once()  # the histogram baselines
        eng.submit("obs", [1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
        eng.drain()
        footprint = eng.pool.footprint_bytes
        snap = rep.snapshot_once()
        assert tagg.field(snap, "gauges")["kf_kv_cache_bytes"] == footprint
        agg = tagg.ClusterAggregator(stale_after=60.0)
        agg.ingest(snap)
        view = agg.cluster_view()
        srv = tagg.field(view, "serving")
        assert tagg.field(srv, "kv_bytes") == footprint > 0
        lat = tagg.field(tagg.field(view, "ranks")[0], "latency")
        assert lat["kf_serve_ttft_seconds"]["count"] == 1
        assert any(k.startswith("kf_serve_token_seconds") for k in lat)
        # deltas: nothing new, no latency entries
        assert "kf_serve_ttft_seconds" not in rep.snapshot_once()["latency"]

    def test_failed_push_carries_its_window(self):
        events = [[{"ts": 1.0, "rank": 0, "step": 1, "kind": "collective",
                    "name": "g", "dur": 0.1, "attrs": {}}], []]
        rep = tagg.RankReporter(rank=0, server_url="http://127.0.0.1:1",
                                slice_id=None, period=0.05,
                                events_fn=lambda: events.pop(0))
        assert rep.push_once() is False
        snap = rep.snapshot_once()
        assert [e["name"] for e in snap["events"]] == ["g"]

    def test_slice_from_env(self, monkeypatch):
        monkeypatch.setenv("MEGASCALE_SLICE_ID", "1")
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        for mod in (tagg, jagg):
            assert mod.RankReporter(0, "h:1").slice_id == 1
            assert mod.RankReporter(0, "h:1", slice_id=None).slice_id is None

    def test_step_time_ema(self):
        got = []
        for mod in (tagg, jagg):
            rep = mod.RankReporter(0, "h:1", slice_id=None)
            got.append([rep._step_time(s, t) for s, t in (
                (-1, 0.0), (0, 1.0), (2, 2.0), (5, 3.5), (3, 4.0),
                (4, 4.6))])
        assert got[0] == got[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return json.loads(r.read())


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.read()


class TestConfigServerMounts:
    def test_push_then_cluster(self):
        workers = PeerList.parse("127.0.0.1:10000,127.0.0.1:10001")
        srv = ConfigServer(port=0, cluster=Cluster(PeerList.parse(
            "127.0.0.1:10099"), workers),
            aggregator=tagg.ClusterAggregator(stale_after=60.0)).start()
        try:
            assert tagg.RankReporter(0, srv.url, slice_id=None).push_once()
            assert jagg.RankReporter(1, srv.url, slice_id=None).push_once()
            assert tagg.post_control(srv.url, "resize", rank=0, version=1)
            view = _get(srv.port, "/cluster")
            assert [r["rank"] for r in view["ranks"]] == [0, 1]
            assert view["cluster"]["size"] == 2
            assert view["cluster"]["workers"] == [str(w) for w in workers]
            assert view["controls"][-1]["kind"] == "resize"
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, "/push", {"kfmon": 1})
            assert e.value.code == 400
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
                assert r.status == 200
                assert "kf_cluster_ranks 2" in r.read().decode()
            for route in ("/alerts", "/decisions"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(srv.port, route)
                assert e.value.code == 404
            assert _get(srv.port, "/get")["version"] == 0
        finally:
            srv.stop()

    def test_no_aggregator_404(self):
        srv = ConfigServer(port=0).start()
        try:
            for call in (lambda: _get(srv.port, "/cluster"),
                         lambda: _post(srv.port, "/push", {"kfmon": 1})):
                with pytest.raises(urllib.error.HTTPError) as e:
                    call()
                assert e.value.code == 404
            assert not tagg.RankReporter(0, srv.url,
                                         slice_id=None).push_once()
        finally:
            srv.stop()

    def test_port_reporter_to_reference_server(self):
        srv = JConfigServer(port=0,
                            aggregator=jagg.ClusterAggregator()).start()
        try:
            assert tagg.RankReporter(3, srv.url, slice_id=2).push_once()
            view = _get(srv.port, "/cluster")
            assert view["ranks"][0]["rank"] == 3
            assert view["slices"] == [{"slice": 2, "ranks": [3],
                                       "stale": [], "all_stale": False}]
        finally:
            srv.stop()


class TestPeerReporter:
    def test_cluster_monitor_peers_report(self, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_CLUSTER_MONITOR", "1")
        monkeypatch.setenv("KF_CONFIG_MONITOR_PUSH_PERIOD", "0.05")
        srv = ConfigServer(port=0, aggregator=tagg.ClusterAggregator(
            stale_after=60.0)).start()
        peers = []
        try:
            peers = start_local_cluster(
                2, env={"KF_CONFIG_SERVER": srv.url}, devices=["cpu"])
            assert all(p._reporter is not None for p in peers)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                view = _get(srv.port, "/cluster")
                if [r["rank"] for r in view["ranks"]] == [0, 1]:
                    break
                time.sleep(0.05)
            assert [r["rank"] for r in view["ranks"]] == [0, 1]
            assert view["ranks"][0]["strategy"]
            from kungfu_tpu_torch.monitor.aggregator import \
                post_control_if_enabled

            assert post_control_if_enabled(peers[0], "resize", version=2)
            for p in peers:
                p.close()
            assert all(p._reporter is None for p in peers)
            view = _get(srv.port, "/cluster")
            assert view["controls"][-1]["kind"] == "resize"
            assert view["controls"][-1]["rank"] == 0
        finally:
            for p in peers:
                p.close()
            srv.stop()

    def test_co_resident_workers_report_their_own_pools(self, monkeypatch):
        """Peers of one process share one registry: each serving rank's
        snapshot carries its own pool's ``kf_kv_cache_bytes``, a rank
        without a worker none, so the view sums each pool once."""
        import torch

        from kungfu_tpu_torch.serve.router import ServeWorker

        monkeypatch.setenv("KF_CONFIG_ENABLE_CLUSTER_MONITOR", "1")
        monkeypatch.setenv("KF_CONFIG_MONITOR_PUSH_PERIOD", "60")
        cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=2, d_ff=64, max_seq=128,
                                dtype="float32")
        model = Transformer(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        engines = []
        for n in (9, 40):  # one and three pages of eight tokens committed
            eng = InferenceEngine(
                model, params,
                pool=KVCachePool(PageSpec.for_model(cfg, page_tokens=8), 64),
                max_batch=2, max_seq=128)
            eng.submit("r", list(range(1, n + 1)), 4)
            eng.drain()
            engines.append(eng)
        pools = [e.pool.footprint_bytes for e in engines]
        assert 0 < pools[0] < pools[1]
        srv = ConfigServer(port=0, aggregator=tagg.ClusterAggregator(
            stale_after=60.0)).start()
        peers, workers = [], []
        try:
            peers = start_local_cluster(
                3, env={"KF_CONFIG_SERVER": srv.url}, devices=["cpu"])
            workers = [ServeWorker(p, e).start()
                       for p, e in zip(peers, engines)]

            def kv(p):
                return p._reporter.snapshot_once()["gauges"].get(
                    "kf_kv_cache_bytes")

            snaps = [p._reporter.snapshot_once() for p in peers]
            assert [s["gauges"].get("kf_kv_cache_bytes") for s in snaps] == [
                pools[0], pools[1], None]
            agg = tagg.ClusterAggregator(stale_after=60.0)
            for s in snaps:
                agg.ingest(s)
            assert agg.cluster_view()["serving"]["kv_bytes"] == sum(pools)
            workers[1].stop()
            assert [kv(p) for p in peers] == [pools[0], None, None]
            workers[0].stop()
            # no owner left: every rank reports the process's gauge again
            gauge = REGISTRY.gauge("kf_kv_cache_bytes").value
            assert [kv(p) for p in peers] == [gauge] * 3
        finally:
            for w in workers:
                w.stop()
            for p in peers:
                p.close()
            srv.stop()

    def test_without_config_server_no_reporter(self, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_CLUSTER_MONITOR", "1")
        peers = start_local_cluster(2, devices=["cpu"])
        try:
            assert all(p._reporter is None for p in peers)
            from kungfu_tpu_torch.monitor.aggregator import \
                post_control_if_enabled

            assert post_control_if_enabled(peers[0], "resize") is False
        finally:
            for p in peers:
                p.close()

    def test_publish_device_memory_on_cpu(self):
        before = dict(REGISTRY.snapshot())
        assert metrics.publish_device_memory() is False
        assert {k: v for k, v in REGISTRY.snapshot().items()
                if k.startswith("kf_device_memory_bytes")} == {
            k: v for k, v in before.items()
            if k.startswith("kf_device_memory_bytes")}

    def test_publish_stat(self):
        tagg.publish_stat("gns", 3.5)
        assert REGISTRY.gauge("kf_stat_gns").value == 3.5
