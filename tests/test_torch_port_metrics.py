"""Port parity: the net monitor and ``/metrics`` (``monitor/metrics.py``,
``monitor/registry.py``'s Prometheus rendering, the config server's
``/metrics`` and ``main``, the channels' byte counters, the peer's
monitor) against the JAX package.

* ``NetMonitor``'s totals, rates, rendering and registry mirror equal
  the reference's under the same bytes and the same sample times;
* ``MetricsRegistry.render_prometheus`` and ``Histogram.bucket_counts``
  byte for byte the reference's for the same registry;
* ``MetricsServer`` on port 0, on a taken port (an ephemeral bind), its
  404 and its section isolation;
* the config server's ``/metrics`` (200 with an aggregator, its cluster
  section the reference's) and ``python -m
  kungfu_tpu_torch.elastic.configserver -monitor``;
* each port channel, Python and native, counts the bytes of an exchange
  as the reference's Python channel does, and an engine allreduce's
  egress equals ``CollectiveEngine.all_reduce_egress``;
* a ``Peer`` started with ``KF_CONFIG_ENABLE_MONITORING`` serves
  ``/metrics`` at its port + 10000 and returns measured
  ``get_egress_rates()``.

Every server binds port 0 or a port found free; channels run with
``KF_TPU_USE_UNIXSOCK=0``.
"""

import errno
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kungfu_tpu import plan as jplan
from kungfu_tpu.comm import host as jhost
from kungfu_tpu.monitor import aggregator as jagg
from kungfu_tpu.monitor import metrics as jmetrics
from kungfu_tpu.monitor import registry as jreg
from kungfu_tpu_torch import plan as tplan
from kungfu_tpu_torch.comm import host as thost
from kungfu_tpu_torch.comm.engine import CollectiveEngine
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.monitor import aggregator as tagg
from kungfu_tpu_torch.monitor import metrics as tmetrics
from kungfu_tpu_torch.monitor import registry as treg
from kungfu_tpu_torch.peer import start_local_cluster
from kungfu_tpu_torch.utils import envs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("KF_CONFIG_ENABLE_MONITORING", "KF_CONFIG_MONITORING_PERIOD",
              "KF_CONFIG_ENABLE_CLUSTER_MONITOR", "KF_CHAOS_SPEC",
              "KF_CONFIG_CHUNK_SIZE", "KF_JAX_PLATFORM"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- NetMonitor ----------------------------------------------------------------

class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def time(self):
        return self.times.pop(0)


class _Ticks:
    """A stand-in for the sampler's stop event: each ``wait`` feeds one
    round of bytes, then reports "not stopped" until the rounds run out."""

    def __init__(self, mon, rounds):
        self.mon, self.rounds = mon, list(rounds)

    def wait(self, _period):
        if not self.rounds:
            return True
        for kind, addr, n in self.rounds.pop(0):
            getattr(self.mon, kind)(addr, n)
        return False

    def set(self):
        self.rounds = []


ROUNDS = [
    [("egress", "127.0.0.1:10001", 4096), ("ingress", "127.0.0.1:10001", 10),
     ("egress", "127.0.0.1:10002", 1)],
    [],
    [("egress", "127.0.0.1:10001", 123456789),
     ("ingress", "127.0.0.1:10003", 77)],
    [("egress", "127.0.0.1:10002", 5), ("egress", "127.0.0.1:10002", 6)],
]


@pytest.mark.parametrize("times", [
    [100.0, 100.5, 101.0, 103.0, 103.25],
    [0.0, 1.0, 2.0, 3.0, 4.0],
    [5.0, 5.0, 6.5, 6.5, 7.0],
])
def test_net_monitor_matches_reference(monkeypatch, times):
    out = []
    for mod, reg in ((tmetrics, treg), (jmetrics, jreg)):
        monkeypatch.setattr(mod, "time", _Clock(times))
        mon = mod.NetMonitor(period=0.5)
        mon._stop = _Ticks(mon, ROUNDS)
        mon._sample_loop()
        addrs = ["127.0.0.1:10001", "127.0.0.1:10002", "127.0.0.1:9"]
        out.append((mon.totals(), mon.egress_rates(), mon.egress_rates(addrs),
                    mon.render_prometheus({"kf_extra": 1.5}),
                    reg.REGISTRY.gauge("kf_net_egress_bytes").value,
                    reg.REGISTRY.gauge("kf_net_ingress_bytes").value))
    assert out[0] == out[1]
    assert out[0][0]["egress"]["127.0.0.1:10001"] == 4096 + 123456789


@pytest.mark.parametrize("env", [None, "0.25", "x", "3"])
def test_monitoring_period_from_env(monkeypatch, env):
    if env is not None:
        monkeypatch.setenv("KF_CONFIG_MONITORING_PERIOD", env)
    assert tmetrics.monitoring_period_from_env() == \
        jmetrics.monitoring_period_from_env()
    assert tmetrics.METRICS_PORT_OFFSET == jmetrics.METRICS_PORT_OFFSET


# -- the registry's rendering --------------------------------------------------

def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("kf_engine_collectives_total").inc(3)
    reg.counter("kf_chaos_injections_total", kind="die").inc()
    reg.counter("kf_chaos_injections_total", kind='q"uo\\te\n').inc(2)
    reg.gauge("kf_net_egress_bytes").set(123456789.0)
    reg.gauge("kf_mfu").set(0.1234567891)
    reg.gauge("a_metric_without_help", x="1").set(-2.5)
    h = reg.histogram("kf_collective_latency_seconds", plane="host",
                      op="all_reduce")
    for v in (0.00005, 0.0003, 0.02, 0.02, 7.0, 120.0):
        h.observe(v)
    reg.histogram("kf_serve_ttft_seconds", buckets=(0.1, 1.0)).observe(0.5)
    reg.histogram("kf_serve_token_seconds")  # empty
    return reg


def test_registry_render_prometheus_byte_equal():
    mine, ref = _fill(treg), _fill(jreg)
    assert mine.render_prometheus() == ref.render_prometheus()
    assert treg.MetricsRegistry().render_prometheus() == \
        jreg.MetricsRegistry().render_prometheus() == ""
    assert treg.METRIC_HELP == jreg.METRIC_HELP
    text = mine.render_prometheus()
    assert '# TYPE kf_collective_latency_seconds histogram' in text
    assert 'le="+Inf"' in text and 'kind="q\\"uo\\\\te\\n"' in text


@pytest.mark.parametrize("values", [[], [0.0001], [1e-5, 0.3, 0.3, 59.0, 61.0],
                                    list(np.linspace(0, 2, 50))])
def test_bucket_counts(values):
    hs = []
    for mod in (treg, jreg):
        h = mod.Histogram()
        for v in values:
            h.observe(float(v))
        hs.append(h.bucket_counts())
    assert hs[0] == hs[1]
    assert hs[0][-1] == (float("inf"), len(values))


# -- MetricsServer -----------------------------------------------------------

def test_metrics_server_port0_and_taken_port():
    mon = tmetrics.NetMonitor()
    mon.egress("127.0.0.1:10001", 42)
    srv = tmetrics.MetricsServer(mon, 0, host="127.0.0.1",
                                 extra_fn=lambda: {"kf_x": 2}).start()
    try:
        assert srv.port > 0
        code, ctype, text = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert text.startswith(mon.render_prometheus({"kf_x": 2}))
        assert 'kf_egress_bytes_total{peer="127.0.0.1:10001"} 42' in text
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{srv.port}/other")
        assert e.value.code == 404
        # a taken fixed port: an ephemeral bind instead
        taken = tmetrics.MetricsServer(mon, srv.port,
                                       host="127.0.0.1").start()
        try:
            assert taken.port not in (0, srv.port)
            code, _, again = _get(f"http://127.0.0.1:{taken.port}/metrics")
            assert code == 200 and "kf_egress_bytes_total" in again
        finally:
            taken.stop()
    finally:
        srv.stop()


def test_metrics_server_port_past_65535():
    """A worker on a port above 55535 asks for its metrics server past
    65535: the port binds an ephemeral port, where the reference's
    raises (ROADMAP C25)."""
    with pytest.raises(OverflowError):
        jmetrics.MetricsServer(jmetrics.NetMonitor(), 70000, host="127.0.0.1")
    srv = tmetrics.MetricsServer(tmetrics.NetMonitor(), 70000,
                                 host="127.0.0.1").start()
    try:
        assert 0 < srv.port <= 65535
        assert _get(f"http://127.0.0.1:{srv.port}/metrics")[0] == 200
    finally:
        srv.stop()


def test_metrics_server_isolates_a_failing_section():
    def boom():
        raise RuntimeError("bad\ncallback")

    texts = []
    for mod in (tmetrics, jmetrics):
        mon = mod.NetMonitor()
        mon.ingress("h:1", 7)
        srv = mod.MetricsServer(mon, 0, host="127.0.0.1",
                                extra_fn=boom).start()
        try:
            code, _, text = _get(f"http://127.0.0.1:{srv.port}/metrics")
        finally:
            srv.stop()
        assert code == 200
        texts.append([ln for ln in text.splitlines()
                      if ln.startswith(("kf_ingress", "# error"))])
    assert texts[0] == texts[1]
    assert texts[0][-1] == "# error: extra_fn: RuntimeError: bad callback"


# -- the config server's /metrics ----------------------------------------------

def _snapshot(mod, rank):
    return mod.make_snapshot(
        rank=rank, slice=rank // 2, pid=10 + rank, wall=5.0 + rank, step=3,
        step_time_s=0.25 * (rank + 1), strategy="RING",
        gauges={"kf_serve_active_requests": 2.0, "kf_gns": 3.5,
                "kf_mfu": 0.25, "kf_model_flops_s": 1e12,
                'kf_step_phase_seconds{phase="compute"}': 0.2,
                "kf_kv_cache_bytes": 4096.0},
        counters={'kf_serve_requests_total{what="complete"}': 4},
        net={"egress_bytes": 100 * rank, "ingress_bytes": 9},
        events=[{"ts": 1.0 + rank * 1e-3, "rank": rank, "step": 3,
                  "kind": "collective", "name": "g", "dur": 0.01 * (rank + 1),
                  "attrs": {"op": "all_reduce", 'tag': 'g"0'}}])


CLUSTER_INFO = {"version": 2, "size": 4,
                "workers": [f"127.0.0.1:{10000 + i}" for i in range(4)]}


def test_aggregator_render_prometheus_via_config_server():
    renders = []
    for mod in (tagg, jagg):
        clock = [10.0]
        agg = mod.ClusterAggregator(stale_after=3.0,
                                    time_fn=lambda c=clock: c[0])
        for r in range(4):
            clock[0] = 10.0 + r
            agg.ingest(json.loads(json.dumps(_snapshot(mod, r))))
        agg.ingest({**mod.control_event("resize", rank=0, version=2),
                    "wall": 1.0})
        clock[0] = 15.0
        renders.append((agg, agg.render_prometheus(CLUSTER_INFO)))
    assert renders[0][1] == renders[1][1]
    assert "kf_cluster_ranks 4" in renders[0][1]
    assert 'kf_cluster_skew_seconds{op="all_reduce",tag="g\\"0"}' in \
        renders[0][1]
    agg = renders[0][0]
    cluster = tplan.Cluster(tplan.PeerList.parse("127.0.0.1:38080"),
                            tplan.PeerList.parse(",".join(
                                CLUSTER_INFO["workers"])))
    srv = ConfigServer(port=0, host="127.0.0.1", cluster=cluster,
                       aggregator=agg).start()
    bare = ConfigServer(port=0, host="127.0.0.1").start()
    try:
        code, ctype, text = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert text.startswith(agg.render_prometheus(srv._cluster_info()))
        assert "kf_cluster_config_version 0" in text
        for port, route in ((srv.port, "/alerts"), (srv.port, "/decisions"),
                            (bare.port, "/metrics")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"http://127.0.0.1:{port}{route}")
            assert e.value.code == 404
    finally:
        srv.stop()
        bare.stop()


def test_config_server_main_with_monitor():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.elastic.configserver",
         "-port", str(port), "-host", "127.0.0.1", "-monitor"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                code, _, text = _get(f"http://127.0.0.1:{port}/metrics",
                                     timeout=2)
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        assert code == 200 and "kf_cluster_ranks 0" in text
        _get(f"http://127.0.0.1:{port}/stop")
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- the channels' byte counters ---------------------------------------------

def _ref_channel(monitor, retries=20):
    for _ in range(retries):
        pid = jplan.PeerID("127.0.0.1", _free_port())
        try:
            return jhost.PyHostChannel(pid, bind_host="127.0.0.1",
                                       monitor=monitor)
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
    raise RuntimeError("no free port for a reference channel")


def _exchange(a, b, pid):
    """a sends b three frames (one empty), b answers one; the monitors'
    totals as (a's egress, a's ingress, b's egress, b's ingress)."""
    pa, pb = pid(a.self_id), pid(b.self_id)
    sizes = [10, 0, 70000]
    for i, n in enumerate(sizes):
        a.send(pb, f"m{i}", bytes(range(256)) * (n // 256) + b"x" * (n % 256))
    for i, n in enumerate(sizes):
        assert len(b.recv(pa, f"m{i}")) == n
    b.send(pa, "back", b"y" * 333)
    assert a.recv(pb, "back") == b"y" * 333


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_channel_byte_counts_match_reference(native):
    counts = []
    for ref in (True, False):
        ma, mb = (tmetrics.NetMonitor() for _ in range(2))
        if ref:
            a, b = _ref_channel(ma), _ref_channel(mb)
            pid = lambda p: jplan.PeerID(p.host, p.port)  # noqa: E731
        else:
            mk = thost.NativeHostChannel if native else thost.PyHostChannel
            a, b = (mk(tplan.PeerID("127.0.0.1", 0), bind_host="127.0.0.1",
                       monitor=m) for m in (ma, mb))
            pid = lambda p: tplan.PeerID(p.host, p.port)  # noqa: E731
        try:
            _exchange(a, b, pid)
        finally:
            a.close()
            b.close()  # the native channel feeds its last counts here
        sa, sb = str(a.self_id), str(b.self_id)
        ta, tb = ma.totals(), mb.totals()
        counts.append((ta["egress"], ta["ingress"], tb["egress"],
                       tb["ingress"], sa, sb))
    (ref, mine) = counts
    for got, want in ((mine, ref),):
        ga, gb, wa, wb = got[4], got[5], want[4], want[5]
        assert got[0] == {gb: want[0][wb]} and got[1] == {gb: want[1][wb]}
        assert got[2] == {ga: want[2][wa]} and got[3] == {ga: want[3][wa]}
    assert ref[0][ref[5]] == 10 + 70000 and ref[2][ref[4]] == 333


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("strategy", ["STAR", "RING", "BINARY_TREE_STAR",
                                      "AUTO"])
def test_engine_egress_is_what_the_monitor_counts(monkeypatch, native,
                                                  strategy):
    monkeypatch.setenv("KF_CONFIG_CHUNK_SIZE", str(1 << 12))
    mk = thost.NativeHostChannel if native else thost.PyHostChannel
    mons = [tmetrics.NetMonitor() for _ in range(3)]
    chans = [mk(tplan.PeerID("127.0.0.1", 0), bind_host="127.0.0.1",
                monitor=m) for m in mons]
    peers = tplan.PeerList.of(*(c.self_id for c in chans))
    engines = [CollectiveEngine(c, peers, tplan.parse_strategy(strategy))
               for c in chans]
    try:
        xs = [torch.arange(10007, dtype=torch.float32) + r for r in range(3)]
        outs = [None] * 3
        threads = [threading.Thread(target=lambda r=r: outs.__setitem__(
            r, engines[r].all_reduce(xs[r], op="mean", name="g0")))
            for r in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(torch.equal(o, outs[0]) for o in outs)
        for c in chans:
            if native:
                c.poll_counters()
        for r in range(3):
            assert mons[r].totals()["egress"] == \
                engines[r].all_reduce_egress(10007 * 4, 4, "g0")
    finally:
        for e in engines:
            e.close()
        for c in chans:
            c.close()


# -- the peer's monitor ------------------------------------------------------

def test_peer_with_monitoring_measures_egress(monkeypatch):
    monkeypatch.setenv(envs.ENABLE_MONITORING, "1")
    monkeypatch.setenv(envs.MONITORING_PERIOD, "0.2")
    peers = start_local_cluster(2, devices=["cpu"])
    try:
        for p in peers:
            assert p.net_monitor is not None
            assert p.channel.monitor is p.net_monitor
        buf = [np.ones(1 << 18, np.float32) for _ in peers]
        deadline = time.monotonic() + 30
        while True:
            threads = [threading.Thread(target=lambda i=i: peers[i].engine()
                                        .all_reduce(buf[i], op="sum"))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            rates = [p.get_egress_rates() for p in peers]
            if all(max(r) > 0 for r in rates) or \
                    time.monotonic() > deadline:
                break
        assert all(len(r) == 2 and max(r) > 0 for r in rates), rates
        for p in peers:
            totals = p._net_totals()
            assert totals["egress_bytes"] > 0 and totals["ingress_bytes"] > 0
            port = p._metrics_server.port
            want = p.config.self_id.port + tmetrics.METRICS_PORT_OFFSET
            assert port == want or port != 0
            code, _, text = _get(f"http://127.0.0.1:{port}/metrics")
            assert code == 200 and "kf_egress_bytes_total{" in text
    finally:
        for p in peers:
            p.close()
    assert all(p.net_monitor is None and p._metrics_server is None
               for p in peers)
    with pytest.raises(urllib.error.URLError):
        _get(f"http://127.0.0.1:{port}/metrics", timeout=2)
