"""Port parity: the sentinel plane (``monitor/{detect,history,ledger,
sentinel,kfhist,kftop}.py``, ``policy/sentinel.py``, the aggregator's
``attach_sentinel``, the config server's ``/alerts`` and ``/decisions``,
the launcher's ``-sentinel``, ``utils/envs.sentinel_knobs``, the compile
feed) against the JAX package.

* detect: seeded series through both packages' ``changepoint``,
  ``window_verdicts``, ``burn_fraction`` and ``slo_burn``, equal exactly;
* history: segments either package writes, read by the other's
  ``scan_stream``/``series_from_records``; torn lines, gc, restart;
* the sentinel: one snapshot sequence through a reference aggregator with
  its sentinel and a port aggregator with the port's, each on its own
  fake clock: equal ``alerts_view()``, byte-identical history streams,
  equal incident bundles (only the incident path, which holds the root,
  differs); one case per rule; the disabled path; the knobs;
* the ledger: one decide/on_sample sequence gives equal records, views
  and replays; each port actor lands a record with the reference's
  fields; each package's kfhist reads the other's directory;
* the tools: ``kftop.render_view`` equal to the reference's with and
  without each section, the self-checks, the kfhist CLI;
* the routes, ``sentinel_signals``, the launcher's ``-sentinel`` and
  ``install_compile_metrics``.

Sockets bind port 0 (the launcher's workers take a free port range),
paths come from ``tmp_path``, every sentinel and SLO token is cleared,
and both packages' ledgers and timelines are reset around each test.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kungfu_tpu.monitor import aggregator as jagg
from kungfu_tpu.monitor import detect as jdetect
from kungfu_tpu.monitor import history as jhistory
from kungfu_tpu.monitor import kfhist as jkfhist
from kungfu_tpu.monitor import kftop as jkftop
from kungfu_tpu.monitor import ledger as jledger
from kungfu_tpu.monitor import sentinel as jsentinel
from kungfu_tpu.monitor import timeline as jtimeline
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.monitor import aggregator as tagg
from kungfu_tpu_torch.monitor import detect, history, kfhist, kftop, ledger
from kungfu_tpu_torch.monitor import metrics
from kungfu_tpu_torch.monitor import sentinel as tsentinel
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY
from tests._util import run_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TOKENS = (
    "KF_SENTINEL_DIR", "KF_SENTINEL_KEEP_BYTES", "KF_SENTINEL_PERIOD",
    "KF_SENTINEL_WINDOW", "KF_SENTINEL_THRESHOLD", "KF_SENTINEL_MFU_FLOOR",
    "KF_SENTINEL_STEP_CEILING_S", "KF_SENTINEL_WARMUP_STEPS",
    "KF_SENTINEL_INCIDENT_WINDOW", "KF_SENTINEL_SLO_SHORT",
    "KF_SENTINEL_SLO_LONG", "KF_SERVE_SLO_TTFT_MS", "KF_SERVE_SLO_E2E_MS",
    "KF_CHAOS_SPEC",
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for tok in _TOKENS:
        monkeypatch.delenv(tok, raising=False)
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for mod in (ledger, jledger, timeline, jtimeline):
        mod.reset()
    yield
    for mod in (ledger, jledger, timeline, jtimeline):
        mod.reset()


# -- detect --------------------------------------------------------------------

def _series(kind, seed, n=40):
    rng = np.random.default_rng(seed)
    base = 0.1 + 1e-3 * rng.standard_normal(n)
    if kind == "up":
        base[-8:] += 0.03
    elif kind == "down":
        base[-8:] -= 0.03
    elif kind == "quiet":
        base = np.full(n, 1.0)
        base[-8:] += 1e-9
    elif kind == "short":
        base = base[:5]
    elif kind == "blip":
        base[-3] += 0.5
    return [float(v) for v in base]


KINDS = ["clean", "up", "down", "quiet", "short", "blip"]


class TestDetect:
    @pytest.mark.parametrize("window", [2, 4, 8])
    @pytest.mark.parametrize("kind", KINDS)
    def test_changepoint_equal(self, kind, window):
        for seed in range(3):
            xs = _series(kind, seed)
            for thr in (2.0, 4.0):
                assert detect.changepoint(xs, window, thr) == \
                    jdetect.changepoint(xs, window, thr)
        assert detect.median(xs) == jdetect.median(xs)
        assert detect.mad(xs) == jdetect.mad(xs)

    @pytest.mark.parametrize("window", [4, 8])
    def test_window_verdicts_equal(self, window):
        series = {k: _series(k, 7) for k in KINDS}
        got = detect.window_verdicts(series, window=window)
        assert got == jdetect.window_verdicts(series, window=window)
        assert got["up"]["shifted"] and got["up"]["direction"] == "up"
        assert got["down"]["direction"] == "down"
        assert not got["clean"]["shifted"] and "short" not in got

    @pytest.mark.parametrize("seed", range(4))
    def test_burn_equal(self, seed):
        rng = np.random.default_rng(seed)
        xs = [float(v) for v in rng.uniform(100.0, 900.0, 30)]
        for budget in (300.0, 500.0, 800.0):
            for w in (1, 4, 6, 40):
                assert detect.burn_fraction(xs, budget, w) == \
                    jdetect.burn_fraction(xs, budget, w)
            for short, long_, sf, lf in ((6, 24, 0.5, 0.25), (2, 4, 0.5, 0.5),
                                         (3, 40, 0.3, 0.1)):
                assert detect.slo_burn(xs, budget, short, long_, sf, lf) == \
                    jdetect.slo_burn(xs, budget, short, long_, sf, lf)

    def test_constants_equal(self):
        for name in ("DEFAULT_WINDOW", "BASELINE_WINDOWS", "DEFAULT_THRESHOLD",
                     "DEFAULT_REL_FLOOR", "ABS_FLOOR"):
            assert getattr(detect, name) == getattr(jdetect, name)


# -- history -------------------------------------------------------------------

def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"kfhist": 1, "wall": 1000.0 + i,
             "series": {"step_time_s": float(rng.uniform(0.09, 0.11)),
                        "mfu": 0.4, "flag": True},
             "stale": [], "straggler": None} for i in range(n)]


def _stream_bytes(root):
    return {n: open(os.path.join(root, n), "rb").read()
            for n in sorted(os.listdir(root)) if n.endswith(".jsonl")}


class TestHistory:
    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_cross_read(self, tmp_path, writer):
        w, r = (history, jhistory) if writer == "port" else (jhistory, history)
        root = str(tmp_path)
        ring = w.HistoryRing(root, "cluster", keep_bytes=1 << 20,
                             segment_records=8)
        recs = _records(20)
        for rec in recs:
            ring.append(rec)
        got, skipped = r.scan_stream(root, "cluster")
        assert got == recs and skipped == 0
        assert r.series_from_records(got) == w.series_from_records(recs)
        assert r.read_stream(root, "cluster", last=3) == recs[-3:]
        assert r.streams(root) == w.streams(root) == ["cluster"]

    def test_byte_identical_segments(self, tmp_path):
        roots = [str(tmp_path / "port"), str(tmp_path / "ref")]
        for mod, root in zip((history, jhistory), roots):
            ring = mod.HistoryRing(root, "rank-3", keep_bytes=1 << 20,
                                   segment_records=7)
            for rec in _records(30, seed=1):
                ring.append(rec)
        a, b = (_stream_bytes(r) for r in roots)
        assert a == b and len(a) == 5

    def test_torn_lines_gc_and_restart(self, tmp_path):
        outs = []
        for mod in (history, jhistory):
            root = str(tmp_path / mod.__name__)
            ring = mod.HistoryRing(root, "s", keep_bytes=120,
                                   segment_records=3)
            for i in range(11):
                ring.append({"i": i})
            segs = mod._segments(root, "s")
            with open(segs[0][1], "ab") as f:
                f.write(b'{"torn": ')
            with open(segs[-1][1], "ab") as f:
                f.write(b"[1, 2]\n")
            again = mod.HistoryRing(root, "s", keep_bytes=120,
                                    segment_records=3)
            again.append({"i": 99})
            # a restart opens a fresh segment, and gc never collects it
            removed = again.gc()
            assert again._seq == ring._seq + 1
            segs = [s for s, _ in mod._segments(root, "s")]
            assert segs[-1] == again._seq
            recs, skipped = mod.scan_stream(root, "s")
            outs.append(([r["i"] for r in recs], skipped, segs, removed))
        assert outs[0] == outs[1]
        vals = outs[0][0]
        assert vals[-1] == 99 and vals[:-1] == list(range(11))[-len(vals) + 1:]
        # the first segment, with its torn line, was collected
        assert outs[0][1] == 1

    def test_bad_stream_names(self, tmp_path):
        for bad in ("", "a/b", ".x"):
            with pytest.raises(ValueError):
                history.HistoryRing(str(tmp_path), bad)


# -- the sentinel --------------------------------------------------------------

def _span(rank, step, dur, tag, ts):
    return {"ts": ts, "rank": rank, "step": step, "kind": "collective",
            "name": "engine.all_reduce", "dur": dur,
            "attrs": {"op": "all_reduce", "tag": tag,
                      "trace": f"c.{step}.{tag}"}}


def _snapshots(steps=28, onset=16, slow=1):
    """Three ranks a step: a clean phase, then rank ``slow``'s collective
    legs and everyone's step time inflate from ``onset`` on."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(steps):
        rows = []
        for r in range(3):
            base = 0.1 + 2e-4 * float(rng.standard_normal())
            late = i >= onset
            st = base + (0.06 if late else 0.0)
            dur = 0.01 + (0.05 if late and r == slow else 0.0)
            ts = 100.0 + i * 0.2 + r * 1e-3
            rows.append(dict(
                rank=r, pid=4000 + r, step=i, step_time_s=st,
                counters={"kf_jit_compiles_total": 2.0},
                gauges={"kf_gns": 1.5, "kf_mfu": 0.4,
                        'kf_device_memory_bytes{kind="in_use"}': 1e9},
                latency={}, strategy="STAR",
                net={"egress_bytes": 1000 * (i + 1)},
                events=[_span(r, i, dur, f"g{i}", ts),
                        {"ts": ts - 0.05, "rank": r, "step": i,
                         "kind": "input", "name": "batch.next",
                         "dur": 0.002, "attrs": {}}]))
        out.append(rows)
    return out


def _run(pkg_agg, pkg_sentinel, root, steps, **kw):
    clock = [1000.0]
    agg = pkg_agg.ClusterAggregator(stale_after=3600.0,
                                    time_fn=lambda: clock[0])
    s = pkg_sentinel.Sentinel(root, period_s=1.0, **kw)
    agg.attach_sentinel(s)
    for rows in steps:
        for row in rows:
            agg.ingest(pkg_agg.make_snapshot(wall=clock[0], **row))
        clock[0] += 1.0
        # a re-ingest of rank 0 triggers the sample with every row fresh
        agg.ingest(pkg_agg.make_snapshot(wall=clock[0], **rows[0]))
    return agg, s


def _no_incident(av):
    return {**av, "alerts": [{k: v for k, v in a.items() if k != "incident"}
                             for a in av["alerts"]]}


class TestSentinelEqualRuns:
    @pytest.fixture(scope="class")
    def runs(self, tmp_path_factory):
        for mod in (ledger, jledger):
            mod.reset()
        root = tmp_path_factory.mktemp("equal")
        steps = _snapshots()
        out = {}
        for name, pa, ps in (("port", tagg, tsentinel),
                             ("ref", jagg, jsentinel)):
            d = str(root / name)
            agg, s = _run(pa, ps, d, steps, window=4)
            out[name] = (d, agg, s)
        yield out
        for mod in (ledger, jledger):
            mod.reset()

    def test_alerts_view(self, runs):
        a = runs["port"][2].alerts_view()
        b = runs["ref"][2].alerts_view()
        assert json.dumps(_no_incident(a), sort_keys=True) == \
            json.dumps(_no_incident(b), sort_keys=True)
        rules = [x["rule"] for x in a["alerts"]]
        assert rules.count("regress:step_time_s") == 1
        # the incident path names the package's own root and nothing else
        for (d, _, s) in (runs["port"], runs["ref"]):
            for x in s.alerts_view()["alerts"]:
                assert x["incident"].startswith(os.path.join(d, "incidents"))

    def test_streams_byte_identical(self, runs):
        a, b = (_stream_bytes(runs[k][0]) for k in ("port", "ref"))
        assert a == b
        assert {n.rsplit("-", 1)[0] for n in a} >= {"cluster", "rank-0",
                                                 "rank-1", "rank-2"}

    def test_incident_bundles_equal(self, runs):
        names = [sorted(os.listdir(os.path.join(runs[k][0], "incidents")))
                 for k in ("port", "ref")]
        assert names[0] == names[1] and names[0]
        for n in names[0]:
            a, b = (open(os.path.join(runs[k][0], "incidents", n), "rb")
                    .read() for k in ("port", "ref"))
            assert a == b, n
        bundle = json.loads(a)
        culprit = bundle["xray"]["verdict"]["culprit"]
        assert culprit["slowest_rank"] == 1

    def test_kfhist_replay_equals_incident(self, runs):
        d = runs["port"][0]
        inc = [n for n in os.listdir(os.path.join(d, "incidents"))
               if "regress-step_time_s" in n][0]
        bundle = json.load(open(os.path.join(d, "incidents", inc)))
        for mod in (kfhist, jkfhist):
            off = mod.verdict_from_dir(d, upto=bundle["history_n"],
                                       window=4, threshold=4.0)
            assert json.dumps(off["verdicts"], sort_keys=True) == \
                json.dumps(bundle["verdicts"], sort_keys=True)

    def test_cluster_view_and_prometheus(self, runs):
        va = runs["port"][1].cluster_view()
        vb = runs["ref"][1].cluster_view()
        assert json.dumps(_no_incident(va["alerts"]), sort_keys=True) == \
            json.dumps(_no_incident(vb["alerts"]), sort_keys=True)
        assert runs["port"][1].render_prometheus() == \
            runs["ref"][1].render_prometheus()


def _observe_both(tmp_path, views, **kw):
    out = []
    for mod in (tsentinel, jsentinel):
        s = mod.Sentinel(str(tmp_path / mod.__name__), **kw)
        out.append([[a["rule"] for a in s.observe(v)] for v in views])
        out[-1].append(_no_incident(s.alerts_view()))
    assert out[0] == out[1]
    return out[0]


def _row(step, st, **extra):
    return {"rank": 0, "step": step, "step_time_s": st, **extra}


class TestRules:
    def test_regress(self, tmp_path):
        views = [{"wall": float(i), "ranks": [_row(i, 0.1 if i < 12
                                                   else 0.2)]}
                 for i in range(20)]
        fired = _observe_both(tmp_path, views, window=4)
        flat = [r for f in fired[:-1] for r in f]
        assert flat == ["regress:step_time_s"]
        assert fired[12:16].count(["regress:step_time_s"]) == 1

    def test_sloburn_burn(self, tmp_path):
        views = [{"wall": float(i), "ranks": [],
                  "serving": {"ttft_ms": 900.0, "e2e_ms": 100.0,
                              "kv_bytes": 0}} for i in range(4)]
        fired = _observe_both(tmp_path, views, window=4, slo_short=2,
                              slo_long=4, slo_budgets={"ttft_ms": 500.0})
        assert fired[3] == ["sloburn:ttft_ms"]

    def test_sloburn_single_blip(self, tmp_path):
        views = [{"wall": float(i), "ranks": [],
                  "serving": {"ttft_ms": v, "e2e_ms": 100.0, "kv_bytes": 0}}
                 for i, v in enumerate([100.0, 900.0, 100.0, 100.0])]
        fired = _observe_both(tmp_path, views, window=4, slo_short=2,
                              slo_long=4, slo_budgets={"ttft_ms": 500.0})
        assert fired[:4] == [[]] * 4

    def test_mfu_floor(self, tmp_path):
        v = {"wall": 1.0, "ranks": [],
             "xray": {"mfu": {"0": 0.2}, "phase_seconds": {}}}
        fired = _observe_both(tmp_path, [v, v], mfu_floor=0.3, window=4)
        assert fired[:2] == [["watermark:mfu"], []]

    def test_step_ceiling(self, tmp_path):
        views = [{"wall": float(i), "ranks": [_row(i, st)]}
                 for i, st in enumerate([0.3, 0.3, 0.1, 0.3])]
        fired = _observe_both(tmp_path, views, step_ceiling_s=0.2, window=4)
        assert fired[:4] == [["watermark:step_time"], [], [],
                             ["watermark:step_time"]]

    def test_stale_slice(self, tmp_path):
        fired = _observe_both(tmp_path, [{"wall": 1.0, "ranks": [],
                                          "stale_slices": [1]}], window=4)
        assert fired[0] == ["watermark:stale_slice"]

    def test_stale_checkpoint(self, tmp_path):
        row = _row(5, 0.1, gauges={"kf_ckpt_period_seconds": 10.0,
                                   "kf_ckpt_age_seconds": 40.0})
        fired = _observe_both(tmp_path, [{"wall": 1.0, "ranks": [row]}],
                              window=4)
        assert fired[0] == ["watermark:ckpt_age"]

    def test_recompile_steady(self, tmp_path):
        def view(step, compiles):
            return {"wall": float(step), "ranks": [_row(
                step, 0.1, counters={"kf_jit_compiles_total": compiles})]}

        fired = _observe_both(tmp_path, [view(2, 10), view(5, 3), view(6, 3),
                                         view(7, 4), view(8, 4)],
                              warmup_steps=4, window=4)
        assert fired[:5] == [[], [], [], ["watermark:recompile_steady"], []]

    def test_counter_and_timeline(self, tmp_path):
        before = REGISTRY.counter("kf_alerts_total",
                                  rule="watermark:step_time").value
        s = tsentinel.Sentinel(str(tmp_path), step_ceiling_s=0.2, window=4)
        s.observe({"wall": 1.0, "ranks": [_row(0, 0.5)]})
        assert REGISTRY.counter("kf_alerts_total",
                                rule="watermark:step_time").value == before + 1
        ev = [e for e in timeline.snapshot() if e["kind"] == "alert"]
        assert [e["name"] for e in ev] == ["watermark:step_time"]

    def test_extract_series_equal(self):
        views = [{"ranks": []}, {"ranks": [_row(1, None)]}]
        steps = _snapshots(steps=2)
        views.append({"ranks": steps[1], "serving": {
            "ttft_ms": 3.0, "e2e_ms": 9.0, "kv_bytes": 7},
            "xray": {"mfu": {"0": 0.1, "1": 0.3},
                     "phase_seconds": {"compute": 0.5}}})
        for v in views:
            assert tsentinel.extract_series(v) == jsentinel.extract_series(v)


class TestDisabledPath:
    def test_views_byte_identical(self, tmp_path):
        """No sentinel: the port's /cluster and /metrics equal the
        reference's (wall and age aside) and carry no alerts; attached,
        the alerts section is the only difference."""
        clock = [1000.0]
        aggs = [tagg.ClusterAggregator(stale_after=3600.0,
                                       time_fn=lambda: clock[0]),
                jagg.ClusterAggregator(stale_after=3600.0,
                                       time_fn=lambda: clock[0]),
                tagg.ClusterAggregator(stale_after=3600.0,
                                       time_fn=lambda: clock[0])]
        aggs[2].attach_sentinel(tsentinel.Sentinel(str(tmp_path), window=4))
        for rows in _snapshots(steps=4):
            for agg, mod in zip(aggs, (tagg, jagg, tagg)):
                for row in rows:
                    agg.ingest(mod.make_snapshot(wall=clock[0], **row))
        va, vb, vc = (a.cluster_view() for a in aggs)
        assert "alerts" not in va and "alerts" in vc
        assert json.dumps(va, sort_keys=True) == json.dumps(vb, sort_keys=True)
        assert json.dumps(va, sort_keys=True) == json.dumps(
            {k: v for k, v in vc.items() if k != "alerts"}, sort_keys=True)
        pa, pb, pc = (a.render_prometheus() for a in aggs)
        assert pa == pb and "kf_cluster_alerts_active" not in pa
        assert "kf_cluster_alerts_active" in pc

    def test_from_env(self, tmp_path, monkeypatch):
        assert tsentinel.Sentinel.from_env() is None
        assert ledger.active() is None
        assert ledger.record_decision("x", "k", 1, 2) is None
        monkeypatch.setenv("KF_SENTINEL_DIR", str(tmp_path))
        monkeypatch.setenv("KF_SENTINEL_WINDOW", "5")
        monkeypatch.setenv("KF_SENTINEL_THRESHOLD", "6.5")
        a, b = tsentinel.Sentinel.from_env(), jsentinel.Sentinel.from_env()
        for k in ("root", "period_s", "window", "threshold", "mfu_floor",
                  "step_ceiling_s", "warmup_steps", "incident_window",
                  "slo_budgets", "slo_short", "slo_long", "slo_short_frac",
                  "slo_long_frac"):
            assert getattr(a, k) == getattr(b, k), k
        assert a.ledger is ledger.active()


class TestKnobs:
    def test_sentinel_knobs_equal(self, monkeypatch):
        from kungfu_tpu.utils import envs as jenvs
        from kungfu_tpu_torch.utils import envs

        assert envs.sentinel_knobs() == jenvs.sentinel_knobs()
        monkeypatch.setenv("KF_SENTINEL_WINDOW", "3")
        monkeypatch.setenv("KF_SENTINEL_MFU_FLOOR", "0.25")
        assert envs.sentinel_knobs() == jenvs.sentinel_knobs()
        k = envs.sentinel_knobs()
        assert k["keep_bytes"] == history.DEFAULT_KEEP_BYTES
        assert k["period_s"] == tsentinel.DEFAULT_PERIOD_S
        assert k["threshold"] == detect.DEFAULT_THRESHOLD
        assert k["warmup_steps"] == tsentinel.DEFAULT_WARMUP_STEPS
        assert k["incident_window"] == tsentinel.DEFAULT_INCIDENT_WINDOW
        assert k["slo_short"] == tsentinel.DEFAULT_SLO_SHORT
        assert k["slo_long"] == tsentinel.DEFAULT_SLO_LONG
        for name in [n for n in dir(jenvs) if n.startswith("SENTINEL_")]:
            assert getattr(envs, name) == getattr(jenvs, name)
        assert envs.SENTINEL_DIR == history.DIR_ENV
        assert envs.SERVE_SLO_TTFT_MS == tsentinel.TTFT_BUDGET_ENV
        # the sentinel, the ledger and kfhist read these same knobs
        monkeypatch.setenv("KF_SENTINEL_DIR", "/nonexistent/kf-sentinel")
        seen = {}
        monkeypatch.setattr(tsentinel.Sentinel, "__init__",
                            lambda self, root, **kw: seen.update(kw))
        tsentinel.Sentinel.from_env()
        k = envs.sentinel_knobs()
        for key in ("period_s", "window", "threshold", "mfu_floor",
                    "step_ceiling_s", "warmup_steps", "incident_window",
                    "slo_short", "slo_long"):
            assert seen[key] == k[key], key

    def test_slo_rules_equal(self):
        from kungfu_tpu.serve.slo import SLORules as JRules
        from kungfu_tpu_torch.serve.slo import SLORules

        r = SLORules()
        assert vars(r) == vars(JRules())
        assert r.ttft_budget_ms == tsentinel.DEFAULT_TTFT_BUDGET_MS
        assert r.e2e_budget_ms == tsentinel.DEFAULT_E2E_BUDGET_MS
        assert r.short_window == tsentinel.DEFAULT_SLO_SHORT
        assert r.long_window == tsentinel.DEFAULT_SLO_LONG
        assert r.short_frac == tsentinel.DEFAULT_SLO_SHORT_FRAC
        assert r.long_frac == tsentinel.DEFAULT_SLO_LONG_FRAC


# -- the ledger ----------------------------------------------------------------

def _ledger_run(mod, root, window=3):
    """One seeded decide/on_sample sequence; the ledger and its cluster
    ring, both under ``root``."""
    led = mod.DecisionLedger(root, window=window, threshold=4.0)
    ring = (history if mod is ledger else jhistory).HistoryRing(root,
                                                               "cluster")
    rng = np.random.default_rng(3)
    level = 0.2
    for i in range(30):
        if i in (4, 12, 20, 27):
            old, level = level, level * (0.5 if i != 20 else 2.0)
            led.decide("bandit-host", "strategy", f"S{i}", f"T{i}",
                       consensus_seq=i, trace_id=f"t{i}", step=i, wall=1.5,
                       evidence={"plane": "host", "i": i})
        if i == 8:
            led.decide("batch-width", "width", 4, 5, trace_id="w", step=i,
                       wall=2.0, effect_series="e2e_ms",
                       good_direction="down")
        rec = {"kfhist": 1, "wall": float(i), "series": {
            "step_time_s": level + 1e-3 * float(rng.standard_normal()),
            "e2e_ms": 50.0 + float(rng.uniform(0, 1))}}
        if i % 5 == 0:
            rec["series"].pop("e2e_ms")
        ring.append(rec)
        led.on_sample(rec)
    return led


class TestLedger:
    def test_equal_records_view_and_replay(self, tmp_path):
        roots = [str(tmp_path / "port"), str(tmp_path / "ref")]
        leds = [_ledger_run(m, r) for m, r in zip((ledger, jledger), roots)]
        a, b = (_stream_bytes(r) for r in roots)
        assert a == b
        recs = [history.read_stream(r, "decisions") for r in roots]
        assert json.dumps(recs[0], sort_keys=True) == \
            json.dumps(recs[1], sort_keys=True)
        assert json.dumps(leds[0].view(), sort_keys=True) == \
            json.dumps(leds[1].view(), sort_keys=True)
        reps = [ledger.replay_effects(roots[0]),
                jledger.replay_effects(roots[1])]
        assert json.dumps(reps[0], sort_keys=True) == \
            json.dumps(reps[1], sort_keys=True)
        verdicts = [ledger.lfield(r["online"], "verdict")
                    for r in reps[0]["decisions"]]
        assert "improved" in verdicts and "regressed" in verdicts
        for row in reps[0]["decisions"]:
            assert json.dumps(row["online"], sort_keys=True) == \
                json.dumps(row["replayed"], sort_keys=True)

    def test_schema(self):
        assert ledger.LEDGER_FIELDS == jledger.LEDGER_FIELDS
        with pytest.raises(ValueError):
            ledger.ledger_record(kind="decision", bogus=1)
        with pytest.raises(KeyError):
            ledger.lfield({}, "bogus")
        assert ledger.lfield(None, "seq", 7) == 7

    def test_judge_equal(self):
        d = {"window": 3, "threshold": 4.0, "seq": 1, "actor": "a",
             "knob": "k", "effect_series": "step_time_s"}
        for before, after in (([0.2] * 3, [0.1] * 3), ([0.1] * 3, [0.2] * 3),
                              ([0.1] * 2, [0.1] * 3), ([0.1] * 3, [0.1] * 2),
                              ([0.1, 0.11, 0.1], [0.1, 0.1, 0.105])):
            assert ledger.judge(d, before, after) == \
                jledger.judge(d, before, after)

    def test_record_decision_never_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KF_SENTINEL_DIR", str(tmp_path))
        led = ledger.active()
        monkeypatch.setattr(led, "decide", lambda *a, **k: 1 / 0)
        assert ledger.record_decision("a", "k", 1, 2) is None

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_each_kfhist_reads_the_other(self, tmp_path, writer):
        root = str(tmp_path)
        _ledger_run(ledger if writer == "port" else jledger, root)
        s = tsentinel.Sentinel(str(tmp_path / "s"), window=4) \
            if writer == "port" else jsentinel.Sentinel(
                str(tmp_path / "s"), window=4)
        for i in range(12):
            s.observe({"wall": float(i), "ranks": [_row(i, 0.1 if i < 8
                                                        else 0.3)]})
        for mod in (kfhist, jkfhist):
            dec = mod.decisions_from_dir(root)
            assert dec["decisions"] and all(
                r["match"] in (True, None) for r in dec["decisions"])
            v = mod.verdict_from_dir(str(tmp_path / "s"), window=4)
            assert v["verdicts"]["step_time_s"]["shifted"]
        assert json.dumps(kfhist.decisions_from_dir(root), sort_keys=True) \
            == json.dumps(jkfhist.decisions_from_dir(root), sort_keys=True)


# -- the actors ----------------------------------------------------------------

def _actor_records(root):
    return [r for r in history.read_stream(root, "decisions")
            if r["kind"] == "decision"]


def _ref_record(tmp_path, actor, knob, old, new, **kw):
    """The record the reference's ledger writes for the same call."""
    led = jledger.DecisionLedger(str(tmp_path / "jref"))
    return led.decide(actor, knob, old, new, **kw)


def _same_shape(got, want):
    assert set(got) == set(want)
    for k in ("kfledger", "kind", "actor", "knob", "old", "new",
              "consensus_seq", "evidence", "effect_series",
              "good_direction"):
        assert got[k] == want[k], k


class TestActors:
    @pytest.fixture
    def plane(self, tmp_path, monkeypatch):
        root = str(tmp_path / "plane")
        monkeypatch.setenv("KF_SENTINEL_DIR", root)
        return root

    def test_serving_policies(self, plane, tmp_path, monkeypatch):
        """BatchWidthController and ServeAutoscalePolicy: the same
        observations through both packages give equal records."""
        from kungfu_tpu.policy import base as jbase
        from kungfu_tpu.policy import serve as jserve
        from kungfu_tpu.serve import slo as jslo
        from kungfu_tpu_torch.policy import base as tbase
        from kungfu_tpu_torch.policy import serve as tserve
        from kungfu_tpu_torch.serve import slo as tslo

        jroot = str(tmp_path / "jplane")
        obs = [(0, 10.0), (5, 100.0), (5, 100.0), (0, 9000.0), (0, 9000.0),
               (9, 80.0), (0, 10.0), (0, 0.0)]
        for pol, base, slo, root in ((tserve, tbase, tslo, plane),
                                     (jserve, jbase, jslo, jroot)):
            monkeypatch.setenv("KF_SENTINEL_DIR", root)
            tg = slo.SLOTargets(ttft_s=0.5, e2e_s=1.0)
            c = pol.BatchWidthController(lambda w: w, targets=tg, start=4,
                                         cooldown_steps=0)
            for q, e2e in obs:
                c.observe(q, e2e)
            a = pol.ServeAutoscalePolicy(targets=tg, scale_up_queue=2,
                                         cooldown_steps=0)
            for q, e2e in obs:
                a.after_step(base.PolicyContext(cluster_size=2, metrics={
                    "serve_queued": q, "serve_active": 0,
                    "serve_e2e_ms": e2e}))
        got = _actor_records(plane)
        want = [r for r in jhistory.read_stream(jroot, "decisions")
                if r["kind"] == "decision"]
        assert {r["actor"] for r in got} == {"batch-width",
                                             "serve-autoscale"}
        strip = ("wall", "trace_id")
        assert [{k: v for k, v in r.items() if k not in strip} for r in got] \
            == [{k: v for k, v in r.items() if k not in strip} for r in want]

    def test_serve_fleet(self, plane, tmp_path, monkeypatch):
        from kungfu_tpu.elastic.slices import SliceTopology as JSliceTopology
        from kungfu_tpu.parallel.train import ParallelPlan as JPlan
        from kungfu_tpu.plan import PeerID as JPeerID
        from kungfu_tpu.plan import PeerList as JPeerList
        from kungfu_tpu.serve import scale as jscale
        from kungfu_tpu_torch.elastic.slices import SliceTopology
        from kungfu_tpu_torch.parallel.train import ParallelPlan
        from kungfu_tpu_torch.plan import PeerID, PeerList
        from kungfu_tpu_torch.serve import scale as tscale
        from tests.test_torch_port_router import (_StubSlicePeer,
                                                  _StubSliceRouter, _W)

        jroot = str(tmp_path / "jplane")
        for mod, pl, pid, topo, plan, root in (
                (tscale, PeerList, PeerID, SliceTopology(2, 2), ParallelPlan,
                 plane),
                (jscale, JPeerList, JPeerID, JSliceTopology(2, 2), JPlan,
                 jroot)):
            monkeypatch.setenv("KF_SENTINEL_DIR", root)
            workers = pl.of(*(pid("127.0.0.1", 20000 + i) for i in range(5)))
            router = _StubSliceRouter(_StubSlicePeer(workers), [0, 1, 2, 3],
                                      topo)
            fleet = mod.ServeFleet(router, None, lambda r: _W(),
                                   plan=plan(dp=2))
            fleet.workers = {r: _W() for r in (0, 1, 2, 3)}
            fleet.scale_to(2)
            fleet.scale_to(4)
        got = _actor_records(plane)
        want = [r for r in jhistory.read_stream(jroot, "decisions")
                if r["kind"] == "decision"]
        assert [r["actor"] for r in got] == ["serve-fleet"] * 2
        for g, w in zip(got, want):
            _same_shape(g, w)

    def test_overlap_depth(self, plane, tmp_path):
        from kungfu_tpu_torch.policy.bandit import OverlapDepthBandit

        class _Engine:
            def set_overlap_depth(self, d):
                self.depth = d

        b = OverlapDepthBandit(_Engine(), depths=(1, 2), check_every=1)
        for t in (0.5, 0.1, 0.1, 0.1):
            b.observe(t)
        got = _actor_records(plane)
        assert got and got[0]["actor"] == "overlap-depth"
        _same_shape(got[0], _ref_record(
            tmp_path, "overlap-depth", "depth", got[0]["old"],
            got[0]["new"], evidence=got[0]["evidence"]))

    def test_device_bandit(self, plane, tmp_path):
        from kungfu_tpu_torch.comm.device import Communicator
        from kungfu_tpu_torch.monitor.adapt_device import DeviceBanditDriver

        comm = Communicator(devices=["cpu"] * 4, local_size=4)
        d = DeviceBanditDriver(comm, check_every=2, min_pulls=1)
        lat = {"psum": 0.05, "two_stage": 0.04, "ring": 0.06,
               "pallas_ring": 0.01}
        for _ in range(12):
            d._on_collective(1 << 20, d.table.active[1],
                             lat[d.table.active[1]])
            d.step()
        comm.set_latency_hook(None)
        got = _actor_records(plane)
        assert got and got[0]["actor"] == "bandit-device"
        _same_shape(got[0], _ref_record(
            tmp_path, "bandit-device", "schedule", got[0]["old"],
            got[0]["new"], consensus_seq=got[0]["consensus_seq"],
            evidence=got[0]["evidence"]))
        assert got[0]["evidence"]["plane"] == "device"

    def test_host_bandit_and_shrink(self, plane, tmp_path, monkeypatch):
        """Three port peers under a throttled 0<->1 link: the host bandit
        swaps in lockstep and every swap lands a ``bandit-host`` record
        (and a counted ``decision`` event); then rank 2 goes and the
        survivors' shrink lands a ``shrink`` record."""
        from kungfu_tpu_torch import chaos
        from kungfu_tpu_torch.elastic import shrink
        from kungfu_tpu_torch.monitor.adapt_device import HostBanditDriver
        from kungfu_tpu_torch.peer import start_local_cluster

        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        monkeypatch.setenv("KF_CHAOS_SPEC", ";".join(
            f"delay:ms=15,rank={a},peer={b},on={on}"
            for a, b in ((0, 1), (1, 0)) for on in ("send", "ping")))
        chaos.reset()
        peers = start_local_cluster(3, env={"KF_CONFIG_STRATEGY": "STAR"},
                                    devices=["cpu"])
        data = np.ones(20_000, np.float32)
        try:
            drivers = [HostBanditDriver(p, check_every=2, min_pulls=1,
                                        min_swap_collectives=1)
                       for p in peers]

            def one(p, d):
                t0 = time.perf_counter()
                p.engine().all_reduce(data, op="sum")
                return d.step(time.perf_counter() - t0)

            for _ in range(12):
                run_all([lambda p=p, d=d: one(p, d)
                         for p, d in zip(peers, drivers)], timeout=120)
            swaps = sum(d.swaps for d in drivers)
            got = [r for r in _actor_records(plane)
                   if r["actor"] == "bandit-host"]
            assert swaps > 0 and len(got) == swaps
            _same_shape(got[0], _ref_record(
                tmp_path, "bandit-host", "strategy", got[0]["old"],
                got[0]["new"], consensus_seq=got[0]["consensus_seq"],
                evidence={"plane": "host"}))
            monkeypatch.delenv("KF_CHAOS_SPEC")
            chaos.reset()
            peers[2].close()
            assert all(run_all([lambda p=p: shrink.shrink_to_survivors(
                p, [2]) for p in peers[:2]], timeout=120))
            got = [r for r in _actor_records(plane) if r["actor"] == "shrink"]
            assert len(got) == 2
            _same_shape(got[0], _ref_record(
                tmp_path, "shrink", "world", 3, 2, consensus_seq=1,
                evidence={"dead": [2]}))
        finally:
            for p in peers:
                p.close()
            chaos.reset()


# -- the tools -----------------------------------------------------------------

#: the view sections kftop renders, each removable
SECTIONS = ("serving", "pulse", "xray", "alerts", "skew", "slices",
            "controls")


@pytest.fixture(scope="module")
def full_view(tmp_path_factory):
    """A reference /cluster view with every section: three ranks, two
    slices, serving and pulse gauges, xray spans, a shrink control, an
    attached sentinel with a fired alert and a judged decision."""
    for mod in (ledger, jledger):
        mod.reset()
    root = str(tmp_path_factory.mktemp("view"))
    clock = [1000.0]
    agg = jagg.ClusterAggregator(stale_after=1.0, time_fn=lambda: clock[0])
    s = jsentinel.Sentinel(root, period_s=0.0, step_ceiling_s=0.15,
                           window=2)
    agg.attach_sentinel(s)
    s.ledger.decide("bandit-host", "strategy", "STAR", "RING", wall=1.0,
                    trace_id="t", step=1)
    for i, rows in enumerate(_snapshots(steps=8, onset=4)):
        for row in rows:
            r = row["rank"]
            row = dict(row, slice=r // 2)
            if r == 1:
                row["counters"] = dict(row["counters"], **{
                    'kf_serve_requests_total{what="complete"}': 7})
                row["gauges"] = dict(row["gauges"], kf_kv_cache_bytes=1e6,
                                     kf_serve_active_requests=2.0,
                                     kf_grad_variance=0.25)
                row["latency"] = {"kf_serve_e2e_seconds": {"count": 4,
                                                           "sum": 2.0}}
            agg.ingest(jagg.make_snapshot(wall=clock[0], **row))
        clock[0] += 0.5
    agg.ingest(jagg.control_event("shrink", rank=0, dead=[4], version=2))
    clock[0] += 2.0
    view = json.loads(json.dumps(agg.cluster_view(
        {"version": 2, "size": 3, "workers": ["h:1", "h:2", "h:3"]})))
    for mod in (ledger, jledger):
        mod.reset()
    return view


class TestTools:
    def test_render_view_full(self, full_view):
        for sec in SECTIONS:
            assert full_view.get(sec), sec
        text = kftop.render_view(full_view)
        assert text == jkftop.render_view(full_view)
        assert text == jkftop.render_view(full_view, top=10)
        for part in ("== ALERTS", "== XRAY", "== PULSE", "== serving",
                     "watermark:step_time"):
            assert part in text, part
        assert kftop.render_view(full_view, top=2) == \
            jkftop.render_view(full_view, top=2)

    @pytest.mark.parametrize("section", SECTIONS)
    def test_render_view_without(self, full_view, section):
        view = dict(full_view)
        view.pop(section)
        assert kftop.render_view(view) == jkftop.render_view(view)
        view[section] = None
        assert kftop.render_view(view) == jkftop.render_view(view)

    @pytest.mark.parametrize("tool", ["kfhist", "kftop"])
    def test_self_check(self, tool):
        r = subprocess.run([sys.executable, "-m",
                            f"kungfu_tpu_torch.monitor.{tool}",
                            "--self-check"], capture_output=True, text=True,
                           timeout=120, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "self-check ok" in r.stdout

    def test_kfhist_cli_list_and_verdict(self, tmp_path):
        ring = history.HistoryRing(str(tmp_path), "cluster",
                                   keep_bytes=1 << 20, segment_records=8)
        for i in range(24):
            ring.append({"kfhist": 1, "wall": float(i),
                         "series": {"step_time_s": 0.1 if i < 16 else 0.25}})
        outs = []
        for args in (["--list", "--json"],
                     ["--verdict", "--window", "4", "--json"],
                     ["--verdict", "--window", "4", "--upto", "16",
                      "--json"]):
            got = kfhist.main(["--dir", str(tmp_path)] + args)
            r = subprocess.run([sys.executable, "-m",
                                "kungfu_tpu_torch.monitor.kfhist", "--dir",
                                str(tmp_path)] + args, capture_output=True,
                               text=True, timeout=120, cwd=ROOT)
            assert got == 0 and r.returncode == 0, r.stderr
            outs.append(json.loads(r.stdout))
        assert outs[0]["cluster"]["records"] == 24
        v = outs[1]["verdicts"]["step_time_s"]
        assert v["shifted"] and v["direction"] == "up"
        assert not outs[2]["verdicts"]["step_time_s"]["shifted"]
        assert outs[1] == jkfhist.verdict_from_dir(str(tmp_path), window=4)


# -- routes, policy, launcher, compile feed -------------------------------------

def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return r.status, json.loads(r.read().decode())


class TestRoutesAndPolicy:
    def test_alerts_and_decisions_404_then_200(self, tmp_path):
        agg = tagg.ClusterAggregator(stale_after=60.0)
        srv = ConfigServer(port=0, aggregator=agg).start()
        try:
            for route in ("/alerts", "/decisions"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(srv.port, route)
                assert e.value.code == 404
            s = tsentinel.Sentinel(str(tmp_path), window=4,
                                   step_ceiling_s=0.2, period_s=0.0)
            agg.attach_sentinel(s)
            s.ledger.decide("batch-width", "width", 4, 5, wall=0.0)
            agg.ingest(tagg.make_snapshot(rank=0, step=1, step_time_s=0.5))
            code, alerts = _get(srv.port, "/alerts")
            assert code == 200 and alerts["kfsentinel"] == 1
            assert alerts["active"] == ["watermark:step_time"]
            code, dec = _get(srv.port, "/decisions")
            assert code == 200 and dec["kfledger"] == 1
            assert dec["decisions"][0]["decision"]["actor"] == "batch-width"
            _, view = _get(srv.port, "/cluster")
            assert view["alerts"]["active"] == alerts["active"]
        finally:
            srv.stop()

    def test_sentinel_signals_equal(self, tmp_path, full_view):
        from kungfu_tpu.policy import sentinel_signals as jsignals
        from kungfu_tpu_torch.policy import sentinel_signals

        assert sentinel_signals(full_view) == jsignals(full_view)
        assert sentinel_signals(full_view)["watermarks"] == ["step_time"]
        assert sentinel_signals(full_view["alerts"]) == \
            jsignals(full_view["alerts"])
        assert sentinel_signals({"ranks": []}) is None
        s = tsentinel.Sentinel(str(tmp_path), window=4)
        for i in range(12):
            s.observe({"wall": float(i), "ranks": [_row(i, 0.1 if i < 8
                                                        else 0.3)]})
        sig = sentinel_signals(s.alerts_view())
        assert sig == jsignals(s.alerts_view())
        assert sig["regressing"] == ["step_time_s"] and sig["firing"]


def _free_base(n):
    for _ in range(50):
        base = int(np.random.default_rng().integers(20000, 60000))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise OSError("no free port range")


def test_launcher_sentinel(tmp_path):
    """``-sentinel DIR`` turns on the monitor, attaches the sentinel to
    the builtin server's aggregator and writes the cluster stream."""
    d = tmp_path / "sentinel"
    base = _free_base(4)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               KF_SOCK_DIR=str(tmp_path), KF_SENTINEL_PERIOD="0.5")
    for k in ("KF_CHAOS_SPEC", "KF_CONFIG_ENABLE_MONITORING",
              "KF_JAX_PLATFORM", "KF_SENTINEL_DIR"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch", "-backend", "cpu", "-np",
         "2", "-H", "127.0.0.1:3", "-self", "127.0.0.1", "-port-range",
         f"{base}-{base + 3}", "-monitor-interval", "0.5", "-sentinel",
         str(d), sys.executable, "-m", "kungfu_tpu_torch.examples.mnist_slp",
         "--n-epochs", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    recs = history.read_stream(str(d), "cluster")
    assert recs and all(rec["kfhist"] == 1 for rec in recs)
    # a sample is taken on an ingest, so each one has the ranks' rows
    assert all("egress_bytes" in rec["series"] for rec in recs)
    out = subprocess.run([sys.executable, "-m",
                          "kungfu_tpu_torch.monitor.kfhist", "--dir", str(d),
                          "--verdict"], capture_output=True, text=True,
                         timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr


class TestCompileFeed:
    def test_install_idempotent_and_ticks(self):
        c = REGISTRY.counter("kf_jit_compiles_total")
        h = REGISTRY.histogram("kf_jit_compile_seconds")
        assert metrics.install_compile_metrics() is True
        assert metrics.install_compile_metrics() is True
        before, n = c.value, h.count
        metrics.note_compile(0.25)
        assert c.value == before + 1 and h.count == n + 1
        metrics.note_compile(0.5)
        assert c.value == before + 2

    def test_capture_calls_note_compile(self):
        """The engine's CUDA-graph capture is the compile the counter
        counts: its ``graphed`` closure calls ``note_compile``."""
        import inspect

        from kungfu_tpu_torch.serve import engine

        src = inspect.getsource(engine.InferenceEngine._capture)
        assert "note_compile(time.perf_counter() - t0)" in src
        assert engine.note_compile is metrics.note_compile

    def test_snapshot_carries_compiles(self, tmp_path):
        metrics.install_compile_metrics()
        rep = tagg.RankReporter(0, "http://127.0.0.1:1/get")
        metrics.note_compile(0.1)
        snap = rep.snapshot_once()
        assert snap["counters"]["kf_jit_compiles_total"] >= 1
        assert tsentinel.extract_series({"ranks": [snap]})[
            "jit_compiles"] >= 1
