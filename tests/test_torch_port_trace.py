"""Port parity: the trace tools and the rest (``utils/trace.py``'s
``traced``, ``trace_report``, ``reset_trace_stats`` and ``device_trace``,
``timeline.trace_ctx``, ``monitor/traceview.py`` (kftrace), the native
sanitizer variants and ``stress.cpp``, and the ``kungfu_tpu_torch.torch``
shim) against the JAX package.

* the same traced call sequence gives the reference's report names and
  counts, and the same ``trace_ctx`` nesting the reference's trace and
  parent fields;
* each package's kftrace loads the other's timeline dumps; the Chrome
  trace, the straggler report and ``--critical-path`` are equal;
* ``device_trace`` with the CPU named writes a Chrome trace; asked for
  the card without one, it raises;
* the sanitizer variants' names, stamps and loader selection follow the
  reference Makefile's; a variant that does not build raises; the TSan
  churn of ``stress.cpp`` is ``slow``, as the reference's is;
* the torch shim over port engines is bitwise the reference's over
  reference engines at n = 1, 2, 3, and so is ``SynchronousSGDOptimizer``
  after three steps.

Channels bind port 0 (the reference's take a free port and retry) with
``KF_TPU_USE_UNIXSOCK=0``; paths come from ``tmp_path``.
"""

import errno
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kungfu_tpu import plan as jplan
from kungfu_tpu.comm import engine as jengine
from kungfu_tpu.comm import host as jhost
from kungfu_tpu.monitor import timeline as jtimeline
from kungfu_tpu.monitor import traceview as jtraceview
from kungfu_tpu.monitor import xray as jxray
from kungfu_tpu.torch.ops import collective as jcoll
from kungfu_tpu.torch.optimizers.sync_sgd import \
    SynchronousSGDOptimizer as JSyncSGD
from kungfu_tpu.utils import trace as jtrace
from kungfu_tpu_torch import native
from kungfu_tpu_torch import plan as tplan
from kungfu_tpu_torch.comm import engine as tengine
from kungfu_tpu_torch.comm import host as thost
from kungfu_tpu_torch.monitor import timeline, traceview
from kungfu_tpu_torch.monitor import xray as txray
from kungfu_tpu_torch.torch.ops import clib
from kungfu_tpu_torch.torch.ops import collective as tcoll
from kungfu_tpu_torch.torch.optimizers.sync_sgd import SynchronousSGDOptimizer
from kungfu_tpu_torch.utils import trace
from tests._util import run_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for k in ("KF_CONFIG_ENABLE_TRACE", "KF_NATIVE_SANITIZE",
              "KF_CHAOS_SPEC"):
        monkeypatch.delenv(k, raising=False)
    for mod in (trace, jtrace):
        mod.reset_trace_stats()
    for mod in (timeline, jtimeline):
        mod.reset()
    yield
    for mod in (trace, jtrace):
        mod.reset_trace_stats()
    for mod in (timeline, jtimeline):
        mod.reset()


# -- traced / trace_report -----------------------------------------------------

def _traced_program(mod):
    @mod.traced
    def step(x):
        return x + 1

    @mod.traced(name="named-op")
    def named(x):
        with mod.trace_scope("inner", force=True):
            return x * 2

    for i in range(3):
        step(i)
    for i in range(2):
        named(i)
    with pytest.raises(ValueError):
        with mod.trace_scope("boom", force=True):
            raise ValueError("x")
    mod.record_duration("span-fed", 0.004)
    return {k: v["count"] for k, v in mod.trace_report().items()}, \
        {k: sorted(v) for k, v in mod.trace_report().items()}


class TestTraced:
    def test_counts_and_names_match(self, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        got, want = _traced_program(trace), _traced_program(jtrace)
        assert got == want
        assert got[0]["named-op"] == 2 and got[0]["inner"] == 2
        assert any(k.endswith("step") for k in got[0])

    def test_disabled_records_nothing(self):
        @trace.traced
        def f():
            return 1

        assert f() == 1
        assert trace.trace_report() == {} == jtrace.trace_report()

    def test_reset_and_tails(self, monkeypatch):
        for ms in (1.0, 2.0, 3.0, 40.0):
            trace.record_duration("op", ms / 1e3)
            jtrace.record_duration("op", ms / 1e3)
        a, b = trace.trace_report()["op"], jtrace.trace_report()["op"]
        assert a == b and a["count"] == 4 and a["p95_ms"] >= a["p50_ms"]
        trace.reset_trace_stats()
        assert trace.trace_report() == {}

    def test_span_feeds_the_report(self, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        with timeline.span("collective", "engine.all_reduce", rank=0):
            pass
        assert trace.trace_report()["engine.all_reduce"]["count"] == 1


# -- trace_ctx -----------------------------------------------------------------

def _ctx_program(tl):
    tl.reset()
    tl.set_rank(0)
    with tl.trace_ctx("srv.7", "s0.router"):
        with tl.span("serve", "prefill", rank=0, force=True, tokens=4):
            tl.event("request", "accept", rank=0, force=True, rid="r1")
            with tl.span("serve", "decode", rank=0, force=True):
                pass
        tl.event("mark", "after", rank=0, force=True)
        with tl.trace_ctx("other", None):
            tl.event("mark", "inner", rank=0, force=True)
    tl.event("mark", "outside", rank=0, force=True)
    with tl.trace_ctx(None):
        tl.event("mark", "none", rank=0, force=True)
    out = [(e["kind"], e["name"], e["step"], dict(e["attrs"]))
           for e in tl.snapshot()]
    tl.set_rank(None)
    return out


class TestTraceCtx:
    def test_fields_match(self):
        got, want = _ctx_program(timeline), _ctx_program(jtimeline)
        assert got == want
        by = {n: a for _, n, _, a in got}
        assert by["prefill"]["trace"] == "srv.7"
        assert by["prefill"]["parent"] == "s0.router"
        assert by["accept"]["parent"] == by["prefill"]["span"]
        assert by["decode"]["parent"] == by["prefill"]["span"]
        assert by["inner"]["trace"] == "other"
        assert "trace" not in by["outside"]

    def test_context_restored(self):
        assert timeline.current_trace() == (None, None)
        with timeline.trace_ctx("a", "b") as c:
            assert c.trace == "a" and timeline.current_trace() == ("a", "b")
        assert timeline.current_trace() == (None, None)


# -- kftrace -------------------------------------------------------------------

def _append_rank(tl, r, rng, slow, steps):
    """Rank ``r``'s events of one seeded run: per step an input span, a
    step mark and a collective span (rank ``slow`` 50 ms late from step 3
    on, with a chaos mark there)."""
    for i in range(steps):
        tl.set_step(i)
        t = 100.0 + i * 0.2 + r * 1e-3
        tl._append(t, r, "input", "batch.next", 0.002, {})
        tl._append(t + 0.003, r, "mark", "step", 0.0, {})
        dur = 0.01 + (0.05 if r == slow and i >= 3 else 0.0) \
            + 1e-4 * float(rng.random())
        tl._append(t + 0.004, r, "collective", "engine.all_reduce", dur,
                   {"op": "all_reduce", "tag": f"g{i}", "nbytes": 64,
                    "trace": f"c{i}"})
        if i == 3 and r == slow:
            tl._append(t + 0.005, r, "chaos", "delay", 0.0, {"ms": 50})


def _record_ranks(tl, root, tag, slow=1, steps=6):
    """Three ranks' dumps of one seeded run (:func:`_append_rank`), each
    written by ``tl.dump`` from a ring of its own."""
    rng = np.random.default_rng(2)
    paths = []
    for r in range(3):
        tl.reset()
        tl.set_rank(r)
        _append_rank(tl, r, rng, slow, steps)
        path = os.path.join(root, f"{tag}-rank{r}.jsonl")
        assert tl.dump(path) == 3 * steps + (r == slow)
        paths.append(path)
    tl.set_rank(None)
    tl.set_step(-1)
    tl.reset()
    return paths


class TestKftrace:
    @pytest.fixture
    def dumps(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        return {"port": _record_ranks(timeline, str(tmp_path), "port"),
                "ref": _record_ranks(jtimeline, str(tmp_path), "ref")}

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_cross_load_and_outputs(self, dumps, writer):
        paths = dumps[writer]
        a, b = traceview.load_all(paths), jtraceview.load_all(paths)
        assert a == b and {e["rank"] for e in a} == {0, 1, 2}
        assert traceview.chrome_trace(a) == jtraceview.chrome_trace(b)
        rep = traceview.render_report(a)
        assert rep == jtraceview.render_report(b)
        assert "straggler verdict: rank 1" in rep
        assert txray.render_report(a) == jxray.render_report(b)

    def test_dumps_equal_across_packages(self, dumps):
        assert traceview.load_all(dumps["port"]) == \
            jtraceview.load_all(dumps["ref"])

    def test_rank_dumps_of_one_ring(self, dumps, tmp_path):
        # three ranks sharing one process's ring, each dumped with
        # ``rank``: what each rank's own process writes
        rng = np.random.default_rng(2)
        timeline.reset()
        for r in range(3):
            _append_rank(timeline, r, rng, 1, 6)
        timeline.set_step(-1)
        paths = [str(tmp_path / f"one-rank{r}.jsonl") for r in range(3)]
        try:
            assert [timeline.dump(p, rank=r) for r, p in enumerate(paths)] \
                == [18, 19, 18]
        finally:
            timeline.reset()
        for r, p in enumerate(paths):
            header, events = jtraceview.load_dump(p)
            assert header["rank"] == r
            assert {e["rank"] for e in events} == {r}
        assert traceview.load_all(paths) == jtraceview.load_all(dumps["ref"])

    def test_cli(self, dumps, tmp_path, capsys):
        paths = dumps["ref"]
        out = tmp_path / "trace.json"
        assert traceview.main(["merge", "-o", str(out)] + paths) == 0
        import json

        merged = json.load(open(out))
        assert merged == jtraceview.chrome_trace(jtraceview.load_all(paths))
        capsys.readouterr()
        assert traceview.main(["--critical-path"] + paths) == 0
        got = capsys.readouterr().out
        assert jtraceview.main(["--critical-path"] + paths) == 0
        assert got == capsys.readouterr().out
        assert traceview.main(["report"] + paths) == 0
        got = capsys.readouterr().out
        assert jtraceview.main(["report"] + paths) == 0
        assert got == capsys.readouterr().out
        assert traceview.main(["--critical-path"]) == 2

    def test_self_check_and_bad_dump(self, tmp_path):
        assert traceview.main(["--self-check"]) == 0
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"kftrace": 1}\n{"ts": 1}\n')
        with pytest.raises(traceview.DumpError):
            traceview.load_dump(str(bad))
        with pytest.raises(jtraceview.DumpError):
            jtraceview.load_dump(str(bad))
        assert traceview.main(["--self-check", str(bad)]) == 1
        r = subprocess.run([sys.executable, "-m",
                            "kungfu_tpu_torch.monitor.traceview",
                            "--self-check"], capture_output=True, text=True,
                           timeout=120, cwd=ROOT)
        assert r.returncode == 0 and "self-check ok" in r.stdout

    def test_live_dump_loads_in_reference(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.set_rank(2)
        with timeline.trace_ctx("t", "p"):
            with timeline.span("collective", "engine.all_reduce", rank=2,
                               op="all_reduce", tag="x"):
                timeline.event("chaos", "delay", rank=2, ms=1)
        path = str(tmp_path / "d.jsonl")
        timeline.dump(path)
        timeline.set_rank(None)
        header, events = jtraceview.load_dump(path)
        assert header["rank"] == 2 and len(events) == 2
        assert traceview.load_dump(path) == (header, events)


# -- device_trace --------------------------------------------------------------

class TestDeviceTrace:
    def test_cpu_named_writes_a_trace(self, tmp_path):
        import json

        d = tmp_path / "trace"
        with trace.device_trace(str(d), force=True, device="cpu") as prof:
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
        files = os.listdir(d)
        assert len(files) == 1 and files[0].endswith(".json")
        doc = json.load(open(d / files[0]))
        names = {e.get("name") for e in doc["traceEvents"]}
        assert any("mm" in str(n) for n in names)
        assert any("mm" in e.name for e in prof.events())

    def test_off_without_force_or_env(self, tmp_path):
        with trace.device_trace(str(tmp_path / "t")) as prof:
            pass
        assert prof is None and not (tmp_path / "t").exists()

    def test_env_enables(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        with trace.device_trace(str(tmp_path / "t"), device="cpu") as prof:
            torch.zeros(3).add_(1)
        assert prof is not None and os.listdir(tmp_path / "t")

    def test_card_asked_without_one_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with trace.device_trace(str(tmp_path / "t"), force=True):
                pass
        assert not (tmp_path / "t").exists()


# -- native sanitizer variants ---------------------------------------------------

_toolchain = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


def _tsan_supported() -> bool:
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-x", "c++", "-", "-o", os.devnull],
        input=b"int main(){return 0;}", capture_output=True, timeout=60)
    return probe.returncode == 0


class TestSanitizerBuilds:
    def test_loader_selects_variant_path(self, monkeypatch):
        from kungfu_tpu import native as jnative

        for val, name in (("tsan", "libkfnative-tsan.so"),
                          ("asan", "libkfnative-asan.so"),
                          ("TSan ", "libkfnative-tsan.so"),
                          ("nonsense", "libkfnative.so"),
                          ("", "libkfnative.so")):
            monkeypatch.setenv("KF_NATIVE_SANITIZE", val)
            assert native.lib_path().endswith("_build/" + name)
            assert os.path.basename(jnative._lib_path()) == name
        monkeypatch.delenv("KF_NATIVE_SANITIZE")
        assert native.lib_path().endswith("_build/libkfnative.so")

    def test_flags_follow_the_makefile(self):
        text = open(os.path.join(ROOT, "kungfu_tpu", "native",
                                 "Makefile")).read()
        want = {"": "CXXFLAGS ?= -O3 $(BASEFLAGS)",
                "tsan": "TSANFLAGS ?= -O1 -g -fsanitize=thread $(BASEFLAGS)",
                "asan": "ASANFLAGS ?= -O1 -g -fsanitize=address "
                        "-fno-omit-frame-pointer $(BASEFLAGS)"}
        base = "-mtune=generic -fPIC -pthread -std=c++17 -Wall -Wextra"
        assert f"BASEFLAGS ?= $(ARCHFLAGS) -fPIC -pthread -std=c++17 " \
               f"-Wall -Wextra" in text
        for v, line in want.items():
            assert line in text
            head = line.split("?= ")[1].replace(" $(BASEFLAGS)", "")
            assert " ".join(native._cxx_flags(v)) == f"{head} {base}"

    @_toolchain
    def test_variant_names_and_stamps(self):
        if not _tsan_supported():
            pytest.skip("-fsanitize=thread does not link here")
        assert native._build("tsan") is True
        build = os.path.join(ROOT, "kungfu_tpu_torch", "native", "_build")
        assert os.path.exists(os.path.join(build, "libkfnative-tsan.so"))
        flags = open(os.path.join(build, ".buildflags-tsan")).read()
        assert "-fsanitize=thread" in flags
        assert native._build("") is True
        assert "-fsanitize" not in open(os.path.join(build,
                                                     ".buildflags")).read()

    @_toolchain
    def test_variant_that_does_not_build_raises(self, tmp_path):
        """A broken variant raises at every load; the plain library is
        never loaded in its place."""
        src = os.path.join(ROOT, "kungfu_tpu_torch", "native")
        dst = tmp_path / "native"
        dst.mkdir()
        for name in ("__init__.py", "reduce.cpp", "transport.cpp"):
            shutil.copy(os.path.join(src, name), dst / name)
        code = (
            "import importlib.util, os\n"
            f"spec = importlib.util.spec_from_file_location('kfn', "
            f"{str(dst / '__init__.py')!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "for _ in range(2):\n"
            "    try:\n"
            "        m.load()\n"
            "    except RuntimeError as e:\n"
            "        print('RAISED', 'asan' in str(e))\n"
            "print('PLAIN', os.path.exists(m.lib_path('')))\n")
        env = dict(os.environ, KF_NATIVE_SANITIZE="asan", CXX="false")
        out = subprocess.run([sys.executable, "-B", "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split("\n")[:3] == ["RAISED True", "RAISED True",
                                             "PLAIN False"]


@pytest.mark.slow
@_toolchain
class TestTSanStress:
    def test_channel_churn_clean_under_tsan(self, tmp_path):
        if not _tsan_supported():
            pytest.skip("-fsanitize=thread not supported here")
        binary = native.build_stress()
        env = dict(os.environ, TSAN_OPTIONS="halt_on_error=0 exitcode=66",
                   KF_SOCK_DIR=str(tmp_path))
        run = subprocess.run([binary, "4"], capture_output=True, timeout=480,
                             env=env)
        err = run.stderr.decode(errors="replace")
        assert run.returncode == 0, f"stress rc={run.returncode}\n{err[-2000:]}"
        assert "WARNING: ThreadSanitizer" not in err, err[-2000:]
        assert "all rounds clean" in err


# -- the torch shim ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_channel():
    for _ in range(20):
        try:
            return jhost.PyHostChannel(jplan.PeerID("127.0.0.1",
                                                    _free_port()),
                                       bind_host="127.0.0.1")
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
    raise RuntimeError("no free port for a reference channel")


class _World:
    """``n`` engines of one package over Python channels, STAR."""

    def __init__(self, pkg, n):
        if pkg == "port":
            self.chans = [thost.PyHostChannel(tplan.PeerID("127.0.0.1", 0),
                                              bind_host="127.0.0.1")
                          for _ in range(n)]
            peers = tplan.PeerList.of(*(c.self_id for c in self.chans))
            self.engines = [tengine.CollectiveEngine(c, peers,
                                                     tplan.Strategy.STAR)
                            for c in self.chans]
        else:
            self.chans = [_ref_channel() for _ in range(n)]
            peers = jplan.PeerList.of(*(c.self_id for c in self.chans))
            self.engines = [jengine.CollectiveEngine(c, peers,
                                                     jplan.Strategy.STAR)
                            for c in self.chans]

    def close(self):
        for e in self.engines:
            e.close()
        for c in self.chans:
            c.close()


def _bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return (str(t.dtype), tuple(t.shape), t.numpy().tobytes())


def _inputs(rank, dtype):
    g = torch.Generator().manual_seed(100 + rank)
    t = torch.randn(3, 257, generator=g) * 3
    return t.to(dtype) if dtype.is_floating_point else \
        (t * 10).to(dtype)


def _model(rank, dtype):
    """Rank ``rank``'s small model, made before the rank threads start:
    torch's seed is process-global."""
    torch.manual_seed(rank)
    return torch.nn.Linear(5, 3).to(dtype if dtype.is_floating_point
                                    else torch.float32)


def _shim_program(coll, engine, rank, dtype, model):
    """Every shim collective on rank ``rank``'s inputs; the results'
    bits."""
    x = _inputs(rank, dtype)
    out = [coll.all_reduce(x, op="sum", engine=engine, name="s")]
    if dtype.is_floating_point:
        out.append(coll.all_reduce(x, op="mean", engine=engine, name="m"))
        y = x.clone()
        h = [coll.all_reduce_async(y, op="mean", engine=engine, name="am"),
             coll.all_reduce_async(x.clone(), op="sum", engine=engine,
                                   name="as")]
        coll.wait_all_handles(h)
        out += [y, h[1][1]]
    out.append(coll.broadcast(x, root=0, engine=engine, name="b"))
    out.append(coll.all_gather(x, engine=engine, name="g"))
    coll.broadcast_parameters(model.state_dict(), engine=engine)
    out += list(model.state_dict().values())
    coll.broadcast_parameters(list(model.parameters()), root=0,
                              engine=engine)
    out += [p.detach() for p in model.parameters()]
    return [_bits(t) for t in out]


class TestTorchShim:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16, torch.int32])
    @pytest.mark.parametrize("n", [1, 2, 3])
    def test_collectives_bitwise(self, n, dtype):
        results = {}
        for pkg, coll in (("port", tcoll), ("ref", jcoll)):
            w = _World(pkg, n)
            models = {e.rank: _model(e.rank, dtype) for e in w.engines}
            try:
                # in rank order: a channel's port, not its index, sets
                # its rank, and the fold order follows the rank
                results[pkg] = sorted(run_all(
                    [lambda e=e: (e.rank, _shim_program(
                        coll, e, e.rank, dtype, models[e.rank]))
                     for e in w.engines], timeout=120))
            finally:
                w.close()
        assert results["port"] == results["ref"]

    def test_int_mean_rejected(self):
        for coll in (tcoll, jcoll):
            with pytest.raises(TypeError):
                coll.all_reduce(torch.ones(3, dtype=torch.int64), op="mean",
                                engine=object())
            with pytest.raises(TypeError):
                coll.all_reduce_async(torch.ones(3, dtype=torch.int32),
                                      op="mean", engine=object())

    def test_no_engine_is_identity(self, monkeypatch):
        """With no engine (a single process) every collective is the
        identity, as the reference's is."""
        monkeypatch.setattr(tcoll, "_default_engine", lambda: None)
        t = torch.randn(4)
        assert torch.equal(tcoll.all_reduce(t), t)
        assert torch.equal(tcoll.broadcast(t), t)
        assert tcoll.all_gather(t).shape == (1, 4)
        fut, same = tcoll.all_reduce_async(t)
        assert same is t and fut.result() is None
        tcoll.broadcast_parameters([t])

    def test_clib_roundtrip(self):
        for dt in clib.SUPPORTED_DTYPES:
            t = torch.arange(12).reshape(3, 4).to(dt)
            back = clib.from_numpy(clib.to_numpy(t), t)
            assert back.dtype == dt and back.device == t.device
            assert torch.equal(back.reshape(t.shape), t)
        with pytest.raises(TypeError):
            clib.to_numpy(torch.zeros(2, dtype=torch.complex64))

    @pytest.mark.parametrize("n", [2, 3])
    def test_sync_sgd_three_steps_bitwise(self, n):
        def make():
            torch.manual_seed(0)
            return torch.nn.Sequential(torch.nn.Linear(6, 8),
                                       torch.nn.Tanh(), torch.nn.Linear(8, 2))

        def rank_run(pkg_sync, engine, rank, m):
            opt = pkg_sync(torch.optim.SGD(m.parameters(), lr=0.1,
                                           momentum=0.9), engine=engine)
            g = torch.Generator().manual_seed(rank)
            for _ in range(3):
                x = torch.randn(5, 6, generator=g)
                opt.zero_grad()
                m(x).pow(2).sum().backward()
                opt.step()
            assert type(opt).__name__ == "KungFuSGD"
            return [_bits(p) for p in m.parameters()]

        results = {}
        for pkg, sync in (("port", SynchronousSGDOptimizer),
                          ("ref", JSyncSGD)):
            w = _World(pkg, n)
            models = [make() for _ in w.engines]
            try:
                results[pkg] = sorted(run_all(
                    [lambda e=e, m=m: (e.rank, rank_run(sync, e, e.rank, m))
                     for e, m in zip(w.engines, models)], timeout=120))
            finally:
                w.close()
        assert results["port"] == results["ref"]
        assert all(r[1] == results["port"][0][1] for r in results["port"])
