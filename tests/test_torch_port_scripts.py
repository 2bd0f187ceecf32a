"""Port parity: the repo root's scripts of the PyTorch/CUDA port against
the reference's.

* ``scripts/cluster_torch.py``: the cluster it seeds the config server
  with (``/reset``) equals ``scripts/cluster.py``'s byte for byte; its
  size scrape and its reader of the runners' logs over sample logs; one
  launch at ``--backend cpu --schedule 2:2,4:2,2:2``, which grows onto
  the host that started empty, shrinks away from it again and leaves no process behind; a
  ``slow`` launch at the reference's defaults, as
  ``tests/test_cluster_compose.py`` runs ``scripts/cluster.py``;
* ``scripts/check_torch.sh`` parses, runs the lint and self-check gates
  of ``scripts/check.sh`` and each of its six demo gates with the same
  timeout and success line; ``Makefile.torch`` has ``Makefile``'s demo
  targets, each running its gate;
* ``scripts/{kfhist,kftop,kftrace}_torch --self-check`` exit 0 with
  ``torch`` and ``numpy`` made unimportable, and print what ``python -m
  kungfu_tpu_torch.monitor.<tool> --self-check`` prints.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import uuid

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ct = _load("cluster_torch", os.path.join("scripts", "cluster_torch.py"))


def _read(*parts) -> str:
    with open(os.path.join(ROOT, *parts)) as f:
        return f.read()


# -- cluster_torch.py: the seed and the log readers ---------------------------

@pytest.mark.parametrize("hosts", [2, 3])
@pytest.mark.parametrize("np_", [2, 4])
def test_initial_cluster_matches_reference(hosts, np_):
    """``scripts/cluster.py:93-97``'s seed at the reference's port range."""
    from kungfu_tpu.plan import Cluster, HostList

    ref_spec = ",".join(f"127.0.0.{i + 1}:2" for i in range(hosts))
    hl = HostList.parse(ref_spec)
    want = Cluster(hl.gen_runner_list(), hl.gen_peer_list(np_)).to_json()
    spec = ct.host_spec(hosts, 2)
    assert spec == ref_spec
    assert ct.initial_cluster_json(spec, np_) == want


@pytest.mark.parametrize("hosts", [2, 3])
def test_initial_cluster_at_a_found_range(hosts):
    """The seed at the runners' port range, as the reference's plan
    builds it there."""
    from kungfu_tpu.plan import Cluster, HostList

    spec = ct.host_spec(hosts, 2)
    hl = HostList.parse(spec)
    want = Cluster(hl.gen_runner_list(),
                   hl.gen_peer_list(2, (24000, 24002))).to_json()
    assert ct.initial_cluster_json(spec, 2, (24000, 24002)) == want


def test_size_scrape(tmp_path):
    (tmp_path / "workers-127.0.0.1").mkdir()
    (tmp_path / "workers-127.0.0.2").mkdir()
    (tmp_path / "workers-127.0.0.1" / "worker-0.stdout.log").write_text(
        "worker 0/2 up (v0) on cpu\nstep 3: size 2 loss 2.8332\n"
        "worker 0: done at step 9, sizes seen [2, 4], resizes survived 2\n")
    (tmp_path / "workers-127.0.0.2" / "worker-2.stdout.log").write_text(
        "worker 2: detached at step 6\nsizes seen [4]\n")
    (tmp_path / "runner-127.0.0.1.log").write_text("no sizes here\n")
    # only .log files count, as in the reference's scrape
    (tmp_path / "notes.txt").write_text("sizes seen [7]\n")
    assert ct.sizes_observed(str(tmp_path)) == [2, 4]
    assert ct.sizes_observed(str(tmp_path / "workers-127.0.0.2")) == [4]
    assert ct.sizes_observed(str(tmp_path / "empty")) == []


RUNNER_LOG = """\
[kf-torch] 22:47:17 I watch: watching 127.0.0.2: 0 local worker(s) at v0
[kf-torch] 22:47:21 I watch: stage v1: 2 -> 4 workers (0 -> 2 on 127.0.0.2)
[kf-torch] 22:47:21 I watch: spawning worker-2 (v1)
\x1b[33m[worker-3]\x1b[0m worker 3/4 up (v1) on cpu
[kf-torch] 22:47:25 I watch: stage v2: 4 -> 2 workers (2 -> 0 on 127.0.0.2)
[kf-torch] 22:47:25 I watch: killing removed worker 127.0.0.2:10000
"""


def test_local_workers_reader():
    assert ct.local_workers(RUNNER_LOG) == [(0, 0), (1, 2), (2, 0)]
    assert ct.local_workers("") == []


def test_parser_matches_reference_defaults():
    """The reference's arguments and defaults, but ``--config-port`` (0:
    a port the server binds) and ``--backend``."""
    text = _read("scripts", "cluster.py")
    ref = dict(re.findall(r'ap\.add_argument\("(--[\w-]+)".*?default='
                          r'("[^"]*"|[^,)\n]+)', text, re.S))
    mine = {a.option_strings[0]: a.default
            for a in ct.build_parser()._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    assert set(mine) == set(ref) | {"--backend"}
    for opt, val in ref.items():
        if opt == "--config-port":
            assert (val, mine[opt]) == ("9190", 0)
        else:
            assert repr(mine[opt]) == val.replace('"', "'"), opt
    assert mine["--backend"] == "gpu"


# -- cluster_torch.py end to end on the host ---------------------------------

#: the harness's own limit and the test's, above it so that the
#: harness's timeout path and cleanup run first
CLUSTER_TIMEOUT_S, CLUSTER_TEST_TIMEOUT_S = 150, 180


def _run_cluster(tmp, args, timeout):
    """Run the harness in a session of its own; ``(rc, stdout, stderr,
    tag)``.  On a timeout its group is killed and every tagged process
    of the cluster ended."""
    tag = uuid.uuid4().hex
    env = dict(os.environ, OMP_NUM_THREADS="1", KF_SOCK_DIR=str(tmp),
               KF_CONFIG_WATCH_GRACE="3", **{ct.TAG_ENV: tag})
    for k in ("KF_CHAOS_SPEC", "KF_CONFIG_ENABLE_MONITORING",
              "KF_PERSIST_DIR", "KF_PERSIST_RESTORE", "KF_JAX_PLATFORM"):
        env.pop(k, None)
    p = subprocess.Popen([PY, os.path.join("scripts", "cluster_torch.py"),
                          *args], cwd=ROOT, env=env, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         start_new_session=True)
    try:
        so, se = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        so, se = p.communicate()
        se += f"\nTIMEOUT after {timeout} s"
    finally:
        ct.stop_cluster([], tag, grace=5.0)
    return p.returncode, so, se, tag


@pytest.fixture(scope="module")
def cpu_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster")
    logdir = tmp / "logs"
    rc, so, se, tag = _run_cluster(tmp, [
        "--backend", "cpu", "--schedule", "2:2,4:2,2:2", "--logdir",
        str(logdir), "--timeout", str(CLUSTER_TIMEOUT_S)],
        CLUSTER_TEST_TIMEOUT_S)
    return rc, so, se, tag, logdir


def _ok(run):
    rc, so, se = run[:3]
    assert rc == 0, so[-3000:] + se[-3000:]
    return json.loads(so.strip().splitlines()[-1])


def test_cpu_cluster_grows_and_shrinks(cpu_cluster):
    out = _ok(cpu_cluster)
    assert out["ok"] is True
    assert out["hosts"] == 2 and out["schedule"] == "2:2,4:2,2:2"
    # the grow crossed onto the empty host and every size was reached
    assert out["sizes_observed"] == [2, 4]
    assert out["logdir"] == str(cpu_cluster[4])


def test_cpu_cluster_host_stages(cpu_cluster):
    _ok(cpu_cluster)
    logdir = cpu_cluster[4]
    got = {h: ct.local_workers((logdir / f"runner-{h}.log").read_text())
           for h in ("127.0.0.1", "127.0.0.2")}
    assert got == {"127.0.0.1": [(0, 2), (1, 2), (2, 2)],
                   "127.0.0.2": [(0, 0), (1, 2), (2, 0)]}


def test_cpu_cluster_workers(cpu_cluster):
    _ok(cpu_cluster)
    logdir = cpu_cluster[4]
    text = {p.name: p.read_text() for p in logdir.glob("workers-*/*.log")}
    ups = [m for t in text.values() for m in re.findall(
        r"^worker (\d+)/(\d+) up \(v(\d+)\) on (\S+)$", t, re.M)]
    assert sorted(ups) == [("0", "2", "0", "cpu"), ("1", "2", "0", "cpu"),
                           ("2", "4", "1", "cpu"), ("3", "4", "1", "cpu")]
    losses = [float(x) for x in re.findall(
        r"^step \d+: size \d+ loss (\S+)$", text["worker-0.stdout.log"],
        re.M)]
    # six steps of one batch each: rank 0's two readings (steps 3 and
    # 6) are single batches and need not fall
    assert len(losses) == 2 and all(0 < x < 10 for x in losses), losses


def test_cpu_cluster_leaves_no_process(cpu_cluster):
    _ok(cpu_cluster)
    assert ct.tagged_pids(cpu_cluster[3]) == []


def test_tagged_pids_sees_a_tagged_child():
    tag = uuid.uuid4().hex
    p = subprocess.Popen([PY, "-c", "import time; time.sleep(60)"],
                         env=dict(os.environ, **{ct.TAG_ENV: tag}),
                         start_new_session=True)
    try:
        for _ in range(50):
            if ct.tagged_pids(tag):
                break
            time.sleep(0.1)
        assert ct.tagged_pids(tag) == [p.pid]
        assert ct.process_groups([p.pid]) == {p.pid}
        ct.stop_cluster([p], tag, grace=5.0)
        assert p.poll() is not None
        assert ct.tagged_pids(tag) == []
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.slow
def test_cluster_at_reference_defaults(tmp_path):
    """tests/test_cluster_compose.py's launch, the workers on the host."""
    rc, so, se, tag = _run_cluster(tmp_path, [
        "--schedule", "2:3,4:3,2:3", "--backend", "cpu", "--logdir",
        str(tmp_path / "logs")], 480)
    out = _ok((rc, so, se))
    assert out["ok"] is True
    assert out["sizes_observed"] == [2, 4]
    assert ct.tagged_pids(tag) == []


# -- check_torch.sh and Makefile.torch -----------------------------------------

#: the six demo gates of scripts/check.sh:143-237
DEMOS = ("multislice-demo", "adapt-demo", "serve-demo", "overlap-demo",
         "pp-demo", "persist-demo")
#: Makefile's demo targets (Makefile:114-202)
TARGETS = ("zero-demo", "multislice-demo", "adapt-demo", "serve-demo",
           "overlap-demo", "pp-demo", "persist-demo", "trace-demo")


def _ref_demo_gates() -> dict:
    """``{gate: (timeout s, success line)}`` of check.sh's bounded gates
    checked by a grep."""
    out = {}
    for block in re.split(r'^echo "== ', _read("scripts", "check.sh"),
                          flags=re.M)[1:]:
        t = re.search(r"timeout -k 10 (\d+)", block)
        g = re.search(r'grep -q "([^"]+)"', block)
        if t and g:
            out[block.split()[0]] = (int(t.group(1)), g.group(1))
    return out


def _port_demo_gates() -> dict:
    return {name: (int(t), line) for name, t, line in re.findall(
        r'^demo (\S+) (\d+) "([^"]+)"', _read("scripts", "check_torch.sh"),
        re.M)}


def test_check_torch_parses():
    r = subprocess.run(["bash", "-n", os.path.join(ROOT, "scripts",
                                                   "check_torch.sh")],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr


def test_reference_demo_gates_read():
    assert set(DEMOS) <= set(_ref_demo_gates())


@pytest.mark.parametrize("gate", DEMOS)
def test_demo_gate_matches_reference(gate):
    assert _port_demo_gates()[gate] == _ref_demo_gates()[gate]


def _lint_gates(text: str, prog: str) -> set:
    """The argument sets of each run of ``prog`` (continuations joined,
    the baseline dropped)."""
    text = text.replace("\\\n", " ")
    out = set()
    for args in re.findall(re.escape(prog) + r"((?: +[\w-]+)*)", text):
        words = [w for w in args.split() if w != "--baseline"]
        out.add(tuple(sorted(words)))
    return out


def test_lint_gates_match_reference():
    ref = _lint_gates(_read("scripts", "check.sh"), "python3 scripts/kflint")
    mine = _lint_gates(_read("scripts", "check_torch.sh"), '"${LINT[@]}"')
    assert ref == mine
    assert ("--proto",) in mine and len(mine) == 5


@pytest.mark.parametrize("tool", ["kftrace", "kftop", "kfhist"])
def test_self_check_gates(tool):
    assert f"python3 scripts/{tool} --self-check" in _read("scripts",
                                                           "check.sh")
    assert f"python3 scripts/{tool}_torch --self-check" in _read(
        "scripts", "check_torch.sh")


@pytest.mark.parametrize("target", TARGETS)
def test_make_targets(target):
    assert re.search(rf"^{re.escape(target)}:", _read("Makefile"), re.M)
    r = subprocess.run(["make", "-n", "-s", "-f", "Makefile.torch", target],
                       cwd=ROOT, capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["scripts/check_torch.sh", target]


def test_unknown_gate_refused():
    r = subprocess.run(["bash", os.path.join("scripts", "check_torch.sh"),
                        "no-such-gate"], cwd=ROOT, capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 2
    assert "unknown gate 'no-such-gate'" in r.stderr
    for target in TARGETS:
        assert target in r.stderr


# -- the standalone launchers ------------------------------------------------

#: imported by the launched interpreter: torch and numpy cannot be
#: imported at all
NO_TORCH = """\
import sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy"):
            raise ImportError(f"{name} is unimportable in this test")
        return None


sys.meta_path.insert(0, _Refuse())
"""


@pytest.fixture(scope="module")
def no_torch(tmp_path_factory):
    d = tmp_path_factory.mktemp("notorch")
    (d / "sitecustomize.py").write_text(NO_TORCH)
    return dict(os.environ, PYTHONPATH=str(d))


def test_no_torch_env_refuses_torch(no_torch):
    for mod in ("torch", "numpy"):
        r = subprocess.run([PY, "-c", f"import {mod}"], env=no_torch,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0 and "unimportable" in r.stderr


@pytest.mark.parametrize("tool,module", [("kfhist", "kfhist"),
                                         ("kftop", "kftop"),
                                         ("kftrace", "traceview")])
def test_launcher_self_check_without_torch(no_torch, tool, module):
    r = subprocess.run([PY, os.path.join(ROOT, "scripts", f"{tool}_torch"),
                        "--self-check"], env=no_torch, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = subprocess.run([PY, "-m", f"kungfu_tpu_torch.monitor.{module}",
                          "--self-check"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    assert r.stdout == ref.stdout
    assert "self-check ok" in r.stdout


# -- the persist drill's launch (ROADMAP C44) ----------------------------------

def test_persist_drill_names_its_worker_by_path(monkeypatch):
    """``preempt_restore``'s demo launches its workers as the reference's
    does, by the script's path: the launcher's parser may read a ``-m``
    after its positional program as an abbreviation of ``-monitor``."""
    from kungfu_tpu_torch.examples import preempt_restore

    seen = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def run(cmd, **kwargs):
        seen.append(cmd)
        return Done()

    monkeypatch.setattr(subprocess, "run", run)
    preempt_restore._kfrun(2, "/nonexistent", 6, "cpu", "preempt:all,step=3")
    cmd = seen[0]
    prog = cmd.index(sys.executable, 1)
    assert cmd[prog + 1:] == [os.path.abspath(preempt_restore.__file__),
                              "--worker", "--n-steps", "6"]
    assert cmd[1:3] == ["-m", "kungfu_tpu_torch"]
    assert "-m" not in cmd[3:]
