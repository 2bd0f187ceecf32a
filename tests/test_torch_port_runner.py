"""Port parity: the launcher (``kungfu_tpu_torch/runner/``, ``python -m
kungfu_tpu_torch``) and its examples against the JAX package's.

* ``build_parser``: the reference's option strings, destinations,
  defaults, types and actions, but ``-backend``'s choices (C24);
* ``Job.new_proc``'s env over a table of clusters equals the reference's
  key for key, but ``PYTHONPATH``, the two timestamps and the backend's
  keys; under ``-backend cpu`` byte for byte;
* the helpers (``patch_args``, ``find_epochs``, ``parse_period``,
  ``strip_preempt``, ``parse_port_range``, ``build_hostlist``,
  ``build_cluster``, ``infer_self_ip``) on tables of inputs, the SSH
  tools' argv through a shim, ``run_all``'s fail-fast wait and its log
  files, ``launch_multiprocess`` with two CPU ranks;
* end to end, each launch in its own subprocess on the CPU
  (``-backend cpu``), all started together: the port's SLP at ``-np 2``,
  a failing worker, the reference's own ``examples/mnist_slp.py`` under
  the port's launcher, ``failure_recovery`` through a crash (its final
  checkpoint bitwise an uninterrupted run's) and through a stall,
  ``preempt_restore`` relaunched after ``DIE_EXIT_CODE``, ``elastic_mnist``
  grown from 1 to 2 workers under ``-w``, and a ``-backend gpu`` worker
  with no card, which fails;
* the SLP's S-SGD epoch against the reference's at the same params and
  data.

A launch that binds a fixed port (the failure detector's 7756, the watch
runner's 38080) runs its workers on a loopback alias of its own
(``127.0.18.x``); every other port is found free.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np
import pytest
import torch

from kungfu_tpu.runner import cli as jcli
from kungfu_tpu.runner import discovery as jdisc
from kungfu_tpu.runner import job as jjob
from kungfu_tpu.runner import monitored as jmon
from kungfu_tpu.runner import proc as jproc
from kungfu_tpu.runner import remote as jremote
from kungfu_tpu.runner import supervise as jsup
from kungfu_tpu_torch.runner import cli as tcli
from kungfu_tpu_torch.runner import discovery as tdisc
from kungfu_tpu_torch.runner import job as tjob
from kungfu_tpu_torch.runner import monitored as tmon
from kungfu_tpu_torch.runner import proc as tproc
from kungfu_tpu_torch.runner import remote as tremote
from kungfu_tpu_torch.runner import supervise as tsup
from kungfu_tpu_torch.runner.mp import launch_multiprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the parser --------------------------------------------------------------

def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_matches_reference():
    mine, ref = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert sorted(mine) == sorted(ref)
    for dest, a in ref.items():
        b = mine[dest]
        assert (b.option_strings, type(b), b.default, b.type, b.nargs) == \
            (a.option_strings, type(a), a.default, a.type, a.nargs), dest
        if dest != "backend":
            assert b.choices == a.choices, dest
    assert mine["backend"].choices == ["cpu", "gpu"]
    assert ref["backend"].choices == ["cpu", "tpu"]


@pytest.mark.parametrize("argv", [
    ["python3", "x.py"],
    ["-np", "4", "-H", "10.0.0.1:2,10.0.0.2:2", "-self", "10.0.0.2",
     "-strategy", "RING", "-port-range", "12000-12100", "-w", "python3",
     "x.py", "--", "--n-epochs", "3"],
    ["-auto-recover", "4s", "-compile-grace", "30s", "-logdir", "/l", "-q",
     "-timeout", "9", "-chaos", "die:step=5,rank=1", "-chaos-seed", "3",
     "-num-slices", "2", "-monitor", "-monitor-interval", "0.5", "-trace",
     "-trace-dump", "/d", "-backend", "cpu", "prog", "-a", "-b"],
])
def test_parse_args_match(argv):
    got = vars(tcli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    assert got == want


# -- the job env ---------------------------------------------------------------

#: (hosts, np, Job keywords): one row a cluster of the env table
CLUSTERS = [
    ("127.0.0.1:1", 1, {}),
    ("127.0.0.1:2", 2, {}),
    ("127.0.0.1:2,127.0.0.2:2", 4, {}),
    ("127.0.0.1:4", 4, {"slices": 2}),
    ("127.0.0.1:2", 2, {"config_server": "http://127.0.0.1:9100/get"}),
    ("127.0.0.1:2", 2, {"parent": "127.0.0.1:38080"}),
    ("127.0.0.1:2", 2, {"strategy": "RING"}),
    ("127.0.0.1:2", 2, {"device_strategy": "ring",
                        "extra_envs": {"KF_CHAOS_SPEC": "die:step=1"}}),
]
#: the keys the port's env may differ in (gpu backend against the
#: reference's tpu backend)
VARYING = ("PYTHONPATH", "KF_JOB_START_TIMESTAMP", "KF_PROC_START_TIMESTAMP",
           "JAX_PLATFORMS", "KF_JAX_PLATFORM")


def _job_envs(mod_job, mod_plan, hosts, np_, kw, backend):
    hl = mod_plan.HostList.parse(hosts)
    cluster = mod_plan.Cluster(hl.gen_runner_list(38080),
                               hl.gen_peer_list(np_, (10000, 11000)))
    kw = dict(kw)
    if "strategy" in kw:
        kw["strategy"] = mod_plan.parse_strategy(kw["strategy"])
    if "parent" in kw:
        kw["parent"] = mod_plan.parse_peer_id(kw["parent"])
    job = mod_job.Job(prog="python3", args=["x.py", "--a"], log_dir="/l",
                      backend=backend, job_start=1234.5, **kw)
    out = []
    for h in hl.hosts:
        for p in job.create_procs(cluster, h.ip):
            out.append((p.name, p.prog, p.args, p.log_dir, p.envs))
    return out


@pytest.mark.parametrize("hosts,np_,kw", CLUSTERS)
def test_job_env_matches_reference(monkeypatch, hosts, np_, kw):
    from kungfu_tpu import plan as jplan
    from kungfu_tpu_torch import plan as tplan

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    ref_cpu = _job_envs(jjob, jplan, hosts, np_, kw, "cpu")
    ref_tpu = _job_envs(jjob, jplan, hosts, np_, kw, "tpu")
    mine_cpu = _job_envs(tjob, tplan, hosts, np_, kw, "cpu")
    mine_gpu = _job_envs(tjob, tplan, hosts, np_, kw, "gpu")
    assert len(ref_cpu) == np_
    # -backend cpu: byte for byte, the backend's keys included
    assert mine_cpu == ref_cpu
    # -backend gpu: the reference's tpu backend, its fixed world's
    # coordinator keys included
    for (*head, env), (*jhead, jenv) in zip(mine_gpu, ref_tpu):
        assert head == jhead
        assert {k: v for k, v in env.items() if k not in VARYING} == \
            {k: v for k, v in jenv.items() if k not in VARYING}
        # the card: no platform keys, so the worker's peer uses the card
        assert "KF_JAX_PLATFORM" not in env and "JAX_PLATFORMS" not in env
        assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT


def test_job_refuses_multi_card():
    with pytest.raises(NotImplementedError, match="not a backend"):
        tjob.Job(prog="p", args=[], backend="tpu")
    with pytest.raises(ValueError):
        tjob.Job(prog="p", args=[], backend="mps")
    assert tjob.Job(prog="p", args=[]).backend == "gpu"


# -- the helpers -------------------------------------------------------------

POD = {"TPU_WORKER_HOSTNAMES": "10.0.0.1,10.0.0.2,10.0.0.3",
       "TPU_WORKER_ID": "1"}


@pytest.mark.parametrize("env,argv", [
    (POD, []), (POD, ["-np", "1"]), (POD, ["-np", "8"]),
    (POD, ["-H", "127.0.0.1:2"]), (POD, ["-platform", "none"]),
    (POD, ["-backend", "cpu"]), ({}, []),
])
def test_apply_platform(monkeypatch, env, argv):
    """The pod contract fills -H, -self and -np as the reference's does;
    the backend it assigns is the card (C24)."""
    for k in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
              "MEGASCALE_NUM_SLICES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = tcli.build_parser().parse_args(argv + ["python3", "x"])
    want = jcli.build_parser().parse_args(argv + ["python3", "x"])
    tcli.apply_platform(got)
    jcli.apply_platform(want)
    if want.backend == "tpu":
        assert got.backend == "gpu"
        got.backend = want.backend
    assert vars(got) == vars(want)


@pytest.mark.parametrize("args", [
    ["--n-epochs", "4"], ["--n-epochs=4", "--restart", "0"], [],
    ["--lr", "1", "--restart=0"], ["--n-epochs"], ["--restart"],
])
@pytest.mark.parametrize("remaining", [1, 3])
def test_patch_and_find_epochs(args, remaining):
    for flag in ("--n-epochs", "--epochs"):
        assert tmon.patch_args(args, remaining, flag) == \
            jmon.patch_args(args, remaining, flag)
        try:
            want = jmon.find_epochs(args, flag)
        except ValueError:
            with pytest.raises(ValueError):
                tmon.find_epochs(args, flag)
            continue
        assert tmon.find_epochs(args, flag) == want


@pytest.mark.parametrize("spec", ["10s", "2m", "250ms", "7", " 1.5s ",
                                  "x", "10h", ""])
def test_parse_period(spec):
    try:
        want = jmon.parse_period(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tmon.parse_period(spec)
        return
    assert tmon.parse_period(spec) == want


@pytest.mark.parametrize("spec", [
    "", "preempt:all,step=3", "die:step=5,rank=1;preempt:all,step=2",
    " delay:ms=5 ; preempt:rank=0 ;; reset:p=0.1", "preempt"])
def test_strip_preempt(spec):
    assert tsup.strip_preempt(spec) == jsup.strip_preempt(spec)


@pytest.mark.parametrize("spec", ["10000-11000", "1-2", "5"])
def test_parse_port_range(spec):
    try:
        want = jcli.parse_port_range(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tcli.parse_port_range(spec)
        return
    assert tcli.parse_port_range(spec) == want


@pytest.mark.parametrize("ns", [
    dict(hostfile="", hosts="", self_host="127.0.0.1", np=None),
    dict(hostfile="", hosts="", self_host="10.1.1.1", np=3),
    dict(hostfile="", hosts="10.0.0.1:2,10.0.0.2:3:pub", self_host="x",
         np=5),
    dict(hostfile="HOSTFILE", hosts="", self_host="x", np=4),
])
def test_build_hostlist_and_cluster(tmp_path, ns):
    hf = tmp_path / "hosts"
    hf.write_text("# a comment\n10.0.0.1 slots=2\n10.0.0.2 slots=2\n")
    ns = dict(ns, port_range="10000-11000")
    if ns["hostfile"]:
        ns["hostfile"] = str(hf)
    got, want = Namespace(**ns), Namespace(**ns)
    assert str(tcli.build_hostlist(got)) == str(jcli.build_hostlist(want))
    assert tcli.build_cluster(got).to_json() == \
        jcli.build_cluster(want).to_json()


@pytest.mark.parametrize("hosts", [
    ["127.0.0.1"], ["192.0.2.1", "127.0.0.1"], ["192.0.2.1"],
    ["127.0.0.1", "127.0.0.2"], [],
])
def test_infer_self_ip(hosts):
    try:
        want = jdisc.infer_self_ip(hosts)
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            tdisc.infer_self_ip(hosts)
        assert str(got.value) == str(e)
        return
    assert tdisc.infer_self_ip(hosts) == want


def test_ssh_tools_argv_through_a_shim(tmp_path, capsys):
    """``main_distribute`` and ``main_rrun`` of both packages hand the
    same argv to the ssh binary, but the runner's module."""
    log = tmp_path / "argv.jsonl"
    shim = tmp_path / "ssh"
    shim.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:])"
                    " + '\\n')\n")
    shim.chmod(0o755)
    hosts = "127.0.0.1:2,127.0.0.2:1:10.1.1.2"
    calls = {}
    for name, mod in (("mine", tremote), ("ref", jremote)):
        log.write_text("")
        assert mod.main_distribute(["-H", hosts, "-u", "me", "--ssh",
                                    str(shim), "echo", "a b"]) == 0
        assert mod.main_rrun(["-np", "3", "-H", hosts, "--ssh", str(shim),
                              "-strategy", "RING", "-device-strategy",
                              "ring", "-logdir", "/l", "python3", "t.py",
                              "--x", "1"]) == 0
        assert mod.main_rrun(["-np", "9", "-H", hosts, "--ssh", str(shim),
                              "p"]) == 1
        calls[name] = sorted(log.read_text().splitlines())
    capsys.readouterr()
    assert len(calls["mine"]) == 4
    assert [c.replace("kungfu_tpu_torch.runner.cli", "kungfu_tpu.runner.cli")
            for c in calls["mine"]] == calls["ref"]
    assert any("kungfu_tpu_torch.runner.cli" in c for c in calls["mine"])


def test_run_all_fails_fast_and_logs(tmp_path, capsys):
    out = {}
    for name, mod in (("mine", tproc), ("ref", jproc)):
        d = tmp_path / name
        procs = [mod.Proc("bad", sys.executable, [
                     "-c", "import sys; print('hello'); sys.exit(3)"],
                     log_dir=str(d)),
                 mod.Proc("slow", sys.executable,
                          ["-c", "import time; time.sleep(60)"],
                          log_dir=str(d))]
        t0 = time.monotonic()
        codes = mod.run_all(procs, quiet=True)
        out[name] = (codes, time.monotonic() - t0)
        assert (d / "bad.stdout.log").read_text() == "hello\n"
        assert (d / "slow.stderr.log").exists()
    capsys.readouterr()
    assert out["mine"][0] == out["ref"][0] == [3, -15]
    assert out["mine"][1] < 30


def test_wait_group_escalates(tmp_path):
    """A worker that ignores SIGTERM is killed after the grace."""
    p = tproc.Proc("stubborn", sys.executable, [
        "-c", "import signal, time; signal.signal(signal.SIGTERM, "
              "signal.SIG_IGN); print('up', flush=True); time.sleep(60)"],
        log_dir=str(tmp_path))
    r = tproc.start_proc(p, quiet=True)
    deadline = time.monotonic() + 30
    while "up" not in (tmp_path / "stubborn.stdout.log").read_text():
        assert time.monotonic() < deadline
        time.sleep(0.05)
    tproc.kill_group(r)
    t0 = time.monotonic()
    assert tproc.wait_group([r], grace=0.5) == [-9]
    assert time.monotonic() - t0 < 10


# -- launch_multiprocess -----------------------------------------------------

def _mp_allreduce(rank, size, out_dir):
    import kungfu_tpu_torch as kf

    peer = kf.init()
    assert str(peer.device()) == "cpu"
    got = peer.engine().all_reduce(np.full(5, rank + 1.0, np.float32),
                                   op="sum")
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump({"rank": kf.current_rank(), "size": kf.cluster_size(),
                   "sum": got.tolist()}, f)
    kf.finalize()


def _mp_fail(rank, size):
    if rank == 1:
        raise SystemExit(5)


def test_launch_multiprocess_two_cpu_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    launch_multiprocess(_mp_allreduce, 2, str(tmp_path), timeout=120,
                        backend="cpu")
    got = [json.loads((tmp_path / f"{r}.json").read_text())
           for r in range(2)]
    assert got == [{"rank": r, "size": 2, "sum": [3.0] * 5}
                   for r in range(2)]
    with pytest.raises(RuntimeError, match="code 5"):
        launch_multiprocess(_mp_fail, 2, timeout=60, backend="cpu")
    with pytest.raises(ValueError):
        launch_multiprocess(_mp_fail, 1, backend="tpu")


# -- end to end ----------------------------------------------------------------

def _free_base(host: str, n: int) -> int:
    """A base port whose ``n`` ports were free on ``host`` when probed."""
    for _ in range(200):
        base = random.randrange(30000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind((host, p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise OSError("no free port range")


def _launch(args, tmp, alias="127.0.0.1", np_=2, backend="cpu", cwd=ROOT):
    """Start ``python -m kungfu_tpu_torch`` on ``alias``'s ports."""
    base = _free_base(alias, np_ + 2)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               KF_SOCK_DIR=str(tmp), KF_CONFIG_WATCH_GRACE="3")
    for k in ("KF_CHAOS_SPEC", "KF_CONFIG_ENABLE_MONITORING",
              "KF_PERSIST_DIR", "KF_PERSIST_RESTORE", "KF_JAX_PLATFORM"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "kungfu_tpu_torch", "-np", str(np_),
           "-H", f"{alias}:{np_ + 1}", "-self", alias,
           "-port-range", f"{base}-{base + np_ + 1}"]
    if backend:
        cmd += ["-backend", backend]
    return subprocess.Popen(cmd + args, cwd=cwd, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


PY = sys.executable
EX = "kungfu_tpu_torch.examples."


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Every end-to-end launch, started together; ``{name: (rc, stdout,
    stderr, dir)}``."""
    tmp = tmp_path_factory.mktemp("kfrun")
    d = {n: tmp / n for n in ("crash", "plain", "hang", "persist")}
    for p in d.values():
        p.mkdir()
    cfg = _free_base("127.0.0.1", 1)
    runs = {
        "slp": (_launch([PY, "-m", EX + "mnist_slp", "--n-epochs", "2"],
                        tmp), None),
        "fails": (_launch([PY, "-c", "import sys; sys.exit(3)"], tmp), None),
        "ref_slp": (_launch([PY, "examples/mnist_slp.py", "--n-epochs", "1"],
                            tmp), None),
        "no_card": (_launch([PY, "-m", EX + "mnist_slp", "--n-epochs", "1"],
                            tmp, np_=1, backend=""), None),
        "crash": (_launch(["-auto-recover", "10s", PY, "-m",
                           EX + "failure_recovery", "--n-epochs", "3",
                           "--die-at-epoch", "1", "--ckpt-dir",
                           str(d["crash"])], tmp, alias="127.0.18.1"),
                  d["crash"]),
        "plain": (_launch([PY, "-m", EX + "failure_recovery", "--n-epochs",
                           "3", "--ckpt-dir", str(d["plain"])], tmp),
                  d["plain"]),
        "hang": (_launch(["-auto-recover", "8s", PY, "-m",
                          EX + "failure_recovery", "--n-epochs", "2",
                          "--hang-at-epoch", "1", "--ckpt-dir",
                          str(d["hang"])], tmp, alias="127.0.18.2"),
                 d["hang"]),
        "persist": (_launch(["-restore-from", str(d["persist"]), "-chaos",
                             "preempt:all,step=3", PY, "-m",
                             EX + "preempt_restore", "--worker", "--n-steps",
                             "6"], tmp, alias="127.0.18.3"), d["persist"]),
        "elastic": (_launch(["-w", "-builtin-config-port", str(cfg), PY, "-m",
                             EX + "elastic_mnist", "--schedule", "1:4,2:4"],
                            tmp, alias="127.0.18.4", np_=1), None),
    }
    out = {}
    deadline = time.monotonic() + 240
    for name, (proc, path) in runs.items():
        try:
            so, se = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            so, se = proc.communicate()
            so += f"\nTIMEOUT of {name}"
        out[name] = (proc.returncode, so, se, path)
    return out


def _ok(run):
    rc, so, se, _ = run
    assert rc == 0, so[-3000:] + se[-3000:]
    return so, se


def test_mnist_slp_np2(launches):
    so, _ = _ok(launches["slp"])
    assert so.count(": OK") == 2
    assert "worker 0/2 up" in so and "epoch 1: mean loss" in so


def test_failing_worker_fails_the_job(launches):
    rc, _, se, _ = launches["fails"]
    assert rc == 1 and "workers failed" in se


def test_reference_worker_under_the_port_launcher(launches):
    """The reference's own example, JAX workers on the env contract the
    port's launcher stamps."""
    so, _ = _ok(launches["ref_slp"])
    assert so.count(": OK") == 2


def test_gpu_backend_without_a_card_fails(launches):
    rc, so, se, _ = launches["no_card"]
    if torch.cuda.is_available():
        assert rc == 0, se[-2000:]
        return
    assert rc == 1
    assert "no CUDA device is available" in se
    assert "OK" not in so


def _final_ckpt(path):
    with np.load(os.path.join(path, "ckpt_00000002.npz")) as z:
        return {k: z[k].copy() for k in z.files if k != "__meta__"}, \
            json.loads(str(z["__meta__"]))


def test_crash_recovery_bitwise(launches):
    so, se = _ok(launches["crash"])
    assert "simulating crash at epoch 1" in so
    assert so.count("restarted from epoch 1") == 2
    assert "trained epochs [1, 3) OK" in so
    assert "monitored-round-0-down" in se and "monitored-round-1-spawn" in se
    _ok(launches["plain"])
    got, meta = _final_ckpt(launches["crash"][3])
    want, wmeta = _final_ckpt(launches["plain"][3])
    assert meta == wmeta == {"epochs_done": 3}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_hang_caught_by_the_stall_timeout(launches):
    so, se = _ok(launches["hang"])
    assert "simulating stall at epoch 1" in so
    assert "begin without end" in se
    assert so.count("restarted from epoch 1") == 2
    assert "trained epochs [1, 2) OK" in so


def test_preempt_restore_relaunched(launches):
    from kungfu_tpu_torch.examples.preempt_restore import replay

    so, se = _ok(launches["persist"])
    assert "whole job preempted" in se
    assert so.count("restored step") == 2
    final = [ln for ln in so.splitlines() if "FINAL " in ln]
    assert len(final) == 1
    got = np.asarray(json.loads(final[0].split("FINAL ", 1)[1]), np.float32)
    assert got.tobytes() == replay(6).tobytes()


def test_elastic_grows_from_one_to_two(launches):
    so, se = _ok(launches["elastic"])
    assert "worker 0/1 up (v0)" in so and "worker 1/2 up (v1)" in so
    assert "sizes seen [1, 2], resizes survived 1" in so
    assert "stage v1: 1 -> 2 workers" in se


# -- the SLP's epoch -----------------------------------------------------------

def test_slp_epoch_matches_reference():
    """The example's S-SGD step over an epoch of one shard, against the
    reference's jax step (``model.loss`` under ``value_and_grad`` and
    ``optax.sgd``) from the same params on the same data."""
    import jax
    import jax.numpy as jnp
    import optax

    from kungfu_tpu.models import mnist_slp as jslp
    from kungfu_tpu_torch.examples.mnist_slp import (batches, sgd_step,
                                                     synthetic_mnist)
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.optimizers import sgd

    x, y = synthetic_mnist()
    x, y = x[:512], y[:512]
    model = mnist_slp()
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    opt = sgd(0.2)
    state = opt.init(params)
    losses = []
    for batch in batches(x, y, 64, "cpu"):
        params, state, loss = sgd_step(model, opt, params, state, batch)
        losses.append(float(loss))
    jm, jopt = jslp(), optax.sgd(0.2)
    jstate = jopt.init(jparams)
    step = jax.jit(jax.value_and_grad(jm.loss))
    jlosses = []
    for i in range(8):
        sl = slice(i * 64, (i + 1) * 64)
        loss, g = step(jparams, (x[sl], y[sl]))
        u, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6, atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(params["dense_0"][k].numpy(),
                                   np.asarray(jparams["dense_0"][k]),
                                   rtol=1e-6, atol=1e-6)
