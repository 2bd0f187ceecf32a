"""Port parity: the multi-process device world.

One ``Communicator`` across worker processes, the provisioned world
(standby peers, ``await_rejoin``, ``-device-world``) and live re-carve,
on the CPU, where a span's symmetric buffers are POSIX shared memory:

* (a) the env contract against the reference: ``Job.create_procs`` in
  world mode and in the fixed world under both backends, the world
  fields of ``parse_config_from_env``, a standby peer's
  ``communicator()``, the watch runner's world-local sets;
* (b) every eager collective and ZeRO-1/2 steps across processes (four
  processes of one rank through
  :class:`~kungfu_tpu_torch.comm.world.ProcessWorld`, and two processes
  of two ranks through ``Peer`` in a fixed world) bitwise the
  one-process stacked ``Communicator`` on the same seeded inputs,
  and the ring bitwise the reference's ``impl="lax"`` ring under
  ``shard_map`` on four of the eight virtual devices;
* (c) three launcher runs of ``kungfu_tpu_torch/examples/device_elastic.py``
  under ``-device-world -backend cpu``, started together: S-SGD through
  2 -> 4 -> 2 and ZeRO-1 through the same (losses against the
  reference's ``dp_train_step`` on 2, 4 and 2 virtual devices with the
  same numpy params and batches), and autotune.

Every port is found free (worker processes bind port 0, or probed free
ports); the watch runners each take a loopback alias of their own.
"""

import functools
import glob
import os
import random
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.ops.pallas import collectives as jring
from kungfu_tpu.utils.jaxcompat import shard_map
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.utils import envs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _world_worker as W  # noqa: E402

PY = sys.executable


# -- (a) the env contract ------------------------------------------------------

def _procs(mod_job, mod_plan, world: bool, backend: str):
    hl = mod_plan.HostList.parse("127.0.0.1:4")
    cluster = mod_plan.Cluster(hl.gen_runner_list(),
                               hl.gen_peer_list(2))
    job = mod_job.Job(prog="python3", args=["t.py"], backend=backend,
                      world=hl.gen_peer_list(4) if world else None,
                      job_start=1234.5)
    return [(p.name, p.envs) for p in job.create_procs(cluster, "127.0.0.1")]


@pytest.mark.parametrize("world", [True, False])
@pytest.mark.parametrize("backend,ref_backend", [("cpu", "cpu"),
                                                 ("gpu", "tpu")])
def test_job_envs_equal_reference(monkeypatch, world, backend, ref_backend):
    """Key for key the reference's ``create_procs`` apart from
    ``PYTHONPATH``: a provisioned world spawns every slot; the gpu
    backend stamps the tpu backend's fixed world."""
    from kungfu_tpu import plan as jplan
    from kungfu_tpu.runner import job as jjob
    from kungfu_tpu_torch import plan as tplan
    from kungfu_tpu_torch.runner import job as tjob

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    mine = _procs(tjob, tplan, world, backend)
    ref = _procs(jjob, jplan, world, ref_backend)
    assert len(mine) == len(ref) == (4 if world else 2)
    for (name, env), (rname, renv) in zip(mine, ref):
        assert name == rname
        env.pop("PYTHONPATH")
        renv.pop("PYTHONPATH")
        assert env == renv
    if world or backend == "gpu":
        assert [e[envs.PROCESS_ID] for _, e in mine] == \
            [str(i) for i in range(len(mine))]
    assert tjob.COORDINATOR_PORT_OFFSET == jjob.COORDINATOR_PORT_OFFSET


def test_coordinator_port_wraps_like_the_reference():
    from kungfu_tpu.plan import Cluster as JCluster, HostList as JHostList
    from kungfu_tpu.runner.job import Job as JJob
    from kungfu_tpu_torch.plan import Cluster, HostList
    from kungfu_tpu_torch.runner.job import Job

    out = []
    for job, cl, hl in ((Job, Cluster, HostList), (JJob, JCluster,
                                                   JHostList)):
        h = hl.parse("127.0.0.1:2")
        c = cl(h.gen_runner_list(), h.gen_peer_list(2, (50000, 50010)))
        be = "gpu" if job is Job else "tpu"
        out.append(job(prog="p", args=[], backend=be).create_procs(
            c, "127.0.0.1")[0].envs[envs.COORDINATOR])
    assert out[0] == out[1] == "127.0.0.1:38928"


def _world_env(self_port: int, n_world: int = 4, n_init: int = 2):
    return {
        envs.SELF_SPEC: f"127.0.0.1:{self_port}",
        envs.INIT_PEERS: ",".join(f"127.0.0.1:{10000 + i}"
                                  for i in range(n_init)),
        envs.WORLD_PEERS: ",".join(f"127.0.0.1:{10000 + i}"
                                   for i in range(n_world)),
    }


@pytest.mark.parametrize("port", [10000, 10001, 10002, 10003])
def test_config_parses_world_like_the_reference(port):
    from kungfu_tpu.utils import envs as jenvs

    mine = envs.parse_config_from_env(_world_env(port))
    ref = jenvs.parse_config_from_env(_world_env(port))
    assert (mine.process_id, mine.num_processes, mine.detached) == \
        (ref.process_id, ref.num_processes, ref.detached)
    assert str(mine.world_peers) == str(ref.world_peers)
    assert mine.process_id == port - 10000 and mine.num_processes == 4


def test_world_requires_membership():
    from kungfu_tpu.utils import envs as jenvs

    env = {envs.SELF_SPEC: "127.0.0.1:20000",
           envs.INIT_PEERS: "127.0.0.1:10000",
           envs.WORLD_PEERS: "127.0.0.1:10000,127.0.0.1:10001"}
    for mod in (envs, jenvs):
        with pytest.raises(ValueError, match="not a slot"):
            mod.parse_config_from_env(env)


def test_standby_peer_has_no_communicator():
    from kungfu_tpu.peer import Peer as JPeer
    from kungfu_tpu.utils import envs as jenvs
    from kungfu_tpu_torch.peer import Peer

    env = _world_env(10003)
    mine = Peer(envs.parse_config_from_env(env), devices=["cpu"])
    ref = JPeer(jenvs.parse_config_from_env(env))
    assert mine.standby and ref.standby
    assert mine.rank() == ref.rank() == -1
    for p in (mine, ref):
        with pytest.raises(RuntimeError, match="standby"):
            p.communicator()
    active = Peer(envs.parse_config_from_env(_world_env(10001)),
                  devices=["cpu"])
    assert not active.standby and active.rank() == 1


def test_watch_keeps_in_world_workers():
    """A provisioned world's watch runner kills and spawns no in-world
    worker on a shrink or a grow (they move to standby and back
    themselves), as the reference's sets (``watch.py:183-205``)."""
    from kungfu_tpu_torch.plan import Cluster, HostList
    from kungfu_tpu_torch.runner.watch import world_local_changes

    hl = HostList.parse("127.0.0.1:4")
    world = set(hl.gen_peer_list(4).on_host("127.0.0.1"))
    big = set(Cluster(hl.gen_runner_list(), hl.gen_peer_list(4))
              .workers.on_host("127.0.0.1"))
    small = set(Cluster(hl.gen_runner_list(), hl.gen_peer_list(2))
                .workers.on_host("127.0.0.1"))
    for old, new in ((big, small), (small, big)):
        ref_removed = (old - new) - world
        ref_added = (new - old) - world
        assert world_local_changes(old, new, world) == (ref_removed,
                                                        ref_added) \
            == (set(), set())
        # without a world, the fixed-world diff
        assert world_local_changes(old, new) == (old - new, new - old)


class _Span:
    """A span's geometry only, for the checks made before any
    exchange."""

    def __init__(self, procs: int, index: int, rows: int = 1):
        self.procs, self.index, self.rows = procs, index, rows
        self.n, self.first = procs * rows, index * rows
        self.slots = list(range(procs))


class TestSpanningGeometry:
    def test_communicator_metadata(self):
        comm = Communicator(devices=["cpu"] * 2, span=_Span(3, 1, rows=2))
        assert (comm.size, comm.addressable_n, comm.first_rank) == (6, 2, 2)
        assert [comm.first_slot_of_process(p) for p in range(3)] == [0, 2, 4]
        with pytest.raises(ValueError, match="owns no device"):
            comm.first_slot_of_process(3)
        one = Communicator(devices=["cpu"] * 4)
        assert (one.addressable_n, one.first_rank,
                one.first_slot_of_process(0)) == (4, 0, 0)
        with pytest.raises(ValueError, match="rank"):
            Communicator(devices=["cpu"], span=_Span(2, 0, rows=2))

    def test_mesh_over_a_span(self):
        """A mesh built over a communicator across processes holds this
        process's window of ranks and binds a span-aware world."""
        from kungfu_tpu_torch.ops import collective
        from kungfu_tpu_torch.parallel import MeshPlan

        span = _Span(2, 1, rows=2)
        mesh = MeshPlan(dp=2, tp=2).build_mesh(
            Communicator(devices=["cpu"] * 2, span=span))
        assert (mesh.size, mesh.first, mesh.rows) == (4, 2, 2)
        with mesh.world() as world:
            assert world.span is span and (world.first, world.rows) == (2, 2)
            assert collective.peer_rank("dp").tolist() == [1, 1]
            assert collective.peer_rank("tp").tolist() == [0, 1]
        with pytest.raises(ValueError, match="8 ranks"):
            MeshPlan(dp=4, tp=2).build_mesh(
                Communicator(devices=["cpu"] * 2, span=span))


# -- (b) collectives across processes ----------------------------------------

def _free_ports(n: int):
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _run_processes(root, procs: int, rows: int, mode: str):
    env = dict(os.environ, OMP_NUM_THREADS="1", KF_TPU_NO_NATIVE="1")
    ps = [subprocess.Popen([PY, os.path.join(ROOT, "tests",
                                             "_world_worker.py"),
                            str(root), str(i), str(procs), str(rows), mode],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
          for i in range(procs)]
    if mode == "world":
        _publish_peers(root, ps)
    return ps


def _publish_peers(root, ps) -> None:
    """Wait for each world-mode worker's port and write the peer list
    every worker waits for."""
    ports = []
    for i, proc in enumerate(ps):
        p = os.path.join(root, f"port{i}")
        deadline = time.time() + 60
        while not os.path.exists(p):
            assert time.time() < deadline, "a worker never bound"
            assert proc.poll() is None, proc.communicate()[0]
            time.sleep(0.02)
        with open(p) as f:
            ports.append(f.read().strip())
    with open(os.path.join(root, "peers.tmp"), "w") as f:
        f.write(",".join(f"127.0.0.1:{p}" for p in ports))
    os.replace(os.path.join(root, "peers.tmp"), os.path.join(root, "peers"))


@pytest.fixture(scope="module")
def span_runs(tmp_path_factory):
    """Four processes of one rank (ProcessWorld directly) and two of two
    ranks (Peers of a fixed world), run together; ``{case: (rows,
    [out npz per process])}``."""
    cases = {"4x1": (4, 1, "world"), "2x2": (2, 2, "peer")}
    started = {}
    for name, (procs, rows, mode) in cases.items():
        root = tmp_path_factory.mktemp(f"span{name}")
        if mode == "peer":
            with open(root / "ports", "w") as f:
                f.write(",".join(map(str, _free_ports(procs))))
        started[name] = (root, rows, _run_processes(root, procs, rows, mode))
    out = {}
    for name, (root, rows, ps) in started.items():
        logs = [p.communicate(timeout=120)[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(logs)
        out[name] = (rows, [dict(np.load(root / f"out{i}.npz"))
                            for i in range(len(ps))])
    return out


@pytest.mark.parametrize("case", ["4x1", "2x2"])
def test_spanning_collectives_bitwise_one_process(span_runs, case):
    """Each process's rows of every collective (every schedule of
    ``all_reduce``, ``reduce_scatter``, ``all_gather``,
    ``all_gather_shard``, ``broadcast`` and ``reduce`` from every root,
    ``broadcast_value`` from every root slot, ``consensus``, the ring
    pair in both directions in f32 and bf16, and three ZeRO-1 and ZeRO-2
    steps: losses, params and momentum rows) bitwise the one-process
    communicator's rows of the same seeded inputs."""
    rows, outs = span_runs[case]
    n = rows * len(outs)
    full = W.inputs(n)
    ref = W.collectives(Communicator(devices=["cpu"] * n), full)
    assert len(ref) >= 40
    for q, got in enumerate(outs):
        lo = q * rows
        for key, want in ref.items():
            if key.startswith("bv"):
                # the root slot's process's value, as every process gets it
                root = int(key[2:])
                want = full["value"][(root // rows) * rows][None]
            elif key in ("consensus_same", "consensus_diff", "digests"):
                pass
            elif want.ndim and want.shape[0] == n:
                want = want[lo:lo + rows]
            assert got[key].dtype == want.dtype, key
            assert got[key].tobytes() == want.tobytes(), (case, q, key)
        assert got["consensus_same"].all() and not got["consensus_diff"].any()
        exchanges, opens = got["stats"]
        assert exchanges >= 40 and opens == len(outs) - 1


def _ref_ring(n, fn, x):
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("x",))
    f = shard_map(lambda row: fn(row[0])[None], mesh=mesh,
                  in_specs=(P("x"),), out_specs=P("x"), check_vma=False)
    return np.asarray(jax.jit(f)(x))


@pytest.mark.parametrize("key", ["x", "bf16"])
@pytest.mark.parametrize("bidi", [False, True])
def test_spanning_ring_bitwise_reference(span_runs, key, bidi):
    """The four processes' ring reduce-scatter and all-gather, bitwise
    the reference's ``impl="lax"`` ring over four virtual devices."""
    rows, outs = span_runs["4x1"]
    full = W.inputs(4)[key]
    x = jnp.asarray(full) if key == "x" else \
        jnp.asarray(full.view(np.uint16)).view(jnp.bfloat16)
    rs = _ref_ring(4, lambda r: jring.ring_reduce_scatter(
        r, "x", bidirectional=bidi, impl="lax"), x)
    ag = _ref_ring(4, lambda r: jring.ring_all_gather(
        r, "x", bidirectional=bidi, impl="lax"), jnp.asarray(rs))
    got_rs = np.concatenate([o[f"ring_rs_{key}_{bidi}"] for o in outs])
    got_ag = np.concatenate([o[f"ring_ag_{key}_{bidi}"] for o in outs])
    assert got_rs.tobytes() == np.asarray(rs).tobytes()
    assert got_ag.tobytes() == np.asarray(ag).tobytes()


# -- (c) the launcher -----------------------------------------------------------

def _free_base(host: str, n: int) -> int:
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


def _launch(tmp, alias: str, slots: int, args):
    base = _free_base(alias, slots + 1)
    cfg = _free_base("127.0.0.1", 1)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               KF_SOCK_DIR=str(tmp), KF_CONFIG_WATCH_GRACE="3")
    for k in ("KF_CHAOS_SPEC", "KF_JAX_PLATFORM", "JAX_PLATFORMS"):
        env.pop(k, None)
    cmd = [PY, "-m", "kungfu_tpu_torch", "-np", "2",
           "-H", f"{alias}:{slots}", "-self", alias,
           "-port-range", f"{base}-{base + slots}", "-w", "-device-world",
           "-backend", "cpu", "-builtin-config-port", str(cfg),
           "-logdir", str(tmp / "logs"), "-q", PY, "-m",
           "kungfu_tpu_torch.examples.device_elastic", "--"] + args
    return subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The three runs, started together; ``{name: (rc, output, stdout
    lines of the workers, their stderr)}``."""
    runs = {
        "train": ("127.0.19.1", 4, ["--schedule", "2,4,2", "--train",
                                    "--strategy", "ring",
                                    "--resync-root", "1"]),
        "zero1": ("127.0.19.2", 4, ["--schedule", "2,4,2", "--train",
                                    "--zero1"]),
        "autotune": ("127.0.19.3", 2, ["--schedule", "2", "--autotune"]),
    }
    started = {}
    for name, (alias, slots, args) in runs.items():
        tmp = tmp_path_factory.mktemp(name)
        started[name] = (tmp, _launch(tmp, alias, slots, args))
    return {name: _collect(tmp, proc)
            for name, (tmp, proc) in started.items()}


def _collect(tmp, proc):
    """``(rc, output, stdout lines of the workers, their stderr)`` of a
    launch, killed after 240 s."""
    try:
        text = proc.communicate(timeout=240)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        text = proc.communicate()[0]
    lines, errs = [], ""
    for f in sorted(glob.glob(str(tmp / "logs" / "*.stdout.log"))):
        with open(f) as fh:
            lines += fh.read().splitlines()
    for f in sorted(glob.glob(str(tmp / "logs" / "*.stderr.log"))):
        with open(f) as fh:
            errs += fh.read()
    return proc.returncode, text, lines, errs


_EPOCH = re.compile(
    r"KFEPOCH v=(\d+) size=(\d+) rank=(\d+) world_rank=(\d+) "
    r"psum=([\d.]+) expect=([\d.]+) pid=(\d+) ok=(\w+) strategy=(\w+)"
    r"(?: loss=([\d.eE+-]+))?$")


def _epochs(lines):
    epochs = {}
    for ln in lines:
        m = _EPOCH.match(ln)
        if m:
            epochs.setdefault(int(m.group(1)), []).append(dict(
                size=int(m.group(2)), rank=int(m.group(3)),
                world_rank=int(m.group(4)), psum=float(m.group(5)),
                expect=float(m.group(6)), pid=int(m.group(7)),
                ok=m.group(8) == "True", strategy=m.group(9),
                loss=m.group(10)))
    return epochs


@functools.lru_cache(maxsize=None)
def _reference_losses():
    """The reference's ``dp_train_step`` in-process on 2, then 4, then 2
    virtual devices, the params and momentum carried, from the example's
    numpy params and batches: the last loss of each epoch."""
    from kungfu_tpu import initializer as jinit
    from kungfu_tpu.comm.device import Communicator as JCommunicator
    from kungfu_tpu.models import mnist_slp as jmnist_slp
    from kungfu_tpu.optimizers import synchronous_sgd as jssgd
    from kungfu_tpu.parallel.train import dp_train_step as jstep
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)

    model = jmnist_slp()
    params = jax.tree_util.tree_map(jnp.asarray, slp_params())
    opt = optax.sgd(0.1, momentum=0.9)
    state, losses = None, []
    for k in (2, 4, 2):
        comm = JCommunicator(devices=jax.devices()[:k], local_size=k)
        tx = jssgd(opt, comm.axis)
        step = jstep(lambda p, b: model.loss(p, b), tx, comm)
        state = tx.init(params) if state is None else state
        params, state = jinit.resync_parameters((params, state), None,
                                                comm=comm)
        for x, y in epoch_batches(k, 2):
            params, state, loss = step(params, state, (
                jnp.asarray(x), jnp.asarray(y, jnp.int32)))
        losses.append(float(loss))
    return tuple(losses)


def test_train_2_4_2(launches):
    """S-SGD through 2 -> 4 -> 2 under ``ring``: the psums name exactly
    the active slots, worker 0 keeps one pid, the joiners run epoch 1
    only and every slot ends cleanly, every replica's loss is bitwise
    its epoch's, and the losses are the reference's within 1e-5."""
    rc, text, lines, errs = launches["train"]
    assert rc == 0, text + errs
    epochs = _epochs(lines)
    assert sorted(epochs) == [0, 1, 2], lines
    assert [e["psum"] for e in epochs[0]] == [3.0, 3.0]
    assert [e["psum"] for e in epochs[1]] == [10.0] * 4
    assert [e["psum"] for e in epochs[2]] == [3.0, 3.0]
    assert all(e["ok"] and e["strategy"] == "ring"
               for es in epochs.values() for e in es)
    assert len({e["pid"] for es in epochs.values() for e in es
                if e["world_rank"] == 0}) == 1
    done = {int(m.group(1)) for ln in lines
            if (m := re.match(r"KFDONE world_rank=(\d+)", ln))}
    assert done == {0, 1, 2, 3}
    for wr in (2, 3):
        assert [v for v, es in epochs.items() for e in es
                if e["world_rank"] == wr] == [1]
    assert "keep their original device world" not in errs
    losses = []
    for v in (0, 1, 2):
        vals = {e["loss"] for e in epochs[v]}
        assert len(vals) == 1, f"epoch {v} replicas diverged: {vals}"
        losses.append(float(vals.pop()))
    assert len(set(losses)) == 3 and losses[2] < losses[0], losses
    np.testing.assert_allclose(losses, _reference_losses(), rtol=1e-5)


def test_zero1_2_4_2(launches):
    """ZeRO-1 through 2 -> 4 -> 2: the sharded momentum crosses each
    resize through ``zero1_snapshot`` / ``zero1_reshard``; every replica
    reports its epoch's loss bitwise, and the losses are the reference's
    S-SGD within 1e-5 (SGD with momentum is elementwise, so sharding its
    state changes nothing but the rounding)."""
    rc, text, lines, errs = launches["zero1"]
    assert rc == 0, text + errs
    epochs = _epochs(lines)
    assert [len(epochs[v]) for v in (0, 1, 2)] == [2, 4, 2], lines
    losses = []
    for v in (0, 1, 2):
        vals = {e["loss"] for e in epochs[v]}
        assert len(vals) == 1, f"epoch {v} replicas diverged: {vals}"
        losses.append(float(vals.pop()))
    assert len(set(losses)) == 3 and losses[2] < losses[0], losses
    np.testing.assert_allclose(losses, _reference_losses(), rtol=1e-5)


def test_autotune_agrees(launches):
    """Every process installs the same measured winner."""
    from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES

    rc, text, lines, errs = launches["autotune"]
    assert rc == 0, text + errs
    winners = [m.group(1) for ln in lines
               if (m := re.search(r"ok=True strategy=(\w+)", ln))]
    assert len(winners) == 2 and len(set(winners)) == 1, lines
    assert winners[0] in ALLREDUCE_SCHEDULES
