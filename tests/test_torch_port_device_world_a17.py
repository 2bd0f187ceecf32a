"""Port parity: training across the processes of the device world.

Gradients through process-spanning collectives, ZeRO-3, per-replica SMA
and AdaptiveSGD with the monitors, and ``ShardedTrainer`` over a mesh
across worker processes, on the CPU, where a span's symmetric buffers
are POSIX shared memory.  Two geometries run together, as in
``tests/test_torch_port_device_world.py``: four processes of one rank
(``ProcessWorld`` directly, ``4x1``) and two of two ranks (``Peer``s of
a fixed world, ``2x2``); each worker (``tests/_world_worker.py``, mode
``a17``) writes its rows of every result, and the parent holds them
bitwise against the one-process stacked ``Communicator`` on the same
seeded inputs:

* (a) the output and the input gradient of every spanning collective
  (``all_reduce`` sum/mean/max/min, ``all_gather``, ``broadcast``,
  ``_psum_scatter``, ``ppermute``, ``all_to_all``, the schedules, the
  ring pair, the flat gather and scatter under ``lax`` and
  ``pallas_ring``, a chain of them) and ``axis_index``;
* (b) three ZeRO-3 steps of the MNIST SLP under both flat schedules,
  and two ``-device-world -backend cpu`` launches through 2 -> 4 -> 2:
  ZeRO-3, its parameter shard and momentum re-carved at each resize,
  against the reference's ``zero_train_step(stage=3)`` on 2, 4 and 2
  virtual devices;
* (c) SMA and AdaptiveSGD (stacked per-replica rows) and the GNS and
  variance monitors, against the reference's ``dp_train_step`` on four
  virtual devices, and per-replica SMA through 2 -> 4 -> 2 against the
  reference's;
* (d) a two-layer narrow ``ShardedTrainer`` over ``dp=2 x tp=2`` on a
  mesh across the processes, under psum and pallas_ring, against the
  reference ``ShardedTrainer`` on four virtual devices at
  ``tests/test_torch_port_parallel.py``'s tolerances.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu_torch.comm.device import Communicator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _world_worker as W  # noqa: E402
import test_torch_port_device_world as DW  # noqa: E402

CASES = {"4x1": (4, 1, "world"), "2x2": (2, 2, "peer")}
N = 4
#: three ZeRO-3 and per-replica steps against the reference: rtol 1e-5,
#: and an atol of REF_ATOL times the leaf's largest |entry| for the few
#: entries near zero, where the two packages' f32 sums (XLA's and
#: torch's 784-long dot products, summed in other orders) round apart
#: (readings: at most 2.4e-7 of the leaf's largest entry beyond rtol)
REF_RTOL, REF_ATOL = 1e-5, 1e-6
#: the sharded trainer's (tests/test_torch_port_parallel.py)
LOSS_RTOL = 1e-5
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
#: the launches: (loopback alias, slots, example arguments)
LAUNCHES = {
    "zero3": ("127.0.19.4", 4, ["--schedule", "2,4,2", "--train",
                                "--zero3"]),
    "sma": ("127.0.19.5", 4, ["--schedule", "2,4,2", "--train", "--sma"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both geometries' workers and both launches, started together;
    ``{"span": {case: (rows, [npz per process])}, "launch": {name: (rc,
    output, worker stdout lines, worker stderr)}}``."""
    spans = {}
    for name, (procs, rows, mode) in CASES.items():
        root = tmp_path_factory.mktemp(f"a17{name}")
        if mode == "peer":
            with open(root / "ports", "w") as f:
                f.write(",".join(map(str, DW._free_ports(procs))))
        spans[name] = (root, rows, _start(root, procs, rows, mode))
    launched = {}
    for name, (alias, slots, args) in LAUNCHES.items():
        tmp = tmp_path_factory.mktemp(name)
        launched[name] = (tmp, DW._launch(tmp, alias, slots, args))
    for name, (root, rows, ps) in spans.items():
        if CASES[name][2] == "world":
            DW._publish_peers(root, ps)
    out = {"span": {}, "launch": {}}
    for name, (root, rows, ps) in spans.items():
        logs = [p.communicate(timeout=180)[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(logs)
        out["span"][name] = (rows, [dict(np.load(root / f"out{i}.npz"))
                                    for i in range(len(ps))])
    for name, (tmp, proc) in launched.items():
        out["launch"][name] = DW._collect(tmp, proc)
    return out


def _start(root, procs: int, rows: int, mode: str):
    env = dict(os.environ, OMP_NUM_THREADS="1", KF_TPU_NO_NATIVE="1")
    return [subprocess.Popen([DW.PY, os.path.join(ROOT, "tests",
                                                  "_world_worker.py"),
                              str(root), str(i), str(procs), str(rows), mode,
                              "a17"],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i in range(procs)]


@functools.lru_cache(maxsize=None)
def _one_process():
    """Every A17 result of the one-process communicator of four ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.a17(Communicator(devices=["cpu"] * N), W.a17_inputs(N), 0,
                     N)
    finally:
        torch.set_num_threads(n)


#: results every process holds whole (not per-rank rows): the losses,
#: gathered params and the replicated S-SGD params and state
_WHOLE = ("_loss", "_global", "_params")
_REPLICATED = ("gns_", "var_")


def _ref_close(got, want, what: str = "") -> None:
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=REF_RTOL,
        atol=REF_ATOL * float(np.abs(want).max(initial=0.0)), err_msg=what)


def _check_bitwise(runs, case: str, prefixes) -> int:
    rows, outs = runs["span"][case]
    ref = {k: v for k, v in _one_process().items() if k.startswith(prefixes)}
    for q, got in enumerate(outs):
        lo = q * rows
        for key, want in ref.items():
            if not (key.endswith(_WHOLE) or key.startswith(_REPLICATED)):
                want = want[lo:lo + rows]
            assert got[key].dtype == want.dtype, key
            assert got[key].shape == want.shape, key
            assert got[key].tobytes() == want.tobytes(), (case, q, key)
    return len(ref)


def _rows(runs, case: str, key: str) -> np.ndarray:
    """Every process's rows of ``key``, concatenated in rank order."""
    return np.concatenate([o[key] for o in runs["span"][case][1]])


# -- (a) gradients through the span --------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_vjps_bitwise_one_process(runs, case):
    """Each spanning collective's output and input gradient, and
    ``axis_index`` (this process's global ranks), bitwise the one-process
    communicator's rows."""
    count = _check_bitwise(runs, case, ("vjp_", "axis_index"))
    assert count == 2 * len(W._vjp_cases(Communicator(devices=["cpu"] * N))) \
        + 1
    ref = _one_process()
    assert all(np.abs(v).sum() > 0 for k, v in ref.items()
               if k.startswith("vjp_") and k.endswith("_g"))
    assert _rows(runs, case, "axis_index").tolist() == list(range(N))


# -- (b) ZeRO-3 ----------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_zero3_bitwise_one_process(runs, case):
    """Three ZeRO-3 steps under ``lax`` and ``pallas_ring``: losses, the
    gathered params, this process's parameter shard and momentum rows
    bitwise the one-process port."""
    assert _check_bitwise(runs, case, ("zero3_",)) == 2 * 4


def test_zero3_matches_reference(runs):
    """The four processes' ZeRO-3 steps against the reference's
    ``zero_train_step(stage=3)`` on four virtual devices: the losses,
    the parameter shard carve (rows = its global flat buffer) and the
    momentum."""
    from kungfu_tpu.comm.device import Communicator as JCommunicator
    from kungfu_tpu.models import mnist_slp as jmnist_slp
    from kungfu_tpu.parallel import zero as jzero
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)

    model = jmnist_slp()
    params = jax.tree_util.tree_map(jnp.asarray, slp_params())
    for sched in ("lax", "pallas_ring"):
        z = jzero.zero_train_step(
            lambda p, b: model.loss(p, b), optax.sgd(0.1, momentum=0.9),
            JCommunicator(devices=jax.devices()[:N], local_size=N), stage=3,
            bucket_bytes=4096, schedule=sched)
        p, state = z.init_params(params), z.init_opt(params)
        losses = []
        for x, y in epoch_batches(N, 3):
            p, state, loss = z.step(p, state, (jnp.asarray(x),
                                               jnp.asarray(y, jnp.int32)))
            losses.append(float(loss))
        key = f"zero3_{sched}"
        got = runs["span"]["4x1"][1][0]
        _ref_close(got[f"{key}_loss"], losses)
        _ref_close(_rows(runs, "4x1", f"{key}_shard").reshape(-1),
                   np.asarray(p))
        mom = [np.asarray(a) for a in jax.tree_util.tree_leaves(state)]
        _ref_close(_rows(runs, "4x1", f"{key}_state0").reshape(-1),
                   mom[0].reshape(-1))


# -- (c) per-replica params and the monitors -----------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_replicas_bitwise_one_process(runs, case):
    """SMA and AdaptiveSGD over stacked per-replica rows, and S-SGD
    under the GNS and variance monitors: losses, params and state
    bitwise the one-process port."""
    assert _check_bitwise(runs, case, ("sma_", "ada_", "gns_", "var_")) >= 20


def test_replicas_match_reference(runs):
    """The four processes' per-replica rows and monitor states against
    the reference's ``dp_train_step`` on four virtual devices (SMA and
    AdaptiveSGD with ``replicated_params=False``, the reference's
    ``P(axis)``)."""
    from kungfu_tpu.comm.device import Communicator as JCommunicator
    from kungfu_tpu.models import mnist_slp as jmnist_slp
    from kungfu_tpu.optimizers import (adaptive_sgd, monitor_gradient_noise_scale,
                                       monitor_gradient_variance,
                                       synchronous_averaging)
    from kungfu_tpu.parallel.train import dp_train_step as jstep
    from kungfu_tpu.parallel.train import stack_for_replicas as jstack
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)

    model = jmnist_slp()
    comm = JCommunicator(devices=jax.devices()[:N], local_size=N)
    inner = optax.sgd(0.1, momentum=0.9)
    txs = {"sma": synchronous_averaging(inner, comm.axis, alpha=0.1),
           "ada": adaptive_sgd(inner, comm.axis, change_step=1),
           "gns": monitor_gradient_noise_scale(inner, comm.axis, 8),
           "var": monitor_gradient_variance(inner, comm.axis)}
    got = runs["span"]["4x1"][1]
    for name, tx in txs.items():
        stacked = name in W.REPLICA_TX
        params = jax.tree_util.tree_map(jnp.asarray, slp_params())
        state = tx.init(params)
        if stacked:
            params, state = jstack(params, N), jstack(state, N)
        step = jstep(lambda p, b: model.loss(p, b), tx, comm,
                     replicated_params=not stacked)
        losses = []
        for x, y in epoch_batches(N, 3):
            params, state, loss = step(params, state, (
                jnp.asarray(x), jnp.asarray(y, jnp.int32)))
            losses.append(float(loss))
        _ref_close(got[0][f"{name}_loss"], losses)
        for kind, tree in (("param", params), ("state", state)):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                key = f"{name}_{kind}{i}"
                mine = (_rows(runs, "4x1", key) if stacked and
                        got[0][key].ndim else got[0][key])
                _ref_close(mine, np.asarray(leaf), key)


# -- (d) ShardedTrainer over a mesh across processes ---------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_sharded_bitwise_one_process(runs, case):
    """Two dp=2 x tp=2 steps under psum and pallas_ring: the losses,
    this process's rows of every param leaf and the gathered global
    params bitwise the one-process trainer; the gathered params agree
    across processes."""
    assert _check_bitwise(runs, case, ("sharded_",)) > 2 * 12
    outs = runs["span"][case][1]
    for sched in ("psum", "pallas_ring"):
        key = f"sharded_{sched}_global"
        assert len({o[key].tobytes() for o in outs}) == 1


def test_sharded_matches_reference(runs):
    """The four processes' trainer against the reference
    ``ShardedTrainer`` over dp=2 x tp=2 on four virtual devices, from the
    same weights: each step's loss at rtol 1e-5, the params after two
    steps at the one-step tolerance of ``test_torch_port_parallel``."""
    from kungfu_tpu.models.transformer import TransformerConfig as JConfig
    from kungfu_tpu.parallel import MeshPlan as JMeshPlan
    from kungfu_tpu.parallel import ShardedTrainer as JShardedTrainer
    from kungfu_tpu_torch import interop
    from kungfu_tpu_torch.models.transformer import TransformerConfig
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.train import ParallelPlan, ShardedTrainer

    one = ShardedTrainer(TransformerConfig(**W.SHARDED_CFG),
                         ParallelPlan(dp=2, tp=2), tx=sgd(W.SHARDED_LR),
                         devices=["cpu"] * N)
    init = interop.sharded_params_to_jax(
        one.init(torch.Generator().manual_seed(0))["params"], one)
    jtr = JShardedTrainer(JConfig(**W.SHARDED_CFG), JMeshPlan(dp=2, tp=2),
                          tx=optax.sgd(W.SHARDED_LR))
    params = jtr.shard_params(init)
    jstate = {"params": params, "opt_state": jtr.tx.init(params),
              "step": jnp.zeros((), jnp.int32)}
    losses = []
    for ids, tgt in W.sharded_batches():
        jstate, loss = jtr.step(jstate, (jnp.asarray(ids), jnp.asarray(tgt)))
        losses.append(float(loss))
    jflat = np.concatenate([
        np.asarray(a).reshape(-1) for a in jax.tree_util.tree_leaves(
            interop.unflatten(interop.flatten(jax.device_get(
                jstate["params"]))))])
    got = runs["span"]["4x1"][1][0]
    for sched in ("psum", "pallas_ring"):
        np.testing.assert_allclose(got[f"sharded_{sched}_loss"], losses,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"sharded_{sched}_global"], jflat,
                                   **STEP_TOL)


# -- (b), (c) live resizes through the launcher --------------------------------

def _reference_resize_losses(kind: str):
    """The reference in-process on 2, then 4, then 2 virtual devices,
    from the example's numpy params and batches, the state carried: ZeRO-3
    re-carves its parameter shard and momentum by ``zero1_reshard``; SMA
    re-stacks rank 0's replica.  The last loss of each epoch."""
    from kungfu_tpu.comm.device import Communicator as JCommunicator
    from kungfu_tpu.models import mnist_slp as jmnist_slp
    from kungfu_tpu.optimizers import synchronous_averaging
    from kungfu_tpu.parallel import zero as jzero
    from kungfu_tpu.parallel.train import dp_train_step as jstep
    from kungfu_tpu.parallel.train import stack_for_replicas as jstack
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)

    model = jmnist_slp()
    params = jax.tree_util.tree_map(jnp.asarray, slp_params())
    opt = optax.sgd(0.1, momentum=0.9)
    loss_fn = lambda p, b: model.loss(p, b)  # noqa: E731
    p = state = None
    losses = []
    for k in (2, 4, 2):
        comm = JCommunicator(devices=jax.devices()[:k], local_size=k)
        if kind == "zero3":
            z = jzero.zero_train_step(loss_fn, opt, comm, stage=3)
            fresh_p, fresh = z.init_params(params), z.init_opt(params)
            if p is None:
                p, state = fresh_p, fresh
            else:
                p = jzero.zero1_reshard(p, params, comm)
                state = jzero.zero1_reshard(state, params, comm)
            step = z.step
        else:
            tx = synchronous_averaging(opt, comm.axis, alpha=0.1)
            step = jstep(loss_fn, tx, comm, replicated_params=False)
            # rank 0's replica, off the old mesh's devices
            one = ((params, tx.init(params)) if p is None else
                   jax.tree_util.tree_map(lambda a: jnp.asarray(
                       np.asarray(a)[0]), (p, state)))
            p, state = jstack(one[0], k), jstack(one[1], k)
        for x, y in epoch_batches(k, 2):
            p, state, loss = step(p, state, (jnp.asarray(x),
                                             jnp.asarray(y, jnp.int32)))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("kind", list(LAUNCHES))
def test_resize_2_4_2(runs, kind):
    """ZeRO-3 (its parameter shard and momentum through
    ``zero_snapshot`` / ``zero_reshard`` at each resize) and per-replica
    SMA through 2 -> 4 -> 2 on ``-device-world -backend cpu``: the psums
    name the active slots, every process reports its epoch's loss
    bitwise, and the losses are the reference's within 1e-5."""
    rc, text, lines, errs = runs["launch"][kind]
    assert rc == 0, text + errs
    epochs = DW._epochs(lines)
    assert [len(epochs[v]) for v in (0, 1, 2)] == [2, 4, 2], lines
    assert [e["psum"] for e in epochs[1]] == [10.0] * 4
    losses = []
    for v in (0, 1, 2):
        vals = {e["loss"] for e in epochs[v]}
        assert len(vals) == 1, f"epoch {v} processes diverged: {vals}"
        losses.append(float(vals.pop()))
    assert len(set(losses)) == 3 and losses[2] < losses[0], losses
    np.testing.assert_allclose(losses, _reference_resize_losses(kind),
                               rtol=1e-5)
