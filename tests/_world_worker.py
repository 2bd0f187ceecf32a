"""One worker process of ``tests/test_torch_port_device_world.py``.

``python tests/_world_worker.py DIR INDEX PROCS ROWS MODE [a17]`` runs
every eager collective of a process-spanning ``Communicator`` on this
process's rows of seeded inputs, and ZeRO-1 and ZeRO-2 steps over it
(with ``a17``: the vjp of every spanning collective, ZeRO-3 steps, SMA,
AdaptiveSGD and the monitors, and a ``ShardedTrainer`` over a mesh
across the processes, :func:`a17`), and writes its rows of each result
to ``DIR/out{INDEX}.npz``; the parent holds them against the one-process
communicator.  ``MODE`` ``world``: bind a host channel on a port the OS
picks, write it to ``DIR/port{INDEX}``, wait for ``DIR/peers`` (the
parent's list of every worker) and boot a ``ProcessWorld`` over them.
``peer``: a ``Peer`` of a fixed world (``KF_COORDINATOR``,
``KF_NUM_PROCESSES``, ``KF_NUM_DEVICES=ROWS``) on the ports listed in
``DIR/ports``.  Nothing here reads the network beyond the loopback.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the inputs: seeded, stacked [n, LENGTH] for n ranks
LENGTH = 2 * 2048 + 40
SEED = 22


def inputs(n: int) -> dict:
    """Every rank's input rows, as numpy (the parent draws the same)."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, LENGTH)).astype(np.float32)
    ints = rng.integers(-1000, 1000, (n, 96)).astype(np.int32)
    shard = rng.standard_normal((n, 1000)).astype(np.float32)
    same = np.broadcast_to(rng.standard_normal(17).astype(np.float32),
                           (n, 17)).copy()
    value = rng.standard_normal((n, 33)).astype(np.float32)
    bf = torch.from_numpy(x[:, :2048].copy()).to(torch.bfloat16)
    return {"x": x, "ints": ints, "shard": shard, "same": same,
            "value": value, "bf16": bf.view(torch.int16).numpy()}


def collectives(comm, rows: dict) -> dict:
    """Every eager collective of ``comm`` on ``rows`` (this process's rows
    of :func:`inputs`, or all of them with one process); numpy out."""
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.ops import collectives as ring
    from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES

    t = {k: torch.from_numpy(v.copy()) for k, v in rows.items()}
    t["bf16"] = t["bf16"].view(torch.bfloat16)
    out = {}
    for sched in ALLREDUCE_SCHEDULES:
        comm.set_strategy(sched)
        out[f"ar_{sched}"] = comm.all_reduce(t["x"])
        out[f"mean_{sched}"] = comm.all_reduce(t["x"], op="mean")
        out[f"max_{sched}"] = comm.all_reduce(t["ints"], op="max")
        out[f"rs_{sched}"] = comm.reduce_scatter(t["x"], bucket_bytes=4096)
        out[f"ags_{sched}"] = comm.all_gather_shard(t["shard"],
                                                    bucket_bytes=4096)
    comm.set_strategy("psum")
    out["min"] = comm.all_reduce(t["x"], op="min")
    out["prod"] = comm.all_reduce(t["ints"][:, :8] % 3, op="prod")
    out["ag"] = comm.all_gather(t["shard"])
    for root in range(comm.size):
        out[f"bc{root}"] = comm.broadcast(t["x"], root=root)
        out[f"bv{root}"] = comm.broadcast_value(t["value"][0], root)[None]
        out[f"red{root}"] = comm.reduce(t["ints"], root=root)
    out["consensus_same"] = torch.tensor([comm.consensus(t["same"])])
    out["consensus_diff"] = torch.tensor([comm.consensus(t["x"])])
    digests = [b"kf-%d" % 7] * comm.addressable_n
    out["digests"] = torch.tensor([comm.consensus_bytes(digests)])
    with comm.world():
        for bidi in (False, True):
            for key in ("x", "bf16"):
                rs = ring.ring_reduce_scatter(t[key], "kf_local",
                                              bidirectional=bidi)
                out[f"ring_rs_{key}_{bidi}"] = rs
                out[f"ring_ag_{key}_{bidi}"] = ring.ring_all_gather(
                    rs, "kf_local", bidirectional=bidi)
        out["rank"] = collective.peer_rank("kf_local")
        out["barrier"] = collective.barrier_value(comm.axis)
    comm.barrier()
    out.update(zero_steps(comm))
    res = {}
    for k, v in out.items():
        v = v.detach()
        res[k] = (v.view(torch.int16) if v.dtype == torch.bfloat16
                  else v).numpy()
    return res


def zero_steps(comm) -> dict:
    """Three steps of the MNIST SLP (the example's numpy params and
    batches) through ZeRO-1 and through ZeRO-2 under each flat schedule,
    SGD with momentum, buckets of 4 KiB: each step's loss, the params
    after and this process's rows of every optimizer-state leaf."""
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.ops.schedules import FLAT_SCHEDULES
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.zero import zero_train_step
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    model = mnist_slp()
    out = {}
    for stage, sched in [(1, "lax")] + [(2, s) for s in FLAT_SCHEDULES]:
        params = tree_map(torch.from_numpy, slp_params())
        step, init_opt = zero_train_step(
            lambda p, b: model.loss(p, b), sgd(0.1, momentum=0.9), comm,
            stage=stage, bucket_bytes=4096, schedule=sched)
        state = init_opt(params)
        losses = []
        for x, y in epoch_batches(comm.size, 3):
            params, state, loss = step(params, state, (torch.from_numpy(x),
                                                       torch.from_numpy(y)))
            losses.append(loss)
        key = f"zero{stage}_{sched}"
        out[f"{key}_loss"] = torch.stack(losses)
        out[f"{key}_params"] = torch.cat(
            [leaf.reshape(-1) for leaf in tree_leaves(params)])
        for i, leaf in enumerate(tree_leaves(state)):
            out[f"{key}_state{i}"] = leaf
    return out


# -- A17: gradients through the span, ZeRO-3, replicas, the sharded mesh --

#: the per-rank input of the vjp cases: [VJP_LEN] floats
VJP_LEN = 48


def _vjp_cases(comm):
    """``{name: fn}``: each a collective (or a chain of them) over the
    span's axis on a stacked ``[rows, VJP_LEN]`` input."""
    from kungfu_tpu_torch.ops import collective as coll
    from kungfu_tpu_torch.ops import collectives as ring
    from kungfu_tpu_torch.ops.schedules import (_all_gather_tiled,
                                                _psum_scatter,
                                                all_gather_flat,
                                                all_reduce_scheduled,
                                                reduce_scatter_flat)

    n, ax = comm.size, "kf_local"
    shift = [((j + 1) % n, j) for j in range(n)]
    cases = {
        "ar_sum": lambda x: coll.all_reduce(x, comm.axis),
        "ar_mean": lambda x: coll.all_reduce(x, comm.axis, op="mean"),
        "ar_max": lambda x: coll.all_reduce(x, comm.axis, op="max"),
        "ar_min": lambda x: coll.all_reduce(x, ax, op="min"),
        "ag": lambda x: coll.all_gather(x, ax),
        "ag_tiled": lambda x: coll.all_gather(x, ax, tiled=True),
        "bcast1": lambda x: coll.broadcast(x, ax, root=1),
        "psum_scatter": lambda x: _psum_scatter(x, ax),
        "ag_tiled_lax": lambda x: _all_gather_tiled(x, ax),
        "ppermute_shift": lambda x: coll.ppermute(x, ax, shift),
        "ppermute_part": lambda x: coll.ppermute(x, ax, [(0, n - 1),
                                                         (1, 0)]),
        "all_to_all": lambda x: coll.all_to_all(
            x.reshape(x.shape[0], n * 2, -1), ax, 0, 1),
        "sched_ring": lambda x: all_reduce_scheduled(x, ax,
                                                     schedule="ring"),
        "sched_two_stage": lambda x: all_reduce_scheduled(
            x, ax, schedule="two_stage"),
        "sched_pallas_ring": lambda x: all_reduce_scheduled(
            x, ax, schedule="pallas_ring"),
        "ring_rs": lambda x: ring.ring_reduce_scatter(x, ax),
        "ring_ag": lambda x: ring.ring_all_gather(x, ax, bidirectional=True),
        "chain": lambda x: coll.all_gather(
            coll.all_reduce(x, ax) * x, ax, tiled=True).tanh(),
    }
    for sched in ("lax", "pallas_ring"):
        cases[f"flat_ag_{sched}"] = lambda x, s=sched: all_gather_flat(
            x, [ax], widths=(5, 7, VJP_LEN - 12), schedule=s)
        cases[f"flat_rs_{sched}"] = lambda x, s=sched: reduce_scatter_flat(
            x, [ax], VJP_LEN // n, widths=(3, VJP_LEN // n - 3),
            schedule=s)
    return cases


def vjps(comm, x_rows, first: int) -> dict:
    """Each case's output and input gradient on this process's rows
    ``x_rows`` of every rank's ``[n, VJP_LEN]`` input, under seeded
    cotangents drawn for every rank (``first``: this process's first
    rank), and ``axis_index`` over the span."""
    from kungfu_tpu_torch.ops import collective as coll

    out = {}
    rows = x_rows.shape[0]
    with comm.world():
        for i, (name, fn) in enumerate(_vjp_cases(comm).items()):
            x = torch.from_numpy(x_rows.copy()).requires_grad_(True)
            y = fn(x)
            rng = np.random.default_rng([SEED, i])
            ct = rng.standard_normal((comm.size,) + tuple(y.shape[1:]))
            ct = torch.from_numpy(ct[first:first + rows].astype(np.float32))
            (g,) = torch.autograd.grad(y, x, ct)
            out[f"vjp_{name}_y"] = y.detach()
            out[f"vjp_{name}_g"] = g
        out["axis_index"] = coll.axis_index("kf_local", device="cpu")
    return out


def zero3_steps(comm) -> dict:
    """Three ZeRO-3 steps of the MNIST SLP under each flat schedule (SGD
    with momentum, buckets of 4 KiB): each step's loss, this process's
    rows of the parameter shard and the momentum, and the gathered
    params."""
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.ops.schedules import FLAT_SCHEDULES
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.zero import zero_train_step
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    model = mnist_slp()
    out = {}
    for sched in FLAT_SCHEDULES:
        params = tree_map(torch.from_numpy, slp_params())
        z = zero_train_step(lambda p, b: model.loss(p, b),
                            sgd(0.1, momentum=0.9), comm, stage=3,
                            bucket_bytes=4096, schedule=sched)
        p, state = z.init_params(params), z.init_opt(params)
        losses = []
        for x, y in epoch_batches(comm.size, 3):
            p, state, loss = z.step(p, state, (torch.from_numpy(x),
                                               torch.from_numpy(y)))
            losses.append(loss)
        key = f"zero3_{sched}"
        out[f"{key}_loss"] = torch.stack(losses)
        out[f"{key}_shard"] = p
        out[f"{key}_params"] = torch.cat(
            [leaf.reshape(-1) for leaf in tree_leaves(z.gather_params(p))])
        for i, leaf in enumerate(tree_leaves(state)):
            out[f"{key}_state{i}"] = leaf
    return out


#: the per-replica transforms (the others keep the params replicated)
REPLICA_TX = ("sma", "ada")


def replica_steps(comm) -> dict:
    """Three per-replica steps of the MNIST SLP through
    ``dp_train_step(replicated_params=False)``: SMA (alpha 0.1) and
    AdaptiveSGD (the switch at step 1), SGD with momentum inside, the params and state
    this process's rows; then three S-SGD steps under the
    gradient-noise-scale and variance monitors.  Each step's loss
    and the rows after the last."""
    from kungfu_tpu_torch.examples.device_elastic import (epoch_batches,
                                                          slp_params)
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.optimizers import (adaptive_sgd,
                                             monitor_gradient_noise_scale,
                                             monitor_gradient_variance, sgd,
                                             synchronous_averaging)
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 stack_for_replicas)
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    model = mnist_slp()
    inner = sgd(0.1, momentum=0.9)
    txs = {"sma": synchronous_averaging(inner, comm.axis, alpha=0.1),
           "ada": adaptive_sgd(inner, comm.axis, change_step=1),
           "gns": monitor_gradient_noise_scale(inner, comm.axis, 8),
           "var": monitor_gradient_variance(inner, comm.axis)}
    out = {}
    for name, tx in txs.items():
        stacked = name in REPLICA_TX
        params = tree_map(torch.from_numpy, slp_params())
        state = tx.init(params)
        if stacked:
            params = stack_for_replicas(params, comm.addressable_n)
            state = stack_for_replicas(state, comm.addressable_n)
        step = dp_train_step(lambda p, b: model.loss(p, b), tx, comm,
                             replicated_params=not stacked)
        losses = []
        for x, y in epoch_batches(comm.size, 3):
            params, state, loss = step(params, state, (torch.from_numpy(x),
                                                       torch.from_numpy(y)))
            losses.append(loss)
        out[f"{name}_loss"] = torch.stack(losses)
        for i, leaf in enumerate(tree_leaves(params)):
            out[f"{name}_param{i}"] = leaf
        for i, leaf in enumerate(tree_leaves(state)):
            out[f"{name}_state{i}"] = leaf
    return out


#: the sharded trainer's narrow model and batch (dp=2 x tp=2)
SHARDED_CFG = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4,
                   d_ff=128, max_seq=32, causal=True, pos="rope",
                   dtype="float32")
SHARDED_LR = 0.05


def sharded_batches(steps: int = 2):
    rng = np.random.default_rng([SEED, 4])
    return [tuple(rng.integers(0, SHARDED_CFG["vocab_size"], size=(8, 32))
                  .astype(np.int32) for _ in range(2))
            for _ in range(steps)]


def sharded_steps(comm) -> dict:
    """Two ``ShardedTrainer`` steps over ``dp=2 x tp=2`` on ``comm``'s
    four ranks, under psum and pallas_ring: each step's loss, this
    process's rows of every param leaf, and the gathered global params
    (flat)."""
    from kungfu_tpu_torch.models.transformer import TransformerConfig
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.train import ParallelPlan, ShardedTrainer
    from kungfu_tpu_torch.utils.tree import tree_leaves

    out = {}
    for sched in ("psum", "pallas_ring"):
        trainer = ShardedTrainer(
            TransformerConfig(**SHARDED_CFG),
            ParallelPlan(dp=2, tp=2, collective_schedule=sched),
            tx=sgd(SHARDED_LR), devices=comm)
        state = trainer.init(torch.Generator().manual_seed(0))
        losses = []
        for ids, tgt in sharded_batches():
            state, loss = trainer.step(state, (torch.from_numpy(ids),
                                               torch.from_numpy(tgt)))
            losses.append(loss)
        out[f"sharded_{sched}_loss"] = torch.stack(losses)
        for i, leaf in enumerate(tree_leaves(state["params"])):
            out[f"sharded_{sched}_p{i}"] = leaf
        out[f"sharded_{sched}_global"] = torch.cat(
            [leaf.reshape(-1) for leaf in
             tree_leaves(trainer.gather_params(state["params"]))])
    return out


def a17(comm, full: dict, first: int, rows: int) -> dict:
    """Every A17 check's results on this process's rows (all of them
    with one process), numpy out."""
    out = vjps(comm, full["vjp"][first:first + rows], first)
    out.update(zero3_steps(comm))
    out.update(replica_steps(comm))
    out.update(sharded_steps(comm))
    return {k: v.detach().numpy() for k, v in out.items()}


def a17_inputs(n: int) -> dict:
    rng = np.random.default_rng([SEED, 17])
    return {"vjp": rng.standard_normal((n, VJP_LEN)).astype(np.float32)}


def _world_comm(root: str, index: int, rows: int):
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.comm.host import PyHostChannel
    from kungfu_tpu_torch.comm.world import ProcessWorld
    from kungfu_tpu_torch.plan.peer import PeerID
    from kungfu_tpu_torch.plan.peerlist import PeerList

    chan = PyHostChannel(PeerID("127.0.0.1", 0))
    tmp = os.path.join(root, f"port{index}.tmp")
    with open(tmp, "w") as f:
        f.write(str(chan.self_id.port))
    os.replace(tmp, os.path.join(root, f"port{index}"))
    peers_file = os.path.join(root, "peers")
    deadline = time.time() + 60
    while not os.path.exists(peers_file):
        if time.time() > deadline:
            raise TimeoutError("no peer list")
        time.sleep(0.02)
    with open(peers_file) as f:
        peers = PeerList.parse(f.read().strip())
    world = ProcessWorld(chan, peers, chan.self_id, "cpu", rows).boot()
    comm = Communicator(devices=["cpu"] * rows,
                        span=world.span(peers, version=0))
    return comm, chan.close


def _peer_comm(root: str, index: int, procs: int, rows: int):
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.utils import envs

    with open(os.path.join(root, "ports")) as f:
        ports = f.read().strip().split(",")
    os.environ[envs.NUM_DEVICES] = str(rows)
    os.environ[envs.JAX_PLATFORM] = "cpu"
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    peer = Peer(envs.parse_config_from_env({
        envs.SELF_SPEC: f"127.0.0.1:{ports[index]}",
        envs.INIT_PEERS: peers,
        envs.COORDINATOR: f"127.0.0.1:{int(ports[0]) + 1}",
        envs.NUM_PROCESSES: str(procs),
        envs.PROCESS_ID: str(index)}))
    peer.start()
    comm = peer.communicator()
    if comm.span is None or comm.size != procs * rows:
        raise AssertionError(f"the fixed world's communicator is {comm!r}")
    return comm, peer.close


def main(argv) -> int:
    root, index, procs, rows, mode = (argv[0], int(argv[1]), int(argv[2]),
                                      int(argv[3]), argv[4])
    if mode == "world":
        comm, close = _world_comm(root, index, rows)
    else:
        comm, close = _peer_comm(root, index, procs, rows)
    span = comm.span
    if len(argv) > 5 and argv[5] == "a17":
        res = a17(comm, a17_inputs(comm.size), span.first, rows)
    else:
        full = inputs(comm.size)
        mine = {k: v[span.first:span.first + rows] for k, v in full.items()}
        res = collectives(comm, mine)
    res["stats"] = np.array([span.stats["exchanges"], span.stats["opens"]])
    np.savez(os.path.join(root, f"out{index}.npz"), **res)
    comm.close()
    close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
