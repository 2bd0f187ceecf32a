"""Port parity: the device examples (``long_context``, ``shard_train``,
``strategy_tour``, ``serve_demo``), each called in-process through its
``main(argv)`` on co-resident CPU ranks (``--cpu-devices``, or
``KF_JAX_PLATFORM=cpu`` for the serving demo's peers), at the reference's
test arguments, passing its own assertions; then each model held against
the JAX package at the same weights (the reference's init carried in by
:mod:`kungfu_tpu_torch.interop`, or the port's carried out):

* ``long_context``: the ring loss over four sp ranks (flash blocks, their
  plain versions here, and einsum blocks) at ``--seq-len 128`` against
  the reference example's ``shard_map`` ring, and the loss after one
  Adam step, at ``rtol 2e-5, atol 2e-5`` (the ring forward's tolerance
  in ``test_torch_port_ring.py``);
* ``shard_train``: its first two losses (Adam) on dp2 x sp2 x tp2 in the
  example's bf16 against the reference ``ShardedTrainer``'s, at
  ``rtol 1e-4``;
* ``strategy_tour``: the S-SGD (momentum) and ZeRO-1 losses over eight
  ranks against the reference's ``dp_train_step`` and
  ``zero1_train_step`` at ``rtol 1e-5`` (``test_torch_port_parallel.py``'s
  loss tolerance);
* ``serve_demo``: every served request's tokens, the replayed ones
  included, token for token the reference engine's greedy drain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from kungfu_tpu_torch import interop
from kungfu_tpu_torch.examples import (long_context, serve_demo, shard_train,
                                       strategy_tour)

RING_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
#: shard_train runs in bf16 (the reference example's default dtype):
#: both packages round the products' inputs to bf16, but accumulate and
#: order the reductions their own ways.  Readings here: 1.2e-5 to 4.6e-5
#: over the two losses, dense and MoE; the limit is the one the card's
#: check holds a bf16 model's loss to (chip_smoke.MODEL_LOSS_RTOL)
BF16_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the lockstep ranks' small products gain
    nothing from more, and the other workers of a parallel run keep
    their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# -- long_context --------------------------------------------------------------

LC_ARGS = ["--sp", "4", "--seq-len", "128", "--cpu-devices", "4", "--steps",
           "3", "--d-model", "64", "--block-impl", "flash"]


def test_long_context_runs(capsys):
    """The reference's ``TestLongContextExample`` arguments: the dense
    check holds and the loss falls."""
    report = {}
    assert long_context.main(LC_ARGS, report) == 0
    out = capsys.readouterr().out
    assert "loss check: ring=" in out and out.rstrip().endswith("OK")
    got, ref = report["dense_check"]
    assert abs(got - ref) < 1e-4
    assert report["losses"][-1] < report["losses"][0]


def test_long_context_too_few_ranks(capsys):
    assert long_context.main(["--sp", "4", "--cpu-devices", "2"]) == 1
    assert "need 4 devices, have 2" in capsys.readouterr().err


def _ref_sharded_loss(jm, sp, s_loc, block_impl):
    """The reference example's ``sharded_loss`` (``shard_map`` over the
    first ``sp`` virtual devices)."""
    from kungfu_tpu.parallel.ring import make_ring_attn
    from kungfu_tpu.utils.jaxcompat import shard_map

    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    attn = make_ring_attn(axis="sp", block_impl=block_impl)

    def loss(params, ids, targets):
        def inner(ids_shard, tgt_shard):
            pos = jax.lax.axis_index("sp") * s_loc + jnp.arange(s_loc)
            positions = jnp.broadcast_to(pos, ids_shard.shape)
            local = jm.loss(params, (ids_shard, tgt_shard), attn_fn=attn,
                            positions=positions)
            return jax.lax.pmean(local, "sp")

        return shard_map(inner, mesh=mesh, in_specs=(JP(None, "sp"),) * 2,
                         out_specs=JP(), check_vma=False)(ids, targets)

    return loss


def test_long_context_matches_reference():
    """The example's ring loss (flash blocks, and the CPU's default
    einsum blocks), and its loss after one Adam step through the flash
    blocks, at the reference's weights against the reference example's
    ``shard_map`` ring (its CPU default, einsum blocks: the exact same
    attention; its Pallas blocks in interpret mode take minutes a
    gradient here)."""
    from kungfu_tpu.models.transformer import Transformer as JTransformer
    from kungfu_tpu.models.transformer import TransformerConfig as JConfig
    from kungfu_tpu_torch.optimizers import adam

    args = long_context.parse_args(LC_ARGS)
    model, _, ids, targets = long_context.build(args, torch.device("cpu"))
    jm = JTransformer(JConfig(**vars(model.cfg)))
    jp = jm.init(jax.random.PRNGKey(0))
    params = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     model.cfg, device="cpu")
    jids, jtgt = jnp.asarray(ids.numpy(), jnp.int32), jnp.asarray(
        targets.numpy(), jnp.int32)
    jloss = jax.jit(_ref_sharded_loss(jm, 4, 128 // 4, "auto"))
    want = float(jloss(jp, jids, jtgt))
    for impl in ("flash", "auto"):
        with torch.no_grad():
            got = float(long_context.sharded_loss(
                model, params, ids, targets, 4,
                long_context.ring_attn(4, impl)))
        np.testing.assert_allclose(got, want, **RING_TOL, err_msg=impl)

    attn = long_context.ring_attn(4, "flash")
    opt, jopt = adam(1e-3), optax.adam(1e-3)
    step = long_context.train_step(model, opt, 4, attn)
    params, _, loss0 = step(params, opt.init(params), ids, targets)
    g = jax.jit(jax.grad(jloss))(jp, jids, jtgt)
    u, _ = jopt.update(g, jopt.init(jp), jp)
    jp1 = optax.apply_updates(jp, u)
    np.testing.assert_allclose(float(loss0), want, **RING_TOL)
    with torch.no_grad():
        got1 = float(long_context.sharded_loss(model, params, ids, targets,
                                               4, attn))
    np.testing.assert_allclose(got1, float(jloss(jp1, jids, jtgt)),
                               **RING_TOL)


# -- shard_train ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--cpu-devices", "8", "--steps", "3"],
    ["--cpu-devices", "8", "--steps", "2", "--experts", "4"],
], ids=["dense", "moe"])
def test_shard_train_runs(capsys, argv):
    assert shard_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "mesh MeshPlan(dp=2, pp=1, sp=2, tp=2) over 8/8 devices" in out
    assert ("moe ffn" if "--experts" in argv else "dense ffn") in out
    assert out.rstrip().endswith("OK")


def test_shard_train_too_few_ranks():
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        shard_train.main(["--cpu-devices", "4"])


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_shard_train_matches_reference(experts):
    """The example's trainer and batch at the reference trainer's
    weights (``interop.sharded_params_from_jax``): the first two losses
    of Adam, against the reference ``ShardedTrainer`` on the conftest's
    8 virtual devices."""
    from kungfu_tpu.models.transformer import TransformerConfig as JConfig
    from kungfu_tpu.parallel import MeshPlan as JMeshPlan
    from kungfu_tpu.parallel import ShardedTrainer as JShardedTrainer

    args = shard_train.parse_args(["--cpu-devices", "8", "--experts",
                                   str(experts)])
    plan, _, trainer, batch = shard_train.build(args)
    jtr = JShardedTrainer(JConfig(**vars(trainer.cfg)),
                          JMeshPlan(dp=plan.dp, pp=plan.pp, sp=plan.sp,
                                    tp=plan.tp),
                          n_experts=experts, tx=optax.adam(1e-3))
    jstate = jtr.init(jax.random.PRNGKey(0))
    glob = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jstate["params"]))
    params = interop.sharded_params_from_jax(glob, trainer)
    state = {"params": params, "opt_state": trainer.tx.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    jbatch = tuple(jnp.asarray(b.numpy(), jnp.int32) for b in batch)
    want = []
    for _ in range(2):
        jstate, jloss = jtr.step(jstate, jbatch)
        want.append(float(jloss))
    got = shard_train.train(trainer, state, batch, 2)
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)


# -- strategy_tour -------------------------------------------------------------

def test_strategy_tour_runs(capsys):
    """The reference's ``TestStrategyTourExample``: every stage runs and
    the injected slowdown re-tunes exactly once at ``--steps 18``."""
    assert strategy_tour.main(["--cpu-devices", "8", "--steps", "18"]) == 0
    out = capsys.readouterr().out
    assert "[1] autotune" in out
    assert "adaptive re-tunes: 1" in out
    assert "[4] zero1" in out and "(1/8)" in out


def test_strategy_tour_matches_reference():
    """S-SGD (momentum 0.9, psum) for six steps and four ZeRO-1 steps at
    the example's weights and batch, against the reference's
    ``dp_train_step`` and ``zero1_train_step`` over 8 virtual devices."""
    from kungfu_tpu.comm.device import Communicator as JComm
    from kungfu_tpu.models.mlp import MLP as JMLP
    from kungfu_tpu.optimizers import synchronous_sgd as jssgd
    from kungfu_tpu.parallel import zero1_train_step as jzero1
    from kungfu_tpu.parallel.train import dp_train_step as jdp
    from kungfu_tpu_torch.comm.device import Communicator

    comm = Communicator(devices=["cpu"] * 8)
    params, batch, loss_fn = strategy_tour.build(comm)
    step, tx = strategy_tour.make_step(comm, loss_fn)
    assert comm.strategy == "psum"
    opt, p, got = tx.init(params), params, []
    for _ in range(6):
        p, opt, loss = step(p, opt, batch)
        got.append(float(loss))
    zgot, _, _ = strategy_tour.zero1(comm, loss_fn, params, batch)

    jcomm = JComm()
    jm = JMLP([64, 32], num_classes=10, input_dim=64)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jb = (jnp.asarray(batch[0].numpy()), jnp.asarray(batch[1].numpy(),
                                                     jnp.int32))

    def jloss(p, b):
        x, y = b
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, x), y).mean()

    jtx = jssgd(optax.sgd(0.1, momentum=0.9), jcomm.axis, schedule="psum")
    jstep = jdp(jloss, jtx, jcomm)
    jopt, q, want = jtx.init(jp), jp, []
    for _ in range(6):
        q, jopt, loss = jstep(q, jopt, jb)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    zstep, zinit = jzero1(jloss, optax.sgd(0.1, momentum=0.9), jcomm)
    zopt, q, zwant = zinit(jp), jp, []
    for _ in range(4):
        q, zopt, loss = zstep(q, zopt, jb)
        zwant.append(float(loss))
    np.testing.assert_allclose(zgot, zwant, rtol=LOSS_RTOL)


# -- serve_demo ----------------------------------------------------------------

@pytest.fixture
def _serve_env(monkeypatch):
    from kungfu_tpu_torch import chaos

    monkeypatch.setenv("KF_JAX_PLATFORM", "cpu")
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
    for k in ("KF_CHAOS_SPEC", "KF_CONFIG_ENABLE_MONITORING",
              "KF_CONFIG_ENABLE_CLUSTER_MONITOR"):
        monkeypatch.delenv(k, raising=False)
    chaos.reset()
    yield
    chaos.reset()


def _ref_drain(jm, jp, prompts, n):
    """The reference engine's greedy tokens for each prompt."""
    from kungfu_tpu.serve.engine import InferenceEngine as JEngine
    from kungfu_tpu.serve.kvcache import KVCachePool as JPool
    from kungfu_tpu.serve.kvcache import PageSpec as JPageSpec

    eng = JEngine(jm, jp, pool=JPool(JPageSpec.for_model(jm.cfg,
                                                        page_tokens=8), 256),
                  max_batch=4, max_seq=jm.cfg.max_seq)
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p, n)
    done = {e["rid"]: e["tokens"] for e in eng.drain() if e["kind"] == "done"}
    return [done[f"r{i}"] for i in range(len(prompts))]


def test_serve_demo_runs(_serve_env, capsys):
    """The demo at its defaults: zero lost requests through the kill."""
    import os

    report = {}
    before = dict(os.environ)
    assert serve_demo.main([], report) == 0
    assert dict(os.environ) == before  # main's environment is scoped
    out = capsys.readouterr().out
    assert "serve-demo: survived worker kill; 24/24 requests completed" in out
    assert report["replayed"] >= 1 and report["reused"] > 0


def test_serve_demo_matches_reference(_serve_env):
    """The demo's deployment at the reference's weights: every request's
    tokens, the replayed ones included, token for token the reference
    engine's greedy drain."""
    from kungfu_tpu.models.transformer import Transformer as JTransformer
    from kungfu_tpu.models.transformer import TransformerConfig as JConfig
    from kungfu_tpu_torch.examples._local import (close_all, local_peers,
                                                  scoped_env)

    model, _ = serve_demo.build(torch.device("cpu"))
    jm = JTransformer(JConfig(**vars(model.cfg)))
    jp = jm.init(jax.random.PRNGKey(0))
    params = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     model.cfg, device="cpu")
    with scoped_env(serve_demo.ENV, serve_demo.ENV_DEFAULT):
        peers = local_peers(4)
        try:
            out = serve_demo.serve(model, params, peers, 24, 24)
        finally:
            close_all(peers)
    assert any(out["replays"])
    prompts = [p for p, _ in out["requests"]]
    want = _ref_drain(jm, jp, prompts, 24)
    assert [t for _, t in out["requests"]] == want


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _stuck_victim(pkg, peers, model, params):
    """The demo's engines, kill and router ladder in package ``pkg``'s
    serve modules, with two workers (the third changes nothing here):
    request A holds worker 0, so B goes to worker 1 (least
    outstanding), which the chaos kill takes at its 10th decode
    iteration; no request follows.  ``(tokens a request, B's replays,
    the dead list, worker 1 dead)``."""
    import importlib

    engine = importlib.import_module(f"{pkg}.serve.engine")
    kvcache = importlib.import_module(f"{pkg}.serve.kvcache")
    router_mod = importlib.import_module(f"{pkg}.serve.router")
    cfg = model.cfg
    servers, router = [], None
    try:
        for p in peers[:2]:
            eng = engine.InferenceEngine(
                model, params,
                pool=kvcache.KVCachePool(
                    kvcache.PageSpec.for_model(cfg, page_tokens=8), 256),
                max_batch=4, max_seq=cfg.max_seq, rank=p.chaos_rank())
            eng.warmup(prompt_lens=(len(serve_demo.SYSTEM_PROMPT) + 4,))
            servers.append(router_mod.ServeWorker(p, eng,
                                                  commit_every=2).start())
        router = router_mod.ServeRouter(peers[2], worker_ranks=[0, 1],
                                        queue_depth=64, deadline_s=1.0)
        handles = [router.submit(serve_demo.SYSTEM_PROMPT + [20 + i], 40)
                   for i in range(2)]
        lens = [len(h.wait(60)) for h in handles]
        return lens, handles[1].replays, router.dead_workers, servers[1].dead
    finally:
        if router is not None:
            router.close()
        for sv in servers:
            if not sv.dead:
                sv.stop()
        for p in peers:
            try:
                p.close()
            except Exception:  # noqa: BLE001 - the victim is already down
                pass


def test_one_stuck_request_leaves_the_victim_live(_serve_env, monkeypatch):
    """Why the demo's dead-list assertion needs load: a killed worker
    that holds one request and is sent no other takes one strike when
    that request's deadline passes, under the strike limit of 2, so the
    request replays alone and the worker stays off the dead list.  The
    reference's router (least-outstanding dispatch, ties to the lowest
    rank) does the same; on a card fast enough that requests seldom
    outlast the demo's 20 ms between arrivals, its defaults can end here
    (ROADMAP C42)."""
    from kungfu_tpu import chaos as jchaos
    from kungfu_tpu.models.transformer import Transformer as JTransformer
    from kungfu_tpu.models.transformer import TransformerConfig as JConfig
    from kungfu_tpu.peer import Peer as JPeer
    from kungfu_tpu.utils import envs as jenvs
    from kungfu_tpu_torch.examples._local import local_peers, scoped_env
    from kungfu_tpu_torch.utils import envs

    model, params = serve_demo.build(torch.device("cpu"))
    with scoped_env(serve_demo.ENV, serve_demo.ENV_DEFAULT):
        mine = _stuck_victim("kungfu_tpu_torch", local_peers(3), model,
                             params)
    for k, v in serve_demo.ENV.items():
        monkeypatch.setenv(k, v)
    jchaos.reset()
    try:
        ports = _free_ports(3)
        jpeers = [JPeer(jenvs.parse_config_from_env(
            envs.single_machine_env(r, 3, ports=ports))) for r in range(3)]
        for p in jpeers:
            p.start()
        jm = JTransformer(JConfig(**vars(model.cfg)))
        ref = _stuck_victim("kungfu_tpu", jpeers, jm,
                            jm.init(jax.random.PRNGKey(0)))
    finally:
        jchaos.reset()
    assert mine == ref == ([40, 40], 1, [], True)


# -- narrow heads on the card --------------------------------------------------

def test_padded_head_dim():
    """The serving demo's heads are 16 wide; the kernels are compiled for
    32, 64, 96, 128 and 256.  Its head pads to 32, the narrowest compiled
    width above it, with the scale 1/sqrt(16) of the unpadded width
    passed to the kernels; a compiled width runs as it is."""
    from kungfu_tpu_torch.examples.serve_demo import build
    from kungfu_tpu_torch.ops.cuda.attention import (COMPILED_HEAD_DIMS,
                                                     kernel_head_dim)

    cfg = build("cpu")[0].cfg
    d = cfg.d_model // cfg.n_heads
    assert d == 16 and d not in COMPILED_HEAD_DIMS
    assert kernel_head_dim(d) == (32, 0.25)
    assert all(kernel_head_dim(c) == (c, 1.0 / c ** 0.5)
               for c in COMPILED_HEAD_DIMS)


@pytest.mark.parametrize("s", [40, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_heads_equal_unpadded(s, causal):
    """The padded path (here through the plain versions, which the card's
    kernels are held to) gives the unpadded attention, lse and q/k/v
    gradients."""
    from kungfu_tpu_torch.ops.cuda import attention

    d = 16  # serve_demo's head
    dp, _ = attention.kernel_head_dim(d)
    rng = np.random.default_rng(s)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((6, s, d)).astype(
        np.float32)) for _ in range(4))
    dl = torch.from_numpy(rng.standard_normal((6, s)).astype(np.float32))

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = fn(*ts)
        grads = torch.autograd.grad((out, lse), ts, (do, dl))
        return [out.detach(), lse.detach(), *grads]

    got = run(lambda *t: attention._flash_padded(*t, causal, dp))
    want = run(lambda *t: attention._Flash.apply(*t, causal))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
