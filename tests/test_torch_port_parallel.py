"""Port parity: the in-mesh 4-D plan — MeshPlan, the pipeline geometry,
ParallelPlan and ShardedTrainer — against the reference.

The reference's ``ShardedTrainer`` runs under ``shard_map`` on the
conftest's 8 virtual CPU devices; the port's runs its ranks in lockstep
on ``["cpu"] * 8``, stacked on a leading axis.  Both trainers get the
same weights: the reference's ``Transformer.init`` carried into the port
by ``interop.params_from_jax`` (one rank) and, for trees the reference
trainer built itself (MoE), its global arrays by
``interop.sharded_params_from_jax``.  Tolerances are the reference
suite's (``tests/test_parallel.py``): the loss at rtol 1e-5, one step's
params at rtol 2e-4 / atol 2e-5, MoE EP against local routing at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from kungfu_tpu.models.transformer import (Transformer as JTransformer,
                                           TransformerConfig as JConfig)
from kungfu_tpu.parallel import MeshPlan as JMeshPlan
from kungfu_tpu.parallel import ShardedTrainer as JShardedTrainer
from kungfu_tpu.parallel import moe as jmoe
from kungfu_tpu.parallel import pp as jpp
from kungfu_tpu.parallel.train import ParallelPlan as JPlan
from kungfu_tpu.parallel.train import dp_train_step as jdp_train_step
from kungfu_tpu.utils.jaxcompat import shard_map
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models.transformer import TransformerConfig
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.ops.xent import XENT_ENV
from kungfu_tpu_torch.optimizers import adam, sgd
from kungfu_tpu_torch.parallel import (AXES, MeshPlan, ParallelPlan,
                                       ShardedTrainer, moe_apply, moe_init,
                                       pp)
from kungfu_tpu_torch.parallel.train import dp_train_step
from kungfu_tpu_torch.utils.tree import tree_leaves

CFG = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_seq=32, causal=True, pos="rope", dtype="float32")
CPU8 = ["cpu"] * 8
LOSS_RTOL = 1e-5
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)

#: tests/test_parallel.py:144-150
PLANS = [(1, 1, 1, 1), (2, 1, 2, 2), (2, 2, 1, 2), (1, 2, 2, 2), (8, 1, 1, 1)]


def _ids(plan):
    return "dp{}pp{}sp{}tp{}".format(*plan)


def _batch(B=8, S=32, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, size=(B, S)).astype(np.int32),
            rng.integers(0, vocab, size=(B, S)).astype(np.int32))


def _jbatch(batch):
    return tuple(jnp.asarray(b) for b in batch)


def _tbatch(batch):
    return tuple(torch.from_numpy(b) for b in batch)


def _models(pos="rope"):
    """The reference model, its params from key 0, and the same params
    as the port's tree."""
    cfg = {**CFG, "pos": pos}
    jm = JTransformer(JConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 TransformerConfig(**cfg), device="cpu")
    return cfg, jm, jp, tp


def _state(trainer, params, step=0):
    return {"params": params, "opt_state": trainer.tx.init(params),
            "step": step}


def _assert_tree_close(got, want, tol):
    g_flat, w_flat = interop.flatten(got), interop.flatten(want)
    assert sorted(g_flat) == sorted(w_flat)
    for key in g_flat:
        np.testing.assert_allclose(np.asarray(g_flat[key]),
                                   np.asarray(w_flat[key]), **tol,
                                   err_msg=key)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the lockstep ranks'
    small products gain nothing from more, and the other workers of a
    parallel run keep their cores (their socket tests have deadlines)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.fixture
def xent_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("KF_TPU_XENT", mode)
        XENT_ENV.reload()
        from kungfu_tpu.ops.pallas.xent import XENT_ENV as JXENT

        JXENT.reload()

    yield set_mode
    monkeypatch.delenv("KF_TPU_XENT", raising=False)
    XENT_ENV.reload()


# -- mesh plan ---------------------------------------------------------------
class TestMeshPlan:
    @pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16, 30, 64])
    def test_auto_matches_reference(self, n):
        got, want = MeshPlan.auto(n), JMeshPlan.auto(n)
        assert (got.dp, got.pp, got.sp, got.tp) == (want.dp, want.pp,
                                                    want.sp, want.tp)
        assert got.size == n and got.ep == got.dp and str(got) == str(want)

    def test_auto_factorizations(self):
        p = MeshPlan.auto(8)
        assert (p.dp, p.tp, p.sp, p.pp) == (2, 2, 2, 1)
        assert MeshPlan.auto(16).pp == 2

    def test_build_mesh(self, monkeypatch):
        mesh = MeshPlan(dp=2, pp=1, sp=2, tp=2).build_mesh(CPU8)
        assert mesh.axes == [("dp", 2), ("pp", 1), ("sp", 2), ("tp", 2)]
        assert mesh.size == 8 and mesh.device.type == "cpu"
        with mesh.world():
            assert collective.peer_size(AXES) == 8
            assert collective.peer_rank("sp").tolist() == [0, 0, 1, 1] * 2
        with pytest.raises(ValueError, match="needs 8 devices"):
            MeshPlan.auto(8).build_mesh(["cpu"] * 4)
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        with pytest.raises(NotImplementedError, match="multi-card"):
            MeshPlan.auto(8).build_mesh(CPU8)


    def test_default_devices_are_the_card(self):
        """Without devices the mesh is ``["cuda"] * size``: on a host
        with no GPU the trainer raises instead of running on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a GPU is present; the default mesh would use it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedTrainer(TransformerConfig(**CFG), MeshPlan(dp=2))


# -- pipeline geometry (tests/test_pp.py TestPartition, TestSchedules) --------
class TestGeometry:
    @pytest.mark.parametrize("L", [2, 4, 7, 12, 13])
    def test_stage_partition_matches_reference(self, L):
        for S in range(1, L + 1):
            assert pp.stage_partition(L, S) == jpp.stage_partition(L, S)
        for S in (0, L + 1):
            with pytest.raises(ValueError):
                jpp.stage_partition(L, S)
            with pytest.raises(ValueError):
                pp.stage_partition(L, S)

    @pytest.mark.parametrize("L,S,v", [(8, 2, 2), (12, 3, 2), (12, 2, 3),
                                       (4, 4, 1)])
    def test_interleaved_partition_matches_reference(self, L, S, v):
        assert pp.interleaved_partition(L, S, v) == \
            jpp.interleaved_partition(L, S, v)
        assert pp.interleaved_partition(8, 2, 2) == [[(0, 2), (4, 6)],
                                                      [(2, 4), (6, 8)]]

    @pytest.mark.parametrize("m,S,v", [(4, 2, 1), (3, 2, 1), (2, 4, 1),
                                       (8, 4, 1), (1, 1, 1), (4, 2, 2),
                                       (3, 2, 3), (2, 3, 2)])
    def test_schedules_match_reference(self, m, S, v):
        for s in range(S):
            for name in pp.SCHEDULES:
                if v > 1 and name != "interleaved":
                    continue
                assert pp.build_schedule(name, m, S, s, v) == \
                    jpp.build_schedule(name, m, S, s, v)
            assert pp.schedule_1f1b(m, S, s) == jpp.schedule_1f1b(m, S, s)
            assert pp.schedule_sequential(m, S, s) == \
                jpp.schedule_sequential(m, S, s)

    def test_build_schedule_vocabulary(self):
        assert pp.SCHEDULES == jpp.SCHEDULES
        with pytest.raises(ValueError, match="unknown pp schedule"):
            pp.build_schedule("gpipe", 4, 2, 0)
        with pytest.raises(ValueError, match="interleave"):
            pp.build_schedule("1f1b", 4, 2, 0, v=2)
        with pytest.raises(ValueError, match="outside"):
            pp.schedule_1f1b(4, 2, 2)


# -- ParallelPlan --------------------------------------------------------------
PLAN_TABLE = [
    dict(), dict(dp=2, tp=2, pp=3, sp=1, zero_stage=2), dict(dp=0),
    dict(tp=0), dict(pp=-1), dict(sp=0), dict(zero_stage=4),
    dict(zero_stage=-1), dict(pp_schedule="gpipe"),
    dict(pp_schedule="interleaved", interleave=2), dict(interleave=2),
    dict(interleave=0), dict(n_micro=0), dict(n_micro=3),
    dict(collective_schedule="bogus"),
    dict(collective_schedule="pallas_ring"), dict(pp_schedule="sequential"),
]


class TestParallelPlan:
    @pytest.mark.parametrize("kwargs", PLAN_TABLE, ids=str)
    def test_accepts_and_refuses_as_the_reference(self, kwargs):
        def build(cls):
            try:
                return cls(**kwargs), None
            except Exception as e:  # noqa: BLE001 - compared below
                return None, e

        got, gerr = build(ParallelPlan)
        want, werr = build(JPlan)
        assert (gerr is None) == (werr is None), (gerr, werr)
        if werr is not None:
            assert type(gerr) is type(werr) and str(gerr) == str(werr)
        else:
            assert (got.size, got.host_size) == (want.size, want.host_size)
            mp = got.mesh_plan()
            assert (mp.dp, mp.pp, mp.sp, mp.tp) == (want.dp, want.pp,
                                                    want.sp, want.tp)

    def test_stage_geometry(self):
        p, j = ParallelPlan(dp=2, pp=3), JPlan(dp=2, pp=3)
        for r in range(6):
            assert (p.stage_of(r), p.dp_index(r)) == (j.stage_of(r),
                                                      j.dp_index(r))
        assert [p.stage_ranks(s) for s in range(3)] == \
            [j.stage_ranks(s) for s in range(3)]
        assert p.stage_map(6) == j.stage_map(6) == [(0, 2), (2, 4), (4, 6)]
        topo = p.to_slice_topology()
        assert (topo.num_slices, topo.ranks_per_slice) == (3, 2)
        assert ParallelPlan(dp=4).to_slice_topology() is None
        assert p.with_stages(2) == ParallelPlan(dp=2, pp=2)
        assert ParallelPlan(dp=2, tp=2, pp=3, zero_stage=2).host_size == 6

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("KF_PP_STAGES", "3")
        monkeypatch.setenv("KF_PP_MICROBATCHES", "6")
        monkeypatch.setenv("KF_PP_SCHEDULE", " Sequential ")
        got, want = ParallelPlan.from_env(dp=2), JPlan.from_env(dp=2)
        assert (got.pp, got.n_micro, got.pp_schedule, got.dp) == \
            (want.pp, want.n_micro, want.pp_schedule, want.dp) == \
            (3, 6, "sequential", 2)
        for k in ("KF_PP_STAGES", "KF_PP_MICROBATCHES", "KF_PP_SCHEDULE"):
            monkeypatch.delenv(k)
        p = ParallelPlan.from_env()
        assert (p.pp, p.n_micro, p.pp_schedule) == (1, None, "1f1b")
        monkeypatch.setenv("KF_PP_MICROBATCHES", "0")
        assert ParallelPlan.from_env().n_micro is None

    @pytest.mark.parametrize("kwargs", [dict(pp=2), dict(tp=2), dict(sp=2),
                                        dict(collective_schedule="ring")],
                             ids=str)
    def test_dp_train_step_raises_as_the_reference(self, kwargs):
        with pytest.raises(ValueError) as want:
            jdp_train_step(lambda p, b: 0.0, optax.sgd(0.1), comm=None,
                           plan=JPlan(**kwargs))
        with pytest.raises(ValueError) as got:
            dp_train_step(lambda p, b: 0.0, sgd(0.1), comm=None,
                          plan=ParallelPlan(**kwargs))
        assert str(got.value) == str(want.value)

    def test_sharded_trainer_accepts_plan(self):
        cfg = TransformerConfig(**CFG)
        t = ShardedTrainer(cfg, ParallelPlan(n_micro=2), devices=["cpu"])
        assert t.plan.dp == 1 and t.n_micro == 2 and t.schedule == "psum"
        t = ShardedTrainer(cfg, ParallelPlan(
            dp=2, tp=2, collective_schedule="pallas_ring"), devices=CPU8)
        assert t.schedule == "pallas_ring" and t.n_micro == 1
        for plan, kw, match in (
                (ParallelPlan(zero_stage=2), {}, "ZeRO"),
                (ParallelPlan(collective_schedule="ring"),
                 dict(schedule="two_stage"), "disagrees"),
                (MeshPlan(tp=3), {}, "n_heads"),
                (MeshPlan(pp=3), {}, "n_layers"),
                (MeshPlan(), dict(schedule="bogus"), "unknown schedule"),
                (MeshPlan(dp=3), dict(n_experts=4), "n_experts")):
            with pytest.raises(ValueError, match=match):
                ShardedTrainer(cfg, plan, devices=["cpu"] * plan.size
                               if hasattr(plan, "size") else None, **kw)


# -- the sharded trainer against the reference ---------------------------------
class TestShardedLoss:
    @pytest.mark.parametrize("plan", PLANS, ids=_ids)
    def test_loss_matches_reference(self, plan):
        cfg, jm, jp, tp = _models()
        batch = _batch()
        ref_loss = float(jm.loss(jp, _jbatch(batch), train=False))
        n_micro = 2 if plan[1] > 1 else 1
        jtr = JShardedTrainer(JConfig(**cfg), JMeshPlan(*plan),
                              n_micro=n_micro)
        jparams = jtr.from_transformer_params(jp)
        jloss = float(jtr.loss(_state(jtr, jparams), _jbatch(batch)))
        trainer = ShardedTrainer(TransformerConfig(**cfg), MeshPlan(*plan),
                                 n_micro=n_micro, devices=CPU8)
        params = trainer.from_transformer_params(tp)
        loss = float(trainer.loss(_state(trainer, params), _tbatch(batch)))
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)

    @pytest.mark.parametrize("plan", [(2, 1, 2, 2), (2, 2, 1, 2)], ids=_ids)
    def test_learned_positions(self, plan):
        cfg, jm, jp, tp = _models(pos="learned")
        batch = _batch()
        ref_loss = float(jm.loss(jp, _jbatch(batch), train=False))
        trainer = ShardedTrainer(TransformerConfig(**cfg), MeshPlan(*plan),
                                 n_micro=2 if plan[1] > 1 else 1,
                                 devices=CPU8)
        params = trainer.from_transformer_params(tp)
        assert "pos_embed" in params
        loss = float(trainer.loss(_state(trainer, params), _tbatch(batch)))
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)

    def test_fused_xent_matches_plain(self, xent_mode):
        """KF_TPU_XENT=fused routes the head through the fused op (its
        plain version on the CPU) in one launch over every last-stage
        rank's rows; each rank's mean equals the plain path's."""
        cfg, jm, jp, tp = _models()
        batch = _batch()
        xent_mode("plain")
        ref_loss = float(jm.loss(jp, _jbatch(batch), train=False))
        xent_mode("fused")
        trainer = ShardedTrainer(TransformerConfig(**cfg),
                                 MeshPlan(dp=2, pp=2, sp=1, tp=2), n_micro=2,
                                 devices=CPU8)
        params = trainer.from_transformer_params(tp)
        loss = float(trainer.loss(_state(trainer, params), _tbatch(batch)))
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-5)
        jtr = JShardedTrainer(JConfig(**cfg), JMeshPlan(2, 2, 1, 2),
                              n_micro=2)
        jloss = float(jtr.loss(_state(jtr, jtr.from_transformer_params(jp)),
                               _jbatch(batch)))
        np.testing.assert_allclose(loss, jloss, rtol=2e-5)

    @pytest.mark.parametrize("n_micro", [2, 4])
    def test_microbatch_counts(self, n_micro):
        cfg, jm, jp, tp = _models()
        batch = _batch()
        ref = float(jm.loss(jp, _jbatch(batch), train=False))
        trainer = ShardedTrainer(TransformerConfig(**cfg),
                                 MeshPlan(dp=1, pp=2, sp=1, tp=1),
                                 n_micro=n_micro, devices=["cpu"] * 2)
        params = trainer.from_transformer_params(tp)
        loss = float(trainer.loss(_state(trainer, params), _tbatch(batch)))
        assert loss == pytest.approx(ref, rel=LOSS_RTOL)


class TestShardedStep:
    @pytest.mark.parametrize("plan", [(2, 1, 2, 2), (2, 2, 1, 2)], ids=_ids)
    def test_step_matches_reference(self, plan):
        """One SGD step's params against the reference ShardedTrainer's
        and the single-device step's (tests/test_parallel.py:248-267)."""
        cfg, jm, jp, tp = _models()
        batch = _batch()
        lr = 0.05
        ref_grads = jax.grad(lambda p: jm.loss(p, _jbatch(batch),
                                               train=False))(jp)
        ref_params = jax.tree_util.tree_map(lambda p, g: np.asarray(p - lr * g),
                                            jp, ref_grads)
        n_micro = 2 if plan[1] > 1 else 1
        jtr = JShardedTrainer(JConfig(**cfg), JMeshPlan(*plan),
                              tx=optax.sgd(lr), n_micro=n_micro)
        jfresh = jm.init(jax.random.PRNGKey(0))  # the step donates
        jstate = _state(jtr, jtr.from_transformer_params(jfresh),
                        jnp.zeros((), jnp.int32))
        jstate, jloss = jtr.step(jstate, _jbatch(batch))
        jgot = jax.tree_util.tree_map(np.asarray,
                                      jax.device_get(jstate["params"]))

        trainer = ShardedTrainer(TransformerConfig(**cfg), MeshPlan(*plan),
                                 tx=sgd(lr), n_micro=n_micro, devices=CPU8)
        state = _state(trainer, trainer.from_transformer_params(tp))
        state, loss = trainer.step(state, _tbatch(batch))
        assert int(state["step"]) == 1
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
        got = interop.sharded_params_to_jax(state["params"], trainer)
        _assert_tree_close(got, jgot, STEP_TOL)
        for i in range(cfg["n_layers"]):
            for key in ("wq/w", "ffn_out/w", "ln1/scale"):
                a, b = key.split("/")
                np.testing.assert_allclose(
                    got["layers"][a][b][i],
                    ref_params[f"layer_{i}"][a][b], **STEP_TOL)
        np.testing.assert_allclose(got["embed"]["table"],
                                   ref_params["embed"]["table"], **STEP_TOL)
        np.testing.assert_allclose(got["head"]["w"], ref_params["head"]["w"],
                                   **STEP_TOL)

    @pytest.mark.parametrize("schedule", ["pallas_ring", "ring",
                                          "two_stage"])
    def test_schedules_match_psum(self, schedule):
        """sync_grads under a scheduled allreduce (pallas_ring: the ring
        kernels' plain versions here) gives the psum step's params."""
        cfg, _, _, tp = _models()
        batch = _batch()
        outs = {}
        for sched in ("psum", schedule):
            trainer = ShardedTrainer(
                TransformerConfig(**cfg), ParallelPlan(
                    dp=2, sp=2, tp=2, collective_schedule=sched),
                tx=sgd(0.05), devices=CPU8)
            state = _state(trainer, trainer.from_transformer_params(tp))
            state, loss = trainer.step(state, _tbatch(batch))
            assert np.isfinite(float(loss))
            outs[sched] = state["params"]
        for a, b in zip(tree_leaves(outs["psum"]), tree_leaves(outs[schedule])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)

    def test_fused_grad_sync_matches(self):
        """fuse_grads=True (one collective a sync kind) equals the
        per-leaf sync, and both the reference's fused step."""
        cfg, jm, _, tp = _models()
        batch = _batch()
        outs = {}
        for fused in (False, True):
            trainer = ShardedTrainer(TransformerConfig(**cfg),
                                     MeshPlan(dp=2, pp=1, sp=2, tp=2),
                                     tx=sgd(0.05), fuse_grads=fused,
                                     devices=CPU8)
            state = _state(trainer, trainer.from_transformer_params(tp))
            state, _ = trainer.step(state, _tbatch(batch))
            outs[fused] = state["params"]
        for a, b in zip(tree_leaves(outs[False]), tree_leaves(outs[True])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        jtr = JShardedTrainer(JConfig(**cfg), JMeshPlan(2, 1, 2, 2),
                              tx=optax.sgd(0.05), fuse_grads=True)
        jp = jm.init(jax.random.PRNGKey(0))
        jstate, _ = jtr.step(_state(jtr, jtr.from_transformer_params(jp)),
                             _jbatch(batch))
        _assert_tree_close(
            interop.sharded_params_to_jax(outs[True], trainer),
            jax.tree_util.tree_map(np.asarray,
                                   jax.device_get(jstate["params"])),
            STEP_TOL)

    def test_init_learned_positions_and_pulse(self, monkeypatch):
        monkeypatch.setenv("KF_PULSE_EVERY", "1")
        cfg = TransformerConfig(**{**CFG, "pos": "learned"})
        trainer = ShardedTrainer(cfg, MeshPlan(dp=2), devices=["cpu"] * 2)
        state = trainer.init(torch.Generator().manual_seed(1))
        pe = state["params"]["pos_embed"]["table"]
        assert pe.shape == (2, cfg.max_seq, cfg.d_model)
        assert torch.equal(pe[0], pe[1])
        assert trainer._pure_dp() and trainer.pulse is not None
        s, loss = trainer.step(state, _tbatch(_batch()))
        assert np.isfinite(float(loss)) and trainer.pulse.samples == 1
        sharded = ShardedTrainer(TransformerConfig(**CFG),
                                 MeshPlan(dp=2, tp=2), devices=["cpu"] * 4)
        s, loss = sharded.step(sharded.init(), _tbatch(_batch()))
        assert np.isfinite(float(loss)) and sharded.pulse.samples == 0

    def test_interop_roundtrip(self):
        trainer = ShardedTrainer(TransformerConfig(**CFG),
                                 MeshPlan(dp=2, pp=2, sp=1, tp=2),
                                 n_experts=4, devices=CPU8)
        state = trainer.init(torch.Generator().manual_seed(3))
        glob = interop.sharded_params_to_jax(state["params"], trainer)
        assert glob["layers"]["w_in"].shape == (2, 4, 64, 128)
        back = interop.sharded_params_from_jax(glob, trainer)
        for a, b in zip(tree_leaves(back), tree_leaves(state["params"])):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="trees differ"):
            interop.sharded_params_from_jax({"embed": {}}, trainer)


# -- MoE / expert parallelism --------------------------------------------------
class TestMoE:
    def test_ep_matches_local_and_reference(self):
        """Token outputs with experts sharded over ep=2 equal the local
        routing (capacity high enough that nothing drops), and both the
        reference's."""
        E, D, F, T = 4, 16, 32, 24
        jparams = jmoe.moe_init(jax.random.PRNGKey(0), E, D, F,
                                n_experts_global=E)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((T, D)).astype(np.float32)
        y_ref, aux_ref = jmoe.moe_apply(jparams, jnp.asarray(x), axis=None,
                                        n_experts_global=E,
                                        capacity_factor=float(E))
        params = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), jparams)
        y_loc, aux_loc = moe_apply(params, torch.from_numpy(x), None, E,
                                   capacity_factor=float(E))
        np.testing.assert_allclose(y_loc.numpy(), np.asarray(y_ref),
                                   **MOE_TOL)
        np.testing.assert_allclose(float(aux_loc), float(aux_ref), **MOE_TOL)

        ep = 2
        stacked = {"gate": {"w": params["gate"]["w"].expand(ep, D, E)},
                   "w_in": params["w_in"].reshape(ep, E // ep, D, F),
                   "w_out": params["w_out"].reshape(ep, E // ep, F, D)}
        with collective.rank_world([("ep", ep)]):
            y_ep, aux_ep = moe_apply(stacked, torch.from_numpy(x).reshape(
                ep, T // ep, D), "ep", E, capacity_factor=float(E))
        np.testing.assert_allclose(y_ep.reshape(T, D).numpy(),
                                   y_loc.numpy(), **MOE_TOL)
        assert np.isfinite(aux_ep.numpy()).all()

        mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
        spec = {"gate": {"w": JP(None, None)}, "w_in": JP("ep", None, None),
                "w_out": JP("ep", None, None)}
        g = shard_map(lambda lp, xl: jmoe.moe_apply(
            lp, xl, axis="ep", n_experts_global=E,
            capacity_factor=float(E))[0], mesh=mesh,
            in_specs=(spec, JP("ep", None)), out_specs=JP("ep", None),
            check_vma=False)
        np.testing.assert_allclose(y_ep.reshape(T, D).numpy(),
                                   np.asarray(jax.jit(g)(jparams,
                                                         jnp.asarray(x))),
                                   **MOE_TOL)

    def test_capacity_drops_as_the_reference(self):
        E, D, F, T = 4, 8, 16, 32
        jparams = jmoe.moe_init(jax.random.PRNGKey(1), E, D, F,
                                n_experts_global=E)
        x = np.random.default_rng(4).standard_normal((T, D)).astype(
            np.float32)
        y_ref, aux_ref = jmoe.moe_apply(jparams, jnp.asarray(x), None, E,
                                        capacity_factor=0.5)
        params = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), jparams)
        y, aux = moe_apply(params, torch.from_numpy(x), None, E,
                           capacity_factor=0.5)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **MOE_TOL)
        np.testing.assert_allclose(float(aux), float(aux_ref), **MOE_TOL)
        init = moe_init(torch.Generator().manual_seed(0), 2, D, F, E)
        assert init["w_in"].shape == (2, D, F) and init["gate"]["w"].shape \
            == (D, E)

    def test_moe_step_matches_reference(self):
        """The reference trainer's MoE params carried in by interop: the
        loss and one step's params agree (experts over dp, gate and
        layernorms dense, all-to-all over dp)."""
        batch = _batch()
        jtr = JShardedTrainer(JConfig(**CFG), JMeshPlan(2, 1, 2, 2),
                              n_experts=4, tx=optax.sgd(0.05),
                              capacity_factor=2.0)
        jstate = jtr.init(jax.random.PRNGKey(1))
        glob = jax.tree_util.tree_map(np.asarray,
                                      jax.device_get(jstate["params"]))
        trainer = ShardedTrainer(TransformerConfig(**CFG),
                                 MeshPlan(2, 1, 2, 2), n_experts=4,
                                 tx=sgd(0.05), capacity_factor=2.0,
                                 devices=CPU8)
        state = _state(trainer, interop.sharded_params_from_jax(glob,
                                                                trainer))
        np.testing.assert_allclose(
            float(trainer.loss(state, _tbatch(batch))),
            float(jtr.loss(jstate, _jbatch(batch))), rtol=LOSS_RTOL)
        jstate, jloss = jtr.step(jstate, _jbatch(batch))
        state, loss = trainer.step(state, _tbatch(batch))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        _assert_tree_close(
            interop.sharded_params_to_jax(state["params"], trainer),
            jax.tree_util.tree_map(np.asarray,
                                   jax.device_get(jstate["params"])),
            STEP_TOL)

    @pytest.mark.parametrize("fuse_grads", [False, True])
    def test_moe_trainer_trains(self, fuse_grads):
        trainer = ShardedTrainer(TransformerConfig(**CFG),
                                 MeshPlan(dp=2, pp=1, sp=2, tp=2),
                                 n_experts=4, tx=adam(1e-3),
                                 capacity_factor=4.0, fuse_grads=fuse_grads,
                                 devices=CPU8)
        state = trainer.init(torch.Generator().manual_seed(0))
        batch = _tbatch(_batch())
        losses = []
        for _ in range(4):
            state, loss = trainer.step(state, batch)
            losses.append(float(loss))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
