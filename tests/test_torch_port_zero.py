"""Port parity: data-parallel S-SGD and ZeRO-1/2/3 over four stacked
co-resident ranks, against the JAX reference on the conftest's virtual
CPU devices.

Both sides start from the same numpy params and batches:
``tests/test_zero.py``'s tanh MLP and a two-layer narrow ``Transformer``
(plain attention).  The port's ranks run one after another on the CPU,
its ring collectives take their plain versions.  Tolerances are the
reference's own (``tests/test_zero.py``): ``rtol 1e-5, atol 1e-6`` after
one step, ``1e-4 / 1e-5`` after three, since the two frameworks sum the
per-rank gradients in different orders and momentum carries the
difference.  Optimizer-state geometry and the stage-3 parameter carve
are held bitwise.  No process group is started.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.optimizers import synchronous_sgd as jsync
from kungfu_tpu.parallel import zero as jzero
from kungfu_tpu.parallel.train import ParallelPlan as JPlan
from kungfu_tpu.parallel.train import dp_train_step as jdp_train_step
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.ops import collective, collectives
from kungfu_tpu_torch.optimizers import (adam, adamw, apply_updates, sgd,
                                         synchronous_sgd)
from kungfu_tpu_torch.parallel import zero
from kungfu_tpu_torch.parallel.train import ParallelPlan, dp_train_step
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

N = 4
#: one step, and three steps (momentum and Adam's moments carry the
#: first step's reassociation differences): tests/test_zero.py:70-72,
#: :115-117
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
MULTI_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3

INNERS = {
    "momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                 lambda: sgd(0.05, momentum=0.9)),
    "adam": (lambda: optax.adam(1e-2), lambda: adam(1e-2)),
}
#: the two frameworks' transformer gradients differ by about 1e-7 (other
#: GEMM and softmax summation orders), and some gradients are that small
#: themselves: the key biases' is zero in exact arithmetic (softmax
#: ignores a per-row shift).  Adam divides by |g| + eps, so it maps a
#: gradient difference dg to lr * dg / eps, +-lr where |g| ~ dg.  An eps
#: of 1e-2 at lr 1e-2 keeps Adam's arithmetic and maps dg to dg.
TRANSFORMER_INNERS = dict(INNERS, adam=(lambda: optax.adam(1e-2, eps=1e-2),
                                        lambda: adam(1e-2, eps=1e-2)))

_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=16, causal=True, pos="rope", dtype="float32")


# -- the two problems --------------------------------------------------------

def _mlp():
    rng = np.random.RandomState(0)
    params = {f"w{i}": rng.randn(*s).astype(np.float32)
              for i, s in enumerate(((13, 7), (7,), (7, 5)))}
    rng = np.random.RandomState(1)
    batch = (rng.randn(16, 13).astype(np.float32),
             rng.randn(16, 5).astype(np.float32))

    def jloss(p, b):
        h = jnp.tanh(b[0] @ p["w0"] + p["w1"])
        return jnp.mean((h @ p["w2"] - b[1]) ** 2)

    def tloss(p, b):
        h = torch.tanh(b[0] @ p["w0"] + p["w1"])
        return ((h @ p["w2"] - b[1]) ** 2).mean()

    return (jax.tree_util.tree_map(jnp.asarray, params),
            tree_map(torch.from_numpy, params),
            tuple(map(jnp.asarray, batch)),
            tuple(map(torch.from_numpy, batch)), jloss, tloss)


def _transformer():
    jcfg, tcfg = jtr.TransformerConfig(**_KW), ttr.TransformerConfig(**_KW)
    jmodel, tmodel = jtr.Transformer(jcfg), ttr.Transformer(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    rng = np.random.default_rng(0)
    ids, tgt = (rng.integers(0, _KW["vocab_size"], size=(N, 16))
                for _ in range(2))

    def jloss(p, b):
        return jmodel.loss(p, b, attn_fn=jtr.default_attention)

    def tloss(p, b):
        return tmodel.loss(p, b, attn_fn=ttr.default_attention)

    return (jp, tp, (jnp.asarray(ids, jnp.int32), jnp.asarray(tgt, jnp.int32)),
            (torch.from_numpy(ids), torch.from_numpy(tgt)), jloss, tloss)


PROBLEMS = {"mlp": _mlp, "transformer": _transformer}


def _comms(local_size=N):
    return (JCommunicator(devices=jax.devices()[:N], local_size=local_size),
            Communicator(devices=["cpu"] * N, local_size=local_size))


def _assert_close(tparams, jparams, tol, what=""):
    tl = [t.detach().numpy() for t in tree_leaves(tparams)]
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jparams)]
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(t, j, err_msg=f"{what} leaf {i}", **tol)


# -- optimizers ---------------------------------------------------------------

class TestAdam:
    def _tree(self):
        rng = np.random.default_rng(3)
        return {"b": rng.normal(size=(3, 2)).astype(np.float32),
                "a": rng.normal(size=(5,)).astype(np.float32)}

    @pytest.mark.parametrize("name,jtx,ttx", [
        ("adam", optax.adam(1e-2), adam(1e-2)),
        ("adam_eps_root", optax.adam(1e-2, b1=0.8, eps_root=1e-6),
         adam(1e-2, b1=0.8, eps_root=1e-6)),
        ("adamw", optax.adamw(1e-2, weight_decay=0.01),
         adamw(1e-2, weight_decay=0.01)),
    ])
    def test_matches_optax(self, name, jtx, ttx):
        params = self._tree()
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        tp = tree_map(torch.from_numpy, params)
        js, ts = jtx.init(jp), ttx.init(tp)
        for i in range(4):
            g = {k: (v * 0.5 + 0.1 * i).astype(np.float32)
                 for k, v in params.items()}
            ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
            jp = optax.apply_updates(jp, ju)
            tu, ts = ttx.update(tree_map(torch.from_numpy, g), ts, tp)
            tp = apply_updates(tp, tu)
        _assert_close(tp, jp, dict(rtol=1e-6, atol=1e-7), name)
        # the state lays its leaves out as optax's: count, mu, nu
        jl = jax.tree_util.tree_leaves(js)
        tl = tree_leaves(ts)
        assert len(jl) == len(tl) == 5
        assert tl[0].dtype == torch.int32 and int(tl[0]) == int(jl[0]) == 4
        for t, j in zip(tl[1:], jl[1:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)

    def test_count_saturates(self):
        tx = adam(1e-2)
        p = {"w": torch.ones(2)}
        s = tx.init(p)
        top = torch.iinfo(torch.int32).max
        s = (s[0]._replace(count=torch.tensor(top, dtype=torch.int32)),) + \
            s[1:]
        _, s = tx.update({"w": torch.ones(2)}, s, p)
        assert int(s[0].count) == top


# -- S-SGD at n = 4 -------------------------------------------------------------

class TestSyncSGD:
    @pytest.mark.parametrize("schedule", ["psum", "two_stage", "ring",
                                          "pallas_ring"])
    @pytest.mark.parametrize("fuse_grads", [False, True])
    @pytest.mark.parametrize("problem", ["mlp", "transformer"])
    def test_dp_train_step_matches_reference(self, schedule, fuse_grads,
                                             problem):
        jp, tp, jb, tb, jloss, tloss = PROBLEMS[problem]()
        jcomm, tcomm = _comms()
        jtx = jsync(optax.sgd(0.05, momentum=0.9), jcomm.axis,
                    schedule=schedule, fuse_grads=fuse_grads)
        ttx = synchronous_sgd(sgd(0.05, momentum=0.9), tcomm.axis,
                              schedule=schedule, fuse_grads=fuse_grads)
        jstep = jdp_train_step(jloss, jtx, jcomm)
        tstep = dp_train_step(tloss, ttx, tcomm)
        js, ts = jtx.init(jp), ttx.init(tp)
        for i in range(STEPS):
            jp, js, jl = jstep(jp, js, jb)
            tp, ts, tl = tstep(tp, ts, tb)
            tol = STEP_TOL if i == 0 else MULTI_TOL
            np.testing.assert_allclose(float(tl), float(jl), **tol)
            _assert_close(tp, jp, tol, f"step {i}")
        assert all(t.dim() == j.ndim for t, j in zip(
            tree_leaves(tp), jax.tree_util.tree_leaves(jp)))

    def test_replicas_are_bitwise_equal(self, monkeypatch):
        """The reduced gradient every rank holds is the same bits, so the
        replicated params take one row of identical rows."""
        monkeypatch.setattr(collective, "CHECK_REPLICAS", True)
        _, tp, _, tb, _, tloss = _mlp()
        _, tcomm = _comms()
        for schedule in ("psum", "two_stage", "ring", "pallas_ring"):
            tx = synchronous_sgd(sgd(0.05), tcomm.axis, schedule=schedule,
                                 fuse_grads=True)
            dp_train_step(tloss, tx, tcomm)(tp, tx.init(tp), tb)
        rows = torch.ones(N, 3)
        rows[2, 1] = 2.0
        with collective.rank_world((("x", N),)):
            with pytest.raises(AssertionError, match="differs"):
                collective.replicated(rows)

    def test_hierarchical_mesh(self):
        """A 2x2 (kf_host, kf_local) mesh: the schedule runs on the host
        axis after a plain local reduction."""
        jp, tp, jb, tb, jloss, tloss = _mlp()
        jcomm, tcomm = _comms(local_size=2)
        jtx = jsync(optax.sgd(0.05), jcomm.axis, schedule="pallas_ring")
        ttx = synchronous_sgd(sgd(0.05), tcomm.axis, schedule="pallas_ring")
        jp, _, jl = jdp_train_step(jloss, jtx, jcomm)(jp, jtx.init(jp), jb)
        tp, _, tl = dp_train_step(tloss, ttx, tcomm)(tp, ttx.init(tp), tb)
        np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
        _assert_close(tp, jp, STEP_TOL)

    def test_has_aux_averages_aux(self):
        _, tcomm = _comms()
        tx = synchronous_sgd(sgd(0.1), tcomm.axis)

        def loss_fn(p, aux, b):
            return (p["w"] * b).sum(), {"m": b.mean().reshape(1)}

        step = dp_train_step(loss_fn, tx, tcomm, has_aux=True)
        p = {"w": torch.tensor([1.0])}
        b = torch.arange(4.0).reshape(4, 1)
        p2, aux, _, loss = step(p, {"m": torch.zeros(1)}, tx.init(p), b)
        assert float(loss) == 1.5 and float(aux["m"]) == 1.5
        assert float(p2["w"]) == pytest.approx(1.0 - 0.1 * 1.5)


# -- ZeRO ---------------------------------------------------------------------

def _zero_pair(problem, stage, inner, schedule, local_size=N, inners=None):
    jp, tp, jb, tb, jloss, tloss = PROBLEMS[problem]()
    jcomm, tcomm = _comms(local_size)
    make_j, make_t = (inners or INNERS)[inner]
    jz = jzero.zero_train_step(jloss, make_j(), jcomm, stage=stage,
                               schedule=schedule)
    tz = zero.zero_train_step(tloss, make_t(), tcomm, stage=stage,
                              schedule=schedule)
    return (jz, jp, jb), (tz, tp, tb)


class TestZeroSteps:
    @pytest.mark.parametrize("stage", [1, 2, 3])
    @pytest.mark.parametrize("inner", ["momentum", "adam"])
    @pytest.mark.parametrize("schedule", ["lax", "pallas_ring"])
    @pytest.mark.parametrize("problem", ["mlp", "transformer"])
    def test_matches_reference(self, stage, inner, schedule, problem):
        inners = TRANSFORMER_INNERS if problem == "transformer" else INNERS
        (jz, jp, jb), (tz, tp, tb) = _zero_pair(problem, stage, inner,
                                                schedule, inners=inners)
        jo, to = jz.init_opt(jp), tz.init_opt(tp)
        # optimizer-state geometry: vector leaves [n, chunk] stacked,
        # the reference's global [n*chunk] row for row; scalars shared
        jl, tl = jax.tree_util.tree_leaves(jo), tree_leaves(to)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            j = np.asarray(j)
            assert t.shape == ((N, j.size // N) if j.ndim else ())
            assert t.numpy().tobytes() == j.tobytes()
        jp, tp = jz.init_params(jp), tz.init_params(tp)
        if stage == 3:
            assert tp.numpy().tobytes() == np.asarray(jp).tobytes()
        for i in range(STEPS):
            jp, jo, jl = jz.step(jp, jo, jb)
            tp, to, tl = tz.step(tp, to, tb)
            tol = STEP_TOL if i == 0 else MULTI_TOL
            np.testing.assert_allclose(float(tl), float(jl), **tol)
            _assert_close(tz.gather_params(tp), jz.gather_params(jp), tol,
                          f"step {i}")
        for j, t in zip(jax.tree_util.tree_leaves(jo), tree_leaves(to)):
            np.testing.assert_allclose(t.numpy().reshape(-1),
                                       np.asarray(j).reshape(-1), **MULTI_TOL)

    @pytest.mark.parametrize("stage", [1, 2, 3])
    def test_state_carried_from_reference(self, stage):
        """interop.tree_from_jax carries the reference's opt_shard
        (and stage 3's parameter shard) across: one more step from it
        matches the reference's next step."""
        (jz, jp, jb), (tz, tp, tb) = _zero_pair("mlp", stage, "adam",
                                                "pallas_ring")
        jo = jz.init_opt(jp)
        to = tz.init_opt(tp)
        jp = jz.init_params(jp)
        tp = tz.init_params(tp)
        jp, jo, _ = jz.step(jp, jo, jb)
        to = interop.tree_from_jax(
            [np.asarray(a) for a in jax.tree_util.tree_leaves(jo)], to)
        if stage == 3:
            tp = interop.tree_from_jax([np.asarray(jp)], tp)
        else:
            tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
        assert int(tree_leaves(to)[0]) == 1
        jp, jo, jl = jz.step(jp, jo, jb)
        tp, to, tl = tz.step(tp, to, tb)
        np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
        _assert_close(tz.gather_params(tp), jz.gather_params(jp), STEP_TOL)
        with pytest.raises(ValueError, match="reference leaves"):
            interop.tree_from_jax([np.zeros(3)], to)
        with pytest.raises(ValueError, match="does not fill"):
            interop.tree_from_jax(
                [np.zeros(7) for _ in tree_leaves(to)], to)

    def test_hierarchical_mesh(self):
        (jz, jp, jb), (tz, tp, tb) = _zero_pair("mlp", 2, "momentum",
                                                "pallas_ring", local_size=2)
        jp, _, jl = jz.step(jp, jz.init_opt(jp), jb)
        tp, _, tl = tz.step(tp, tz.init_opt(tp), tb)
        np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
        _assert_close(tp, jp, STEP_TOL)

    def test_stage2_lax_bitwise_vs_replicated_sgd(self):
        """Stateless SGD: the reduce-scatter path is bitwise the
        replicated all-reduce step (the same addends in the same order),
        as tests/test_zero.py:325 pins for the reference."""
        _, tp, _, tb, _, tloss = _mlp()
        _, tcomm = _comms()
        tx = synchronous_sgd(sgd(0.1), tcomm.axis)
        ref, _, _ = dp_train_step(tloss, tx, tcomm)(tp, tx.init(tp), tb)
        step, init_opt = zero.zero_train_step(tloss, sgd(0.1), tcomm,
                                              stage=2)
        got, _, _ = step(tp, init_opt(tp), tb)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k

    @pytest.mark.parametrize("stage", [1, 2, 3])
    def test_pallas_ring_bitwise_vs_ring_sync_sgd(self, stage):
        """Each element's gradient is folded in the same ring order by
        S-SGD's pallas_ring all-reduce and by ZeRO's bucketed ring
        reduce-scatter, divided by the same n and updated by the same
        elementwise SGD: the params after one step are the same bits.
        Stage 1 all-reduces with a plain sum and is held to STEP_TOL."""
        _, tp, _, tb, _, tloss = _transformer()
        _, tcomm = _comms()
        tx = synchronous_sgd(sgd(0.05, momentum=0.9), tcomm.axis,
                             schedule="pallas_ring", fuse_grads=True)
        ref, _, ref_loss = dp_train_step(tloss, tx, tcomm)(tp, tx.init(tp),
                                                           tb)
        z = zero.zero_train_step(tloss, sgd(0.05, momentum=0.9), tcomm,
                                 stage=stage, schedule="pallas_ring",
                                 bucket_bytes=4096)
        p, _, loss = z.step(z.init_params(tp), z.init_opt(tp), tb)
        got = z.gather_params(p)
        assert float(loss) == float(ref_loss)
        for (k, a), b in zip(ttr.flatten(got).items(),
                             ttr.flatten(ref).values()):
            if stage == 1:
                np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)
            else:
                assert torch.equal(a, b), k

    @pytest.mark.parametrize("stage", [2, 3])
    def test_bucketed_matches_unbucketed_bitwise(self, stage):
        _, tp, _, tb, _, tloss = _mlp()
        _, tcomm = _comms()
        runs = []
        for bb in (4 << 20, 16):
            z = zero.zero_train_step(tloss, adam(1e-2), tcomm, stage=stage,
                                     bucket_bytes=bb, schedule="pallas_ring")
            assert len(z._get(tp).widths) == (1 if bb > 16 else 34)
            o = z.init_opt(tp)
            p, o, _ = z.step(z.init_params(tp), o, tb)
            runs.append(z.gather_params(p))
        for k in runs[0]:
            assert torch.equal(runs[0][k], runs[1][k]), k

    def test_stage3_params_sharded_between_steps(self):
        _, tp, _, tb, _, tloss = _mlp()
        _, tcomm = _comms()
        z = zero.zero_train_step(tloss, adam(1e-2), tcomm, stage=3)
        o = z.init_opt(tp)
        shard = z.init_params(tp)
        total = sum(t.numel() for t in tree_leaves(tp))
        chunk = -(-total // N)
        assert shard.shape == (N, chunk)
        back = z.gather_params(shard)
        for k in tp:
            assert torch.equal(back[k], tp[k]), k
        p, o, _ = z.step(shard, o, tb)
        assert p.shape == (N, chunk) and not p.requires_grad
        # the padding past the params stays zero
        assert torch.equal(p.reshape(-1)[total:], torch.zeros(N * chunk - total))

    def test_unpacks_and_rejects(self):
        _, tp, _, tb, _, tloss = _mlp()
        _, tcomm = _comms()
        out = zero.zero_train_step(tloss, sgd(0.1), tcomm, stage=2)
        assert isinstance(out, zero.ZeroStep)
        step, init_opt = out
        assert np.isfinite(float(step(tp, init_opt(tp), tb)[2]))
        step1, init1 = zero.zero1_train_step(tloss, sgd(0.1), tcomm)
        assert np.isfinite(float(step1(tp, init1(tp), tb)[2]))
        with pytest.raises(ValueError, match="stage"):
            zero.zero_train_step(tloss, sgd(0.1), tcomm, stage=4)
        with pytest.raises(ValueError, match="schedule"):
            zero.zero_train_step(tloss, sgd(0.1), tcomm, schedule="ring")
        z3 = zero.zero_train_step(tloss, sgd(0.1), tcomm, stage=3)
        with pytest.raises(RuntimeError, match="init_params"):
            z3.step(tp, z3.init_opt(tp), tb)

    def test_one_rank_world(self):
        _, tp, _, tb, _, tloss = _mlp()
        c1 = Communicator(devices=["cpu"], local_size=1)
        want = None
        for stage in (1, 2, 3):
            z = zero.zero_train_step(tloss, sgd(0.1), c1, stage=stage)
            o = z.init_opt(tp)
            p, o, _ = z.step(z.init_params(tp), o, tb)
            full = z.gather_params(p)
            if want is None:
                want = full
            for k in tp:
                assert torch.equal(full[k], want[k]), (stage, k)


class TestPlanRouting:
    def test_dp_train_step_routes_zero_stage(self):
        jp, tp, jb, tb, jloss, tloss = _mlp()
        jcomm, tcomm = _comms()
        jz = jdp_train_step(jloss, optax.sgd(0.1), jcomm,
                            plan=JPlan(dp=N, zero_stage=2,
                                       collective_schedule="pallas_ring"))
        tz = dp_train_step(tloss, sgd(0.1), tcomm,
                           plan=ParallelPlan(dp=N, zero_stage=2,
                                             collective_schedule="pallas_ring"))
        assert isinstance(tz, zero.ZeroStep) and tz._schedule == "pallas_ring"
        jp, _, jl = jz(jp, jz.init_opt(jp), jb)
        tp, _, tl = tz(tp, tz.init_opt(tp), tb)
        np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
        _assert_close(tp, jp, STEP_TOL)
        assert isinstance(dp_train_step(tloss, sgd(0.1), tcomm, zero_stage=3),
                          zero.ZeroStep)

    @pytest.mark.parametrize("kwargs,match", [
        (dict(zero_stage=2, has_aux=True), "ZeRO"),
        (dict(zero_stage=1, plan=ParallelPlan(zero_stage=2)), "disagrees"),
        (dict(plan=ParallelPlan(tp=2)), "tp=2"),
        (dict(plan=ParallelPlan(collective_schedule="ring")), "arm"),
    ])
    def test_dp_train_step_rejects(self, kwargs, match):
        _, tcomm = _comms()
        with pytest.raises((ValueError, NotImplementedError), match=match):
            dp_train_step(lambda p, b: 0.0, sgd(0.1), tcomm, **kwargs)

    @pytest.mark.parametrize("kwargs,match", [
        (dict(plan=ParallelPlan(tp=2, zero_stage=2)), "ONE dp axis"),
        (dict(plan=ParallelPlan()), "zero_stage is 0"),
        (dict(stage=1, plan=ParallelPlan(zero_stage=2)), "disagrees"),
        (dict(schedule="lax",
              plan=ParallelPlan(zero_stage=2,
                                collective_schedule="pallas_ring")),
         "disagrees"),
    ])
    def test_zero_train_step_plan_checks(self, kwargs, match):
        _, tcomm = _comms()
        with pytest.raises(ValueError, match=match):
            zero.zero_train_step(lambda p, b: 0.0, sgd(0.1), tcomm, **kwargs)

    def test_plan_validation(self):
        for bad in (dict(dp=0), dict(zero_stage=4)):
            with pytest.raises(ValueError):
                ParallelPlan(**bad)
        # the arm is checked by the consumers, as in the reference
        ParallelPlan(collective_schedule="bogus")
        JPlan(collective_schedule="bogus")
        with pytest.raises(ValueError, match="arm"):
            dp_train_step(lambda p, b: 0.0, sgd(0.1), _comms()[1],
                          plan=ParallelPlan(collective_schedule="bogus"))
        assert ParallelPlan(dp=2, tp=2).size == 4


class TestCommBytes:
    @pytest.mark.parametrize("stage", [1, 2, 3])
    def test_measured_ring_bytes_match_analytic(self, stage):
        """Per-rank ring bytes counted by the ring collectives in one
        pallas_ring step: stage 1 moves none (a plain all-reduce),
        stage 2 the gradient reduce-scatter, stage 3 the in-step gather
        and its reduce-scatter backward.  Stages 1/2 regather with a
        plain copy, the reference's partitioner all-gather."""
        _, tp, _, tb, _, tloss = _mlp()
        _, tcomm = _comms()
        z = zero.zero_train_step(tloss, sgd(0.1), tcomm, stage=stage,
                                 schedule="pallas_ring", bucket_bytes=64)
        o = z.init_opt(tp)
        p = z.init_params(tp)
        collectives.reset_ring_bytes()
        z.step(p, o, tb)
        want = z.comm_bytes(tp)
        assert want == jzero.zero_comm_bytes(133, N, stage)
        got = dict(collectives.ring_bytes)
        assert got["reduce_scatter"] == (0.0 if stage == 1
                                         else pytest.approx(want["grad_bytes"]))
        assert got["all_gather"] == (pytest.approx(want["param_bytes"])
                                     if stage == 3 else 0.0)

    def test_analytic_table_matches_reference(self):
        for args in ((1000, 8, 1), (1000, 8, 2), (133, 4, 3), (7, 1, 2),
                     (10, 3, 2, 2)):
            assert zero.zero_comm_bytes(*args) == jzero.zero_comm_bytes(*args)
        with pytest.raises(ValueError):
            zero.zero_comm_bytes(1000, 0, 2)

    def test_opt_state_bytes(self):
        _, tp, _, _, _, tloss = _mlp()
        _, tcomm = _comms()
        z = zero.zero_train_step(tloss, adam(1e-2), tcomm, stage=2)
        REGISTRY.reset()
        o = z.init_opt(tp)
        chunk = 34  # ceil(133 / 4)
        per = zero.opt_state_bytes_per_device(o, N)
        assert per == 2 * chunk * 4 + 4  # mu, nu shards and the count
        assert zero.opt_state_bytes(o) == 2 * N * chunk * 4 + 4
        assert REGISTRY.snapshot()["kf_opt_state_bytes"] == per
        assert zero.record_opt_state_gauge(sgd(0.1, 0.9).init(tp)) == 133 * 4


class TestPulse:
    @pytest.mark.parametrize("kind", ["dp", "zero1", "zero2"])
    def test_gns_matches_reference(self, monkeypatch, kind):
        """``KF_PULSE_EVERY=1``: the first step publishes kf_gns at
        n = 4.  Every kind estimates the same (mean per-rank |g|^2,
        |mean g|^2) pair, and is held against the reference's
        dp_train_step pulse: the reference's ZeRO pulse program does not
        trace on this jax (ROADMAP C0)."""
        monkeypatch.setenv("KF_PULSE_EVERY", "1")
        jp, tp, jb, tb, jloss, tloss = _mlp()
        jcomm, tcomm = _comms()
        jtx = jsync(optax.sgd(0.05), jcomm.axis)
        jstep = jdp_train_step(jloss, jtx, jcomm)
        jstep(jp, jtx.init(jp), jb)
        jmon = jstep.pulse
        if kind == "dp":
            ttx = synchronous_sgd(sgd(0.05), tcomm.axis)
            tstep = dp_train_step(tloss, ttx, tcomm)
            tstep(tp, ttx.init(tp), tb)
            tmon = tstep.pulse
        else:
            tz = zero.zero_train_step(tloss, sgd(0.05), tcomm,
                                      stage=int(kind[-1]),
                                      schedule="pallas_ring")
            tz.step(tp, tz.init_opt(tp), tb)
            tmon = tz.pulse
        assert tmon.samples == jmon.samples == 1
        assert tmon.gns is not None
        np.testing.assert_allclose(tmon.gns, jmon.gns, rtol=1e-4)
        np.testing.assert_allclose(tmon.variance, jmon.variance, rtol=1e-4)
