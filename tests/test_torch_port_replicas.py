"""Port parity: per-replica optimizers (SMA, AdaptiveSGD), the gradient
noise scale and variance monitors, the functional counter and EMA, and
device-plane strategy autotuning, against the JAX reference.

The model is ``benchmarks/system.py``'s quick BERT (vocab 1000, d_model
128, two layers, four heads, d_ff 256, max_seq 128, bidirectional,
learned positions) in f32 with plain attention on both sides.  The
reference runs over four of the conftest's virtual CPU devices; the
port's four co-resident ranks are stacked on the host.  Both sides start
from the same numpy params and batches; tolerances are
``test_torch_port_train.py``'s five-step ``TRAIN_ATOL`` and the
collectives' ``1e-6`` relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.monitor import DeviceStrategyDriver as JDriver
from kungfu_tpu.ops import monitor as jmonitor
from kungfu_tpu.ops import state as jstate
from kungfu_tpu.optimizers import adaptive_sgd as jada
from kungfu_tpu.optimizers import monitor_gradient_noise_scale as jgns
from kungfu_tpu.optimizers import monitor_gradient_variance as jvar
from kungfu_tpu.optimizers import synchronous_averaging as jsma
from kungfu_tpu.optimizers import synchronous_sgd as jsync
from kungfu_tpu.parallel.train import dp_train_step as jdp_train_step
from kungfu_tpu.parallel.train import stack_for_replicas as jstack
from kungfu_tpu.utils.jaxcompat import shard_map
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.monitor import DeviceStrategyDriver
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.ops import monitor as tmonitor
from kungfu_tpu_torch.ops import state as tstate
from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES
from kungfu_tpu_torch.optimizers import (AdaptiveSGDState, GNSState,
                                         GradVarianceState, adam,
                                         adaptive_sgd,
                                         monitor_gradient_noise_scale,
                                         monitor_gradient_variance, sgd,
                                         synchronous_averaging,
                                         synchronous_sgd)
from kungfu_tpu_torch.parallel.train import dp_train_step, stack_for_replicas
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

N = 4
#: five steps of a transformer from identical params, f32: the
#: per-step differences of the two frameworks' summation orders
#: compound through momentum (test_torch_port_train.py:56)
TRAIN_ATOL = 1e-4
#: one collective of f32 values in another summation order
RTOL = 1e-6
#: per-rank batch rows and sequence length of the parity steps
ROWS, SEQ = 2, 32
STEPS = 5

#: benchmarks/system.py:71-74, in f32 for parity
_BERT = dict(vocab_size=1000, d_model=128, n_layers=2, n_heads=4, d_ff=256,
             max_seq=128, causal=False, pos="learned", dtype="float32")

#: the inner optimizers; Adam's eps as in test_torch_port_zero.py (the
#: key biases' gradient is rounding noise, which eps 1e-8 would map to
#: +-lr)
INNERS = {
    "momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                 lambda: sgd(0.05, momentum=0.9)),
    "adam": (lambda: optax.adam(1e-2, eps=1e-2),
             lambda: adam(1e-2, eps=1e-2)),
}


def _bert(seed=0):
    jcfg, tcfg = jtr.TransformerConfig(**_BERT), ttr.TransformerConfig(**_BERT)
    jmodel, tmodel = jtr.Transformer(jcfg), ttr.Transformer(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    ids, tgt = (rng.integers(0, _BERT["vocab_size"], size=(N * ROWS, SEQ))
                for _ in range(2))

    def jloss(p, b):
        return jmodel.loss(p, b, attn_fn=jtr.default_attention)

    def tloss(p, b):
        return tmodel.loss(p, b, attn_fn=ttr.default_attention)

    return (jp, tp, (jnp.asarray(ids, jnp.int32), jnp.asarray(tgt, jnp.int32)),
            (torch.from_numpy(ids), torch.from_numpy(tgt)), jloss, tloss)


def _comms():
    return (JCommunicator(devices=jax.devices()[:N], local_size=N),
            Communicator(devices=["cpu"] * N, local_size=N))


def _assert_close(tree, jtree, atol, what=""):
    tl = [t.detach().numpy() for t in tree_leaves(tree)]
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtree)]
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert t.shape == j.shape, (what, i, t.shape, j.shape)
        np.testing.assert_allclose(t, j, atol=atol, err_msg=f"{what} leaf {i}")


def _per_device(fn, *xs):
    """``fn`` per device under shard_map over N devices, each stacked
    input split on its leading axis; the stacked result as numpy."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("x",))
    f = shard_map(fn, mesh=mesh, in_specs=tuple(P("x") for _ in xs),
                  out_specs=P("x"), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(*xs))


def _stacked_tree(seed, shapes=((3, 5), (7,), ())):
    rng = np.random.default_rng(seed)
    return {f"g{i}": rng.standard_normal((N,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _in_world(fn, *trees):
    with collective.rank_world([("x", N)]):
        return fn(*(tree_map(torch.from_numpy, t) for t in trees))


# -- ops/state.py -------------------------------------------------------------

class TestState:
    def test_counter(self):
        js, jv = jstate.counter()
        ts, tv = tstate.counter(device="cpu")
        for incr in (1, 1, 3, 2):
            assert int(tv) == int(jv) and int(ts.step) == int(js.step)
            assert ts.step.dtype == torch.int32
            js, jv = jstate.counter(js, incr)
            ts, tv = tstate.counter(ts, incr)
        assert int(tv) == int(jv) == 6 and int(ts.step) == int(js.step) == 8

    @pytest.mark.parametrize("alpha", [0.01, 0.5])
    def test_ema_first_sample_sets_value(self, alpha):
        xs = np.random.default_rng(0).standard_normal(6).astype(np.float32)
        js, ts = jstate.ema_init(), tstate.ema_init(device="cpu")
        assert not bool(ts.initialized) and float(ts.value) == 0.0
        for i, x in enumerate(xs):
            js, jv = jstate.exponential_moving_average(js, x, alpha)
            ts, tv = tstate.exponential_moving_average(ts, float(x), alpha)
            if i == 0:
                assert float(tv) == float(x)
            assert bool(ts.initialized)
            np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
            np.testing.assert_allclose(float(ts.value), float(js.value),
                                       rtol=RTOL)

    def test_ema_keeps_shape_and_dtype(self):
        ts = tstate.ema_init((3,), torch.float64, device="cpu")
        ts, v = tstate.exponential_moving_average(ts, torch.ones(3), 0.1)
        assert v.dtype == torch.float64 and tuple(v.shape) == (3,)


# -- ops/monitor.py -----------------------------------------------------------

class TestMonitorOps:
    @pytest.mark.parametrize("batch", [1, 8, 32])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_global_noise_scale(self, batch, seed):
        g = _stacked_tree(seed)

        def jfn(g):
            avg = jax.lax.pmean(g, "x")
            return jmonitor.global_noise_scale(g, avg, batch, "x")[None]

        def tfn(g):
            avg = collective.all_reduce(g, "x", op="mean")
            return tmonitor.global_noise_scale(g, avg, batch, "x")

        ref = _per_device(jfn, g)
        got = _in_world(tfn, g)
        assert tuple(got.shape) == (N,)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)

    def test_noise_scale_zero_for_identical_grads(self):
        """tests/test_optimizers.py:205-208: no noise, a GNS near 0."""
        g = _stacked_tree(2)
        same = {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in g.items()}

        def tfn(g):
            avg = collective.all_reduce(g, "x", op="mean")
            return tmonitor.global_noise_scale(g, avg, 32, "x")

        assert float(_in_world(tfn, same).abs().max()) < 1e-3

    def test_noise_scale_none_at_one_rank(self):
        g = tree_map(torch.from_numpy, _stacked_tree(0))
        assert tmonitor.global_noise_scale(g, g, 8, "x") is None
        with collective.rank_world([("x", 1)]):
            one = tree_map(lambda a: a[:1], g)
            assert tmonitor.global_noise_scale(one, one, 8, "x") is None

    @pytest.mark.parametrize("seed", [0, 3])
    def test_all_reduce_with_variance(self, seed):
        g = _stacked_tree(seed)

        def jfn(g):
            avg, var = jmonitor.group_all_reduce_with_variance(g, "x")
            return avg, var[None]

        ref_avg, ref_var = _per_device(jfn, g)
        avg, var = _in_world(
            lambda g: tmonitor.group_all_reduce_with_variance(g, "x"), g)
        _assert_close(avg, ref_avg, 0.0 + 1e-7)
        np.testing.assert_allclose(var.numpy(), ref_var, rtol=RTOL)
        # the definition E_i |g_i - g_avg|^2, in f64
        flat = np.concatenate([v.reshape(N, -1) for _, v in sorted(g.items())],
                              1).astype(np.float64)
        want = ((flat - flat.mean(0)) ** 2).sum(1).mean()
        np.testing.assert_allclose(var.numpy(), want, rtol=1e-5)

    def test_variance_zero_for_identical_grads(self):
        g = _stacked_tree(4)
        same = {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in g.items()}
        _, var = _in_world(
            lambda g: tmonitor.group_all_reduce_with_variance(g, "x"), same)
        assert float(var.max()) < 1e-6 and float(var.min()) >= 0.0

    def test_rank_sq_norms_are_per_rank(self):
        g = _stacked_tree(5)
        got = _in_world(tmonitor.rank_sq_norms, g)
        want = sum((v.astype(np.float64) ** 2).reshape(N, -1).sum(1)
                   for v in g.values())
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
        flat = tree_map(torch.as_tensor, {k: v[0] for k, v in g.items()})
        np.testing.assert_allclose(float(tmonitor.rank_sq_norms(flat)),
                                   want[0], rtol=RTOL)


# -- per-replica optimizers through dp_train_step -----------------------------

def _run_stacked(jtx, ttx, seed=0, steps=STEPS):
    """``steps`` steps of each package's dp_train_step with stacked
    params; returns both packages' params, states and losses."""
    jp, tp, jb, tb, jloss, tloss = _bert(seed)
    jcomm, tcomm = _comms()
    jstep = jdp_train_step(jloss, jtx, jcomm, replicated_params=False)
    tstep = dp_train_step(tloss, ttx, tcomm, replicated_params=False)
    jp, js = jstack(jp, N), jstack(jtx.init(jp), N)
    tp, ts = stack_for_replicas(tp, N), stack_for_replicas(ttx.init(tp), N)
    jlosses, tlosses = [], []
    for _ in range(steps):
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    return (jp, js, jlosses), (tp, ts, tlosses)


def _spread(tree) -> float:
    """Largest std over the ranks of any element of a stacked tree."""
    return max(float(t.std(0).max()) for t in tree_leaves(tree))


class TestPerReplicaOptimizers:
    @pytest.mark.parametrize("inner", ["momentum", "adam"])
    @pytest.mark.parametrize("alpha", [0.1, 0.2])
    def test_sma_five_steps(self, inner, alpha):
        make_j, make_t = INNERS[inner]
        jcomm, tcomm = _comms()
        (jp, js, jl), (tp, ts, tl) = _run_stacked(
            jsma(make_j(), jcomm.axis, alpha=alpha),
            synchronous_averaging(make_t(), tcomm.axis, alpha=alpha))
        np.testing.assert_allclose(tl, jl, atol=TRAIN_ATOL)
        assert tl[-1] < tl[0]
        _assert_close(tp, jp, TRAIN_ATOL, "params")
        _assert_close(ts, js, TRAIN_ATOL, "state")
        # the replicas stay diverged (each trained its own row)
        assert _spread(tp) > 1e-4

    @pytest.mark.parametrize("inner", ["momentum", "adam"])
    def test_adaptive_sgd_five_steps(self, inner):
        make_j, make_t = INNERS[inner]
        jcomm, tcomm = _comms()
        (jp, js, jl), (tp, ts, tl) = _run_stacked(
            jada(make_j(), jcomm.axis, change_step=2),
            adaptive_sgd(make_t(), tcomm.axis, change_step=2))
        assert isinstance(ts, AdaptiveSGDState)
        assert ts.step.tolist() == [STEPS] * N
        np.testing.assert_allclose(tl, jl, atol=TRAIN_ATOL)
        _assert_close(tp, jp, TRAIN_ATOL, "params")
        _assert_close(ts, js, TRAIN_ATOL, "state")

    @pytest.mark.parametrize("momentum", [None, 0.9])
    def test_adaptive_sgd_switch_resyncs(self, momentum):
        """The spread over the ranks grows while SMA runs and falls at the
        switch: to rounding with plain SGD, and to one step of the
        ranks' differing momentum traces with momentum."""
        _, tp, _, tb, _, tloss = _bert(1)
        tcomm = Communicator(devices=["cpu"] * N)
        tx = adaptive_sgd(sgd(0.05, momentum=momentum), tcomm.axis,
                          change_step=3)
        step = dp_train_step(tloss, tx, tcomm, replicated_params=False)
        p, s = stack_for_replicas(tp, N), stack_for_replicas(tx.init(tp), N)
        spreads = []
        for _ in range(5):
            p, s, _ = step(p, s, tb)
            spreads.append(_spread(p))
        assert spreads[0] > 1e-4 and spreads[2] > spreads[0]
        if momentum is None:
            assert max(spreads[3:]) < 1e-6
        else:
            assert spreads[3] < spreads[2]

    def test_sma_without_pull_keeps_replicas_apart(self):
        """alpha = 0 is local SGD: more spread than alpha = 0.1."""
        def spread(alpha):
            _, tp, _, tb, _, tloss = _bert(2)
            tcomm = Communicator(devices=["cpu"] * N)
            tx = synchronous_averaging(sgd(0.05, momentum=0.9), tcomm.axis,
                                       alpha=alpha)
            step = dp_train_step(tloss, tx, tcomm, replicated_params=False)
            p, s = stack_for_replicas(tp, N), stack_for_replicas(tx.init(tp),
                                                                 N)
            for _ in range(4):
                p, s, _ = step(p, s, tb)
            return _spread(p)

        assert spread(0.1) < spread(0.0)

    def test_requires_params(self):
        tx = synchronous_averaging(sgd(0.1), "x")
        with pytest.raises(ValueError, match="requires params"):
            tx.update({"w": torch.zeros(2)}, tx.init({"w": torch.zeros(2)}),
                      None)
        tx = adaptive_sgd(sgd(0.1), "x", change_step=1)
        with pytest.raises(ValueError, match="requires params"):
            tx.update({"w": torch.zeros(2)}, tx.init({"w": torch.zeros(2)}),
                      None)


class TestStackedStep:
    def test_stack_for_replicas_matches_reference(self):
        jp, tp, *_ = _bert()
        tx, jtx = adam(1e-2), optax.adam(1e-2)
        tstack = stack_for_replicas(tx.init(tp), N)
        jstack_ = jstack(jtx.init(jp), N)
        _assert_close(tstack, jstack_, 0.0, "adam state")
        assert tstack[0].count.shape == (N,)
        sp = stack_for_replicas(tp, N)
        _assert_close(sp, jstack(jp, N), 0.0, "params")
        # copies, not views of the one tree
        leaf = tree_leaves(sp)[0]
        leaf[0].add_(1.0)
        assert not torch.equal(leaf[0], leaf[1])
        assert not torch.equal(leaf[1], tree_leaves(tp)[0] + 1.0)

    def test_per_rank_rows_are_differentiated(self):
        """Rank r's gradient is its own row's: with ranks given distinct
        params, the plain local step moves each row by its own
        gradient."""
        tcomm = Communicator(devices=["cpu"] * N)

        def loss_fn(p, b):
            return ((p["w"] * b) ** 2).sum()

        tx = synchronous_averaging(sgd(0.1), tcomm.axis, alpha=0.0)
        step = dp_train_step(loss_fn, tx, tcomm, replicated_params=False)
        w = torch.arange(1.0, N + 1).reshape(N, 1) * torch.ones(N, 2)
        b = torch.ones(N, 2)
        p, _, loss = step({"w": w}, tx.init({"w": w}), b)
        # d/dw (w b)^2 = 2 w b^2 = 2 w
        np.testing.assert_allclose(p["w"].numpy(), (w - 0.2 * w).numpy())
        assert float(loss) == pytest.approx(float((w ** 2).sum(1).mean()))

    def test_has_aux_with_stacked_params(self):
        """has_aux over stacked params, against the reference: each rank
        reads its own aux row, the floating aux is averaged and returned
        stacked, the integer aux keeps each rank's."""
        jcomm, tcomm = _comms()
        rng = np.random.default_rng(7)
        w = rng.standard_normal((N, 3)).astype(np.float32)
        m = rng.standard_normal((N, 1)).astype(np.float32)
        c = np.arange(N, dtype=np.int32).reshape(N, 1)
        x = rng.standard_normal((N * 2, 3)).astype(np.float32)

        def jloss(p, aux, b):
            y = b @ p["w"] + aux["m"][0]
            return jnp.mean(y ** 2), {"m": jnp.mean(y).reshape(1),
                                      "c": aux["c"] + 1}

        def tloss(p, aux, b):
            y = b @ p["w"] + aux["m"][0]
            return (y ** 2).mean(), {"m": y.mean().reshape(1),
                                     "c": aux["c"] + 1}

        jtx = jsma(optax.sgd(0.1), jcomm.axis)
        ttx = synchronous_averaging(sgd(0.1), tcomm.axis)
        jstep = jdp_train_step(jloss, jtx, jcomm, replicated_params=False,
                               has_aux=True)
        tstep = dp_train_step(tloss, ttx, tcomm, replicated_params=False,
                              has_aux=True)
        jout = jstep({"w": jnp.asarray(w)},
                     {"m": jnp.asarray(m), "c": jnp.asarray(c)},
                     jstack(jtx.init({"w": jnp.zeros(3)}), N), jnp.asarray(x))
        tout = tstep({"w": torch.from_numpy(w)},
                     {"m": torch.from_numpy(m), "c": torch.from_numpy(c)},
                     stack_for_replicas(ttx.init({"w": torch.zeros(3)}), N),
                     torch.from_numpy(x))
        for i, (t, j) in enumerate(zip(tout, jout)):
            _assert_close(t, j, 1e-6, f"output {i}")
        assert tout[1]["c"].tolist() == [[1], [2], [3], [4]]

    def test_sync_sgd_with_stacked_params_stays_replicated(self):
        """S-SGD over stacked params keeps identical rows identical, as the
        reference's does."""
        jcomm, tcomm = _comms()
        (jp, js, jl), (tp, ts, tl) = _run_stacked(
            jsync(optax.sgd(0.05, momentum=0.9), jcomm.axis),
            synchronous_sgd(sgd(0.05, momentum=0.9), tcomm.axis), seed=3,
            steps=2)
        np.testing.assert_allclose(tl, jl, atol=TRAIN_ATOL)
        _assert_close(tp, jp, TRAIN_ATOL, "params")
        assert _spread(tp) == 0.0

    def test_pulse_off_for_stacked_params(self, monkeypatch):
        monkeypatch.setenv("KF_PULSE_EVERY", "1")
        tcomm = Communicator(devices=["cpu"] * N)
        tx = synchronous_averaging(sgd(0.1), tcomm.axis)
        step = dp_train_step(lambda p, b: (p["w"] * b).sum(), tx, tcomm,
                             replicated_params=False)
        assert step.pulse is None
        assert dp_train_step(lambda p, b: (p["w"] * b).sum(), tx,
                             tcomm).pulse is not None


# -- the monitors on the replicated step --------------------------------------

class TestMonitors:
    @pytest.mark.parametrize("inner", ["momentum", "adam"])
    def test_gns_five_steps(self, inner):
        make_j, make_t = INNERS[inner]
        jp, tp, jb, tb, jloss, tloss = _bert(4)
        jcomm, tcomm = _comms()
        jtx = jgns(make_j(), jcomm.axis, local_batch_size=ROWS)
        ttx = monitor_gradient_noise_scale(make_t(), tcomm.axis,
                                           local_batch_size=ROWS)
        jstep, tstep = (jdp_train_step(jloss, jtx, jcomm),
                        dp_train_step(tloss, ttx, tcomm))
        js, ts = jtx.init(jp), ttx.init(tp)
        for _ in range(STEPS):
            jp, js, jl = jstep(jp, js, jb)
            tp, ts, tl = tstep(tp, ts, tb)
            np.testing.assert_allclose(float(tl), float(jl), atol=TRAIN_ATOL)
        assert isinstance(ts, GNSState)
        _assert_close(tp, jp, TRAIN_ATOL, "params")
        _assert_close(ts.inner, js.inner, TRAIN_ATOL, "inner state")
        assert bool(ts.ema.initialized) and math.isfinite(
            float(ts.noise_scale))
        # a ratio of differences of square norms, each within f32
        # reassociation of the other package's
        np.testing.assert_allclose(float(ts.noise_scale),
                                   float(js.noise_scale), rtol=1e-4)
        np.testing.assert_allclose(float(ts.ema.value), float(js.ema.value),
                                   rtol=1e-4)

    def test_gns_carried_unchanged_at_one_rank(self):
        _, tp, _, tb, _, tloss = _bert(5)
        tcomm = Communicator(devices=["cpu"])
        tx = monitor_gradient_noise_scale(sgd(0.05), tcomm.axis,
                                          local_batch_size=ROWS)
        step = dp_train_step(tloss, tx, tcomm)
        p, s, _ = step(tp, tx.init(tp), tb)
        assert not bool(s.ema.initialized) and float(s.noise_scale) == 0.0

    @pytest.mark.parametrize("inner", ["momentum", "adam"])
    def test_variance_five_steps(self, inner):
        make_j, make_t = INNERS[inner]
        jp, tp, jb, tb, jloss, tloss = _bert(6)
        jcomm, tcomm = _comms()
        jtx, ttx = jvar(make_j(), jcomm.axis), monitor_gradient_variance(
            make_t(), tcomm.axis)
        jstep, tstep = (jdp_train_step(jloss, jtx, jcomm),
                        dp_train_step(tloss, ttx, tcomm))
        js, ts = jtx.init(jp), ttx.init(tp)
        for _ in range(STEPS):
            jp, js, jl = jstep(jp, js, jb)
            tp, ts, tl = tstep(tp, ts, tb)
            np.testing.assert_allclose(float(tl), float(jl), atol=TRAIN_ATOL)
        assert isinstance(ts, GradVarianceState)
        _assert_close(tp, jp, TRAIN_ATOL, "params")
        _assert_close(ts.inner, js.inner, TRAIN_ATOL, "inner state")
        assert float(ts.variance) > 0.0
        np.testing.assert_allclose(float(ts.variance), float(js.variance),
                                   rtol=1e-4)


# -- interop --------------------------------------------------------------------

class TestInterop:
    @pytest.mark.parametrize("kind", ["sma_adam", "ada_momentum", "gns",
                                      "variance"])
    def test_state_round_trip(self, kind):
        """A reference state after two steps into the port's template and
        back, bitwise, leaf for leaf; then one more step on each side
        from the carried state agrees."""
        jp, tp, jb, tb, jloss, tloss = _bert(8)
        jcomm, tcomm = _comms()
        stacked = kind in ("sma_adam", "ada_momentum")
        jtx, ttx = {
            "sma_adam": (jsma(optax.adam(1e-2, eps=1e-2), jcomm.axis),
                         synchronous_averaging(adam(1e-2, eps=1e-2),
                                               tcomm.axis)),
            "ada_momentum": (jada(optax.sgd(0.05, 0.9), jcomm.axis, 1),
                             adaptive_sgd(sgd(0.05, 0.9), tcomm.axis, 1)),
            "gns": (jgns(optax.sgd(0.05), jcomm.axis, ROWS),
                    monitor_gradient_noise_scale(sgd(0.05), tcomm.axis,
                                                 ROWS)),
            "variance": (jvar(optax.sgd(0.05), jcomm.axis),
                         monitor_gradient_variance(sgd(0.05), tcomm.axis)),
        }[kind]
        jstep = jdp_train_step(jloss, jtx, jcomm, replicated_params=not stacked)
        tstep = dp_train_step(tloss, ttx, tcomm, replicated_params=not stacked)
        js = jtx.init(jp)
        tmpl = ttx.init(tp)
        if stacked:
            jp, js = jstack(jp, N), jstack(js, N)
            tmpl = stack_for_replicas(tmpl, N)
        for _ in range(2):
            jp, js, _ = jstep(jp, js, jb)
        np_p = jax.tree_util.tree_map(np.asarray, jp)
        tp = interop.params_from_jax(np_p, ttr.TransformerConfig(**_BERT),
                                     device="cpu",
                                     replicas=N if stacked else None)
        ts = interop.tree_from_jax(
            [np.asarray(a) for a in jax.tree_util.tree_leaves(js)], tmpl)
        back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js),
                                            interop.tree_to_jax(ts))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(js)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        p_back = interop.params_to_jax(tp)
        for a, b in zip(jax.tree_util.tree_leaves(p_back),
                        jax.tree_util.tree_leaves(np_p)):
            np.testing.assert_array_equal(a, b)
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tl), float(jl), atol=TRAIN_ATOL)
        _assert_close(tp, jp, TRAIN_ATOL, "params")
        _assert_close(ts, js, TRAIN_ATOL, "state")

    def test_ema_and_counter_states(self):
        js = jstate.exponential_moving_average(jstate.ema_init(), 2.5)[0]
        ts = interop.tree_from_jax(
            [np.asarray(a) for a in jax.tree_util.tree_leaves(js)],
            tstate.ema_init(device="cpu"))
        assert bool(ts.initialized) and float(ts.value) == 2.5
        assert ts.initialized.dtype == torch.bool
        jc = jstate.counter(jstate.counter()[0], 4)[0]
        tc = interop.tree_from_jax(
            [np.asarray(a) for a in jax.tree_util.tree_leaves(jc)],
            tstate.counter(device="cpu")[0])
        assert int(tc.step) == 5 and tc.step.dtype == torch.int32

    def test_stacked_params_shapes_checked(self):
        jp, _, *_ = _bert()
        np_p = jax.tree_util.tree_map(np.asarray, jp)
        cfg = ttr.TransformerConfig(**_BERT)
        with pytest.raises(ValueError, match="shape"):
            interop.params_from_jax(np_p, cfg, device="cpu", replicas=N)


# -- strategy autotuning ------------------------------------------------------

def _reference_mean(x: np.ndarray) -> np.ndarray:
    return np.broadcast_to(x.mean(0, dtype=np.float64), x.shape)


class TestAutotune:
    def test_picks_and_installs(self):
        """tests/test_schedules.py:323: a schedule of ALLREDUCE_SCHEDULES
        is returned and installed, and results under it are right."""
        comm = Communicator(devices=["cpu"] * 8, local_size=8)
        winner = comm.autotune_strategy(nbytes=1 << 12, trials=1)
        assert winner in ALLREDUCE_SCHEDULES and comm.strategy == winner
        assert set(comm.autotune_times) == set(ALLREDUCE_SCHEDULES)
        assert all(0 < t < 1e8 for t in comm.autotune_times.values())
        x = np.random.RandomState(2).randn(8, 9).astype(np.float32)
        got = comm.all_reduce(torch.from_numpy(x), op="mean")
        psum = Communicator(devices=["cpu"] * 8).all_reduce(
            torch.from_numpy(x), op="mean")
        np.testing.assert_allclose(got.numpy(), psum.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), _reference_mean(x),
                                   rtol=1e-5, atol=1e-5)

    def test_hierarchical_mesh(self):
        comm = Communicator(devices=["cpu"] * 8, local_size=4)
        assert comm.autotune_strategy(nbytes=1 << 10, trials=1) in \
            ALLREDUCE_SCHEDULES

    @pytest.mark.parametrize("bad", [[0.0] * 4, [float("nan")] * 4,
                                     [1e9] * 4])
    def test_keeps_incumbent_on_uncredible_winner(self, monkeypatch, bad):
        """tests/test_bandit.py:183: a 0 s, non-finite or sentinel winner
        keeps the incumbent."""
        comm = Communicator(devices=["cpu"] * N)
        comm.set_strategy("two_stage")
        monkeypatch.setattr(Communicator, "_time_schedules",
                            lambda self, x, trials: list(bad))
        assert comm.autotune_strategy(nbytes=1 << 10, trials=1) == "two_stage"
        assert comm.strategy == "two_stage"

    def test_no_schedule_timed_raises(self, monkeypatch):
        comm = Communicator(devices=["cpu"] * N)
        monkeypatch.setattr(Communicator, "_time_schedules",
                            lambda self, x, trials: [None] * 4)
        with pytest.raises(RuntimeError, match="no allreduce schedule"):
            comm.autotune_strategy(nbytes=1 << 10)
        assert comm.strategy == "psum"

    def test_failed_schedule_is_dropped(self, monkeypatch):
        """A schedule that raises is not a candidate; the others are."""
        from kungfu_tpu_torch.comm import device

        real = device.all_reduce_scheduled

        def flaky(x, axes, op, schedule):
            if schedule == "ring":
                raise RuntimeError("no ring here")
            return real(x, axes, op=op, schedule=schedule)

        monkeypatch.setattr(device, "all_reduce_scheduled", flaky)
        comm = Communicator(devices=["cpu"] * N)
        times = comm._time_schedules(torch.ones(N, 16), 1)
        assert times[ALLREDUCE_SCHEDULES.index("ring")] is None
        assert all(t is not None for s, t in zip(ALLREDUCE_SCHEDULES, times)
                   if s != "ring")
        assert comm.autotune_strategy(nbytes=1 << 10, trials=1) != "ring"

    def test_agree_is_the_identity_on_one_controller(self):
        comm = Communicator(devices=["cpu"] * N)
        comm.set_strategy("ring")
        comm.set_bucket_strategy(0, "two_stage")
        row = [0.25, 3.0, 1e9, 7.5]
        assert comm._agree(row, op="mean") == row
        assert comm._agree(row, op="min") == row
        assert comm.strategy == "ring" and comm.bucket_strategies() == {
            0: "two_stage"}

    def test_probe_buffer_is_released(self):
        """The probe's buffer goes when the call returns (the reference
        drops its probe programs, comm/device.py:322-327)."""
        import gc
        import weakref

        comm = Communicator(devices=["cpu"] * N)
        seen = []
        real = comm._time_schedules

        def spy(x, trials):
            seen.append(weakref.ref(x))
            return real(x, trials)

        comm._time_schedules = spy
        comm.autotune_strategy(nbytes=1 << 10, trials=1)
        gc.collect()
        assert seen and seen[0]() is None


class TestDeviceStrategyDriver:
    def _drive(self, drv):
        """tests/test_schedules.py:369-398's synthetic step times."""
        fired = []
        for dt in [0.010] * 8 + [0.030] * 16:
            fired.append(drv.observe(dt))
        return fired

    def test_same_swaps_as_reference(self):
        jcomm = JCommunicator(devices=jax.devices()[:8], local_size=8)
        tcomm = Communicator(devices=["cpu"] * 8, local_size=8)
        kw = dict(check_every=4, regression=1.5, consecutive=2,
                  autotune_nbytes=1 << 10)
        jdrv, tdrv = JDriver(jcomm, **kw), DeviceStrategyDriver(tcomm, **kw)
        jfired, tfired = self._drive(jdrv), self._drive(tdrv)
        assert tfired == jfired
        # the second consecutive bad window (step 16) re-tunes, once
        assert [i for i, f in enumerate(tfired) if f] == [15]
        assert tdrv.swaps == jdrv.swaps == 1
        assert tcomm.strategy in ALLREDUCE_SCHEDULES

    def test_healthy_windows_track_the_baseline(self):
        tcomm = Communicator(devices=["cpu"] * N)
        drv = DeviceStrategyDriver(tcomm, check_every=2, ema=0.5)
        for dt in (1.0, 1.0, 0.010, 0.010, 0.012, 0.012):
            assert not drv.observe(dt)
        assert drv._baseline == pytest.approx(0.011)
        assert drv.swaps == 0
