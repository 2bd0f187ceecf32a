"""Port parity: the single-card training step against the JAX reference.

``Transformer.loss`` and its gradients, ``dp_train_step`` over
``synchronous_sgd(sgd(0.05, momentum=0.9))`` for a few steps, and the
pieces under them (collectives at world size 1, fuse/defuse, the optax
subset, the pulse monitor, dropout), each held against its JAX
counterpart on the CPU at a tiny config in f32.  JAX's flash and xent
kernels run in interpret mode; the port's take their plain versions on
CPU tensors.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.monitor import pulse as jpulse
from kungfu_tpu.ops import costmodel as jcost
from kungfu_tpu.ops.fuse import fuse as jfuse
from kungfu_tpu.ops.monitor import _sq_norm as jsq_norm
from kungfu_tpu.ops.pallas import make_flash_attn as jmake_flash
from kungfu_tpu.ops.pallas.xent import XENT_ENV as JXENT_ENV
from kungfu_tpu.ops.pallas.xent import softmax_cross_entropy as jxent
from kungfu_tpu.optimizers import synchronous_sgd as jsync
from kungfu_tpu.parallel.train import dp_train_step as jdp_train_step
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.models import nn as tnn
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.monitor import pulse as tpulse
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.ops import collective, schedules
from kungfu_tpu_torch.ops import costmodel as tcost
from kungfu_tpu_torch.ops.cuda.attention import make_flash_attn
from kungfu_tpu_torch.ops.fuse import defuse as tdefuse
from kungfu_tpu_torch.ops.fuse import fuse as tfuse
from kungfu_tpu_torch.ops.monitor import _sq_norm
from kungfu_tpu_torch.ops.xent import XENT_ENV, softmax_cross_entropy
from kungfu_tpu_torch.optimizers import apply_updates, sgd, synchronous_sgd
from kungfu_tpu_torch.parallel.train import dp_train_step
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

#: loss and gradients of one f32 step, flash + fused xent in both
#: packages: the reference's flash-vs-plain logits tolerance
#: (tests/test_pallas.py:148-165) carried to the scalar loss, and
#: gradients summed over tokens to a few ulps of f32 reassociation
LOSS_ATOL = 2e-5
GRAD_ATOL = 2e-5
#: five SGD steps (lr 0.05, momentum 0.9) from identical params: the
#: per-step f32 differences above compound through the momentum trace
TRAIN_ATOL = 1e-4

_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=32, causal=True, pos="rope", dtype="float32")


@pytest.fixture
def xent_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("KF_TPU_XENT", mode)
        XENT_ENV.reload()
        JXENT_ENV.reload()

    yield set_mode
    monkeypatch.undo()
    XENT_ENV.reload()


def _setup(seed=0, b=2, s=32):
    jcfg, tcfg = jtr.TransformerConfig(**_KW), ttr.TransformerConfig(**_KW)
    jp = jtr.Transformer(jcfg).init(jax.random.PRNGKey(seed))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, _KW["vocab_size"], size=(b, s))
    tgt = rng.integers(0, _KW["vocab_size"], size=(b, s))
    return (jtr.Transformer(jcfg), jp, ttr.Transformer(tcfg), tp, ids, tgt)


def _assert_trees_close(got, ref, atol):
    tflat = ttr.flatten(got)
    jflat = ttr.flatten(jax.tree_util.tree_map(np.asarray, ref))
    assert tflat.keys() == jflat.keys()
    for k in tflat:
        np.testing.assert_allclose(tflat[k].detach().numpy(), jflat[k],
                                   atol=atol, err_msg=k)


class TestDifferentiableModel:
    def test_apply_is_differentiable(self):
        """``apply`` builds a graph (no ``no_grad``): the loss reaches
        every parameter, as ``jax.grad`` through the reference does."""
        _, _, model, tp, ids, tgt = _setup()
        leaves, treedef = tree_flatten(tp)
        leaves = [l.requires_grad_(True) for l in leaves]
        logits = model.apply(tp, torch.from_numpy(ids))
        assert logits.requires_grad
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 64), torch.from_numpy(tgt).reshape(-1))
        grads = torch.autograd.grad(loss, leaves)
        assert all(torch.isfinite(g).all() and g.abs().sum() > 0
                   for g in grads)

    def test_inference_mode_builds_no_graph(self):
        _, _, model, tp, ids, _ = _setup()
        for l in tree_flatten(tp)[0]:
            l.requires_grad_(True)
        with torch.inference_mode():
            logits = model.apply(tp, torch.from_numpy(ids))
        assert not logits.requires_grad


class TestLossVersusJax:
    @pytest.mark.parametrize("attn,mode", [("flash", "fused"),
                                           ("flash", "plain"),
                                           ("default", "auto")])
    def test_loss_and_grads(self, xent_mode, attn, mode):
        xent_mode(mode)
        jmodel, jp, tmodel, tp, ids, tgt = _setup(seed=1)
        j_attn = jmake_flash() if attn == "flash" else jtr.default_attention
        t_attn = make_flash_attn() if attn == "flash" else \
            ttr.default_attention
        batch = (jnp.asarray(ids, jnp.int32), jnp.asarray(tgt, jnp.int32))
        jloss, jgrads = jax.value_and_grad(
            lambda p: jmodel.loss(p, batch, attn_fn=j_attn))(jp)
        leaves, treedef = tree_flatten(tp)
        leaves = [l.requires_grad_(True) for l in leaves]
        tloss = tmodel.loss(tp, (torch.from_numpy(ids), torch.from_numpy(tgt)),
                            attn_fn=t_attn)
        grads = torch.autograd.grad(tloss, leaves)
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   atol=LOSS_ATOL)
        _assert_trees_close(tree_unflatten(treedef, grads), jgrads, GRAD_ATOL)

    def test_lm_head_modes(self, monkeypatch):
        _, _, model, tp, ids, tgt = _setup()
        batch = (torch.from_numpy(ids), torch.from_numpy(tgt))
        attn = ttr.default_attention
        monkeypatch.setenv("KF_TPU_LM_HEAD", "plain")
        plain = float(model.loss(tp, batch, attn_fn=attn))
        monkeypatch.setenv("KF_TPU_LM_HEAD", "auto")
        assert float(model.loss(tp, batch, attn_fn=attn)) == plain
        monkeypatch.setenv("KF_TPU_LM_HEAD", "fused")
        np.testing.assert_allclose(float(model.loss(tp, batch, attn_fn=attn)),
                                   plain, rtol=2e-5)
        monkeypatch.setenv("KF_TPU_LM_HEAD", "bogus")
        with pytest.raises(ValueError, match="KF_TPU_LM_HEAD"):
            model.loss(tp, batch, attn_fn=attn)


class TestDropout:
    def test_identity_when_off(self):
        x = torch.randn(4, 8)
        gen = torch.Generator().manual_seed(0)
        assert tnn.dropout(gen, x, 0.0, True) is x
        assert tnn.dropout(gen, x, 0.5, False) is x

    def test_keeps_scaled_share(self):
        x = torch.ones(200, 200, dtype=torch.bfloat16)
        y = tnn.dropout(torch.Generator().manual_seed(0), x, 0.25, True)
        assert y.dtype == torch.bfloat16
        kept = torch.tensor(1 / 0.75).to(torch.bfloat16).item()
        assert set(torch.unique(y.float()).tolist()) == {0.0, kept}
        assert abs((y == 0).float().mean().item() - 0.25) < 0.02

    def test_model_dropout_needs_generator_and_train(self):
        kw = dict(_KW, dropout=0.5)
        model = ttr.Transformer(ttr.TransformerConfig(**kw))
        tp = model.init(device="cpu")
        ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (1, 8)))
        a = model.apply(tp, ids, attn_fn=ttr.default_attention)
        b = model.apply(tp, ids, train=True, attn_fn=ttr.default_attention)
        c = model.apply(tp, ids, train=True,
                        generator=torch.Generator().manual_seed(1),
                        attn_fn=ttr.default_attention)
        assert torch.equal(a, b) and not torch.allclose(a, c)


class TestTrainStepVersusJax:
    @pytest.mark.parametrize("fuse_grads", [False, True])
    def test_five_steps(self, xent_mode, fuse_grads):
        """bench.py's LM loss (flash attention + fused xent) through each
        package's dp_train_step for five steps from the same params."""
        xent_mode("fused")
        jmodel, jp, tmodel, tp, ids, tgt = _setup(seed=2)
        jflash, tflash = jmake_flash(), make_flash_attn()

        def jloss(p, batch):
            return jnp.mean(jxent(jmodel.apply(p, batch[0], train=True,
                                               attn_fn=jflash), batch[1]))

        def tloss(p, batch):
            return softmax_cross_entropy(tmodel.apply(
                p, batch[0], train=True, attn_fn=tflash), batch[1]).mean()

        jcomm = JCommunicator(devices=[jax.devices()[0]], local_size=1)
        jtx = jsync(optax.sgd(0.05, momentum=0.9), jcomm.axis,
                    fuse_grads=fuse_grads)
        jstep = jdp_train_step(jloss, jtx, jcomm)
        comm = Communicator(devices=["cpu"])
        ttx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis,
                              fuse_grads=fuse_grads)
        tstep = dp_train_step(tloss, ttx, comm)
        jbatch = (jnp.asarray(ids, jnp.int32), jnp.asarray(tgt, jnp.int32))
        tbatch = (torch.from_numpy(ids), torch.from_numpy(tgt))
        js, ts = jtx.init(jp), ttx.init(tp)
        jlosses, tlosses = [], []
        for _ in range(5):
            jp, js, jl = jstep(jp, js, jbatch)
            tp, ts, tl = tstep(tp, ts, tbatch)
            jlosses.append(float(jl))
            tlosses.append(float(tl))
        np.testing.assert_allclose(tlosses, jlosses, atol=TRAIN_ATOL)
        assert tlosses[-1] < tlosses[0]
        _assert_trees_close(tp, jp, TRAIN_ATOL)

    def test_five_steps_fused_lm_head(self, monkeypatch):
        """``Transformer.loss`` under ``KF_TPU_LM_HEAD=fused`` (flash
        attention, the fused LM head) through each package's
        dp_train_step for five steps from the same params."""
        monkeypatch.setenv("KF_TPU_LM_HEAD", "fused")
        jmodel, jp, tmodel, tp, ids, tgt = _setup(seed=3)
        jflash, tflash = jmake_flash(), make_flash_attn()
        jcomm = JCommunicator(devices=[jax.devices()[0]], local_size=1)
        jtx = jsync(optax.sgd(0.05, momentum=0.9), jcomm.axis)
        jstep = jdp_train_step(
            lambda p, b: jmodel.loss(p, b, attn_fn=jflash), jtx, jcomm)
        comm = Communicator(devices=["cpu"])
        ttx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis)
        tstep = dp_train_step(
            lambda p, b: tmodel.loss(p, b, attn_fn=tflash), ttx, comm)
        jbatch = (jnp.asarray(ids, jnp.int32), jnp.asarray(tgt, jnp.int32))
        tbatch = (torch.from_numpy(ids), torch.from_numpy(tgt))
        js, ts = jtx.init(jp), ttx.init(tp)
        jlosses, tlosses = [], []
        for _ in range(5):
            jp, js, jl = jstep(jp, js, jbatch)
            tp, ts, tl = tstep(tp, ts, tbatch)
            jlosses.append(float(jl))
            tlosses.append(float(tl))
        np.testing.assert_allclose(tlosses, jlosses, atol=TRAIN_ATOL)
        assert tlosses[-1] < tlosses[0]
        _assert_trees_close(tp, jp, TRAIN_ATOL)

    def test_step_is_functional(self):
        _, _, model, tp, ids, tgt = _setup()
        comm = Communicator(devices=["cpu"])
        tx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis)
        step = dp_train_step(lambda p, b: model.loss(
            p, b, attn_fn=ttr.default_attention), tx, comm)
        before = {k: t.clone() for k, t in ttr.flatten(tp).items()}
        new, _, loss = step(tp, tx.init(tp),
                            (torch.from_numpy(ids), torch.from_numpy(tgt)))
        assert loss.dim() == 0 and not loss.requires_grad
        for k, t in ttr.flatten(tp).items():
            assert torch.equal(t, before[k]), k
            assert not ttr.flatten(new)[k].requires_grad

    def test_has_aux(self):
        comm = Communicator(devices=["cpu"])
        tx = synchronous_sgd(sgd(0.1), comm.axis)

        def loss_fn(p, aux, batch):
            return (p["w"] * batch).sum() ** 2, {"count": aux["count"] + 1.0}

        step = dp_train_step(loss_fn, tx, comm, has_aux=True)
        p = {"w": torch.tensor([1.0, 2.0])}
        p2, aux, _, loss = step(p, {"count": torch.tensor(0.0)},
                                tx.init(p), torch.tensor([1.0, 1.0]))
        assert float(loss) == 9.0 and float(aux["count"]) == 1.0
        np.testing.assert_allclose(p2["w"].numpy(), [1.0 - 0.6, 2.0 - 0.6])

    @pytest.mark.parametrize("kwargs,match", [
        (dict(zero_stage=1, has_aux=True), "ZeRO"),
        (dict(plan=types.SimpleNamespace(tp=2, pp=1, sp=1, zero_stage=0,
                                         collective_schedule="psum")),
         "tp=2"),
        (dict(plan=types.SimpleNamespace(tp=1, pp=1, sp=1, zero_stage=2,
                                         collective_schedule="psum"),
              replicated_params=False),
         "ZeRO"),
    ])
    def test_later_slices_raise(self, kwargs, match):
        """What the port does not run raises, naming it: the tp/pp/sp
        plan (a later slice), and a ZeRO stage with aux state or stacked
        params (refused by the reference too)."""
        comm = Communicator(devices=["cpu"])
        with pytest.raises((NotImplementedError, ValueError), match=match):
            dp_train_step(lambda p, b: 0.0, sgd(0.1), comm, **kwargs)


class TestPulse:
    def test_samples_on_step_ten(self, monkeypatch):
        """The default KF_PULSE_EVERY=10 samples the 10th step: no noise
        scale at world size 1, the flat gradient norm of that step and a
        zero variance published to the registry."""
        monkeypatch.delenv("KF_PULSE_EVERY", raising=False)
        REGISTRY.reset()
        _, _, model, tp, ids, tgt = _setup()
        comm = Communicator(devices=["cpu"])
        tx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis)

        def loss_fn(p, b):
            return model.loss(p, b, attn_fn=ttr.default_attention)

        step = dp_train_step(loss_fn, tx, comm)
        assert step.pulse.every == 10
        batch = (torch.from_numpy(ids), torch.from_numpy(tgt))
        state = tx.init(tp)
        for i in range(9):
            tp, state, _ = step(tp, state, batch)
            assert step.pulse.samples == 0
        leaves, treedef = tree_flatten(tp)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        g = torch.autograd.grad(loss_fn(tree_unflatten(treedef, leaves),
                                        batch), leaves)
        want = float(sum((x.double() ** 2).sum() for x in g)) ** 0.5
        step(tp, state, batch)
        assert step.pulse.samples == 1 and step.pulse.gns is None
        snap = REGISTRY.snapshot()
        assert "kf_gns" not in snap
        assert snap["kf_grad_variance"] == 0.0
        assert snap['kf_grad_norm{group="flat"}'] == pytest.approx(want,
                                                                   rel=1e-5)

    def test_disabled_by_zero(self, monkeypatch):
        monkeypatch.setenv("KF_PULSE_EVERY", "0")
        assert tpulse.PulseMonitor.from_env() is None
        comm = Communicator(devices=["cpu"])
        assert dp_train_step(lambda p, b: 0.0, sgd(0.1), comm).pulse is None

    @pytest.mark.parametrize("args", [(4.0, 1.0, 8, 4), (2.0, 2.5, 3, 2),
                                      (1.0, 1.0, 5, 1)])
    def test_estimators_match_jax(self, args):
        assert tpulse.noise_scale(*args) == jpulse.noise_scale(*args)
        assert tpulse.grad_variance(*args[:2]) == \
            jpulse.grad_variance(*args[:2])

    def test_gate_and_ema_match_jax(self):
        t, j = tpulse.PulseMonitor(every=3), jpulse.PulseMonitor(every=3)
        assert [t.should_sample() for _ in range(7)] == \
            [j.should_sample() for _ in range(7)]
        assert t.should_sample(step=6) and not t.should_sample(step=7)
        for gl, gg in [(4.0, 1.0), (3.0, 2.0)]:
            a, b = t.update(gl, gg, 4, 2), j.update(gl, gg, 4, 2)
            assert a == pytest.approx(b)


class TestCollectivesAtWorldOne:
    def test_all_reduce_is_identity(self):
        x = {"a": torch.arange(3.0), "b": [torch.ones(2)]}
        for op in ("sum", "mean", "min", "max"):
            assert collective.all_reduce(x, ("kf_host", "kf_local"), op) is x
        assert collective.group_all_reduce(x, "kf_local", "mean") is x
        assert collective.peer_size("kf_local") == 1
        assert collective.peer_rank("kf_local") == 0
        with pytest.raises(ValueError):
            collective.all_reduce(x, "kf_local", op="prod")

    def test_schedules(self):
        x = torch.ones(3)
        assert schedules.all_reduce_scheduled(x, "kf_local", "mean") is x
        for name in ("ring", "two_stage", "pallas_ring"):
            assert schedules.all_reduce_scheduled(x, "kf_local",
                                                  schedule=name) is x
        with pytest.raises(ValueError):
            schedules.all_reduce_scheduled(x, "kf_local", schedule="bogus")

    def test_communicator(self):
        comm = Communicator(devices=["cpu"])
        assert (comm.size, comm.rank, comm.strategy) == (1, 0, "psum")
        assert comm.axis == JCommunicator(devices=[jax.devices()[0]],
                                          local_size=1).axis
        with pytest.raises(ValueError):
            comm.set_strategy("bogus")
        assert Communicator(devices=["cpu", "cpu"]).size == 2
        with pytest.raises(NotImplementedError, match="multi-card"):
            Communicator(devices=["cpu", "cuda:1"])


class TestFuseAndOptimizer:
    def _tree(self):
        rng = np.random.default_rng(3)
        return {"b": rng.normal(size=(3, 2)).astype(np.float32),
                "a": {"y": rng.normal(size=(4,)).astype(np.float32),
                      "x": rng.normal(size=(2, 2)).astype(np.float32)}}

    def test_fuse_layout_matches_jax(self):
        tree = self._tree()
        buf, spec = tfuse(tree_map(torch.from_numpy, tree))
        jbuf, _ = jfuse(jax.tree_util.tree_map(jnp.asarray, tree))
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        back = tdefuse(buf * 2, spec)
        for k, v in ttr.flatten(back).items():
            np.testing.assert_array_equal(v.numpy(),
                                          2 * ttr.flatten(tree)[k])

    @pytest.mark.parametrize("momentum,nesterov", [(None, False),
                                                   (0.9, False), (0.9, True)])
    def test_sgd_matches_optax(self, momentum, nesterov):
        params = self._tree()
        grads = tree_map(lambda a: a * 0.5 + 0.1, params)
        jtx = optax.sgd(0.05, momentum=momentum, nesterov=nesterov)
        ttx = sgd(0.05, momentum=momentum, nesterov=nesterov)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        tp = tree_map(torch.from_numpy, params)
        js, ts = jtx.init(jp), ttx.init(tp)
        for _ in range(3):
            ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                js, jp)
            jp = optax.apply_updates(jp, ju)
            tu, ts = ttx.update(tree_map(torch.from_numpy, grads), ts, tp)
            tp = apply_updates(tp, tu)
        _assert_trees_close(tp, jp, 1e-6)

    def test_sq_norm_matches_jax(self):
        tree = self._tree()
        np.testing.assert_allclose(
            float(_sq_norm(tree_map(torch.from_numpy, tree))),
            float(jsq_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
            rtol=1e-6)

    def test_train_step_flops_match_jax(self):
        jcfg, tcfg = jtr.TransformerConfig(**_KW), ttr.TransformerConfig(**_KW)
        assert tcost.train_step_flops(tcfg, 4, 32) == \
            jcost.train_step_flops(jcfg, 4, 32)
