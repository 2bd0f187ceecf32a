"""Port parity: the image models (conv, batch norm, sync-BN, ResNet, VGG,
the MNIST SLP, the fake gradient sets), their weights carrier, and
``dp_train_step`` with a batch-norm aux over four stacked ranks, against
the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; the
reference's models run jitted once per module-scoped fixture.  Parameters
cross with ``interop.image_params_from_jax``.  Tolerances (f32):

* one layer (conv, the s2d stem, batch norm): ``rtol 1e-5, atol 1e-5``
  (the stem's gradient ``1e-4``, the reference's own,
  ``tests/test_models.py:76-103``); sync-BN ``rtol 2e-5``
  (``tests/test_parallel.py:344``);
* whole models: the loss within ``rtol 1e-4``, the logits within
  ``1e-4`` relative L2 (VGG-16-BN's train-mode logits differ by 7e-5 of
  the largest, small entries by more than an elementwise ``atol 1e-5``),
  the BN state within ``rtol 1e-4`` and an ``atol`` of ``1e-5`` of the
  largest |value|; gradients within ``1e-4`` relative L2 per leaf; bf16
  losses within ``rtol 2e-2``.

ResNet-50 in train mode at ``[2, 32, 32, 3]`` is ill-conditioned in f32
in both packages: stage 3 runs at 1x1, so each of its batch norms
normalizes two samples a channel, where ``var = m2 - mean^2`` cancels
and the exact input gradient is zero up to rounding.  A relative
perturbation of 6e-8 of the port's own params moves its train-mode
gradient by 0.67 relative L2 (0.001 at 64x64), and the reference's
gradient moves by 0.19 between its jitted and eager runs.  So the
train-mode ResNet is held on its loss and on the running stats of every
batch norm before stage 3; train-mode gradients are held on VGG-16-BN
(each batch norm over at least 8 samples a channel, well-conditioned)
and on one bottleneck block; ResNet's gradients are held in eval mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.models import MLP as JMLP
from kungfu_tpu.models import ResNet as JResNet
from kungfu_tpu.models import VGG as JVGG
from kungfu_tpu.models import fake as jfake
from kungfu_tpu.models import mnist_slp as jmnist_slp
from kungfu_tpu.models import nn as jnn
from kungfu_tpu.optimizers import synchronous_sgd as jsync
from kungfu_tpu.parallel.train import dp_train_step as jdp_train_step
from kungfu_tpu.utils.jaxcompat import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.models import (MLP, VGG, ResNet, fake, mnist_slp, nn,
                                     resnet50, vgg16)
from kungfu_tpu_torch.models.resnet import bottleneck
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
from kungfu_tpu_torch.parallel.train import dp_train_step
from kungfu_tpu_torch.utils.tree import (tree_flatten,
                                         tree_flatten_with_path, tree_leaves,
                                         tree_map, tree_unflatten)

RTOL, ATOL = 1e-4, 1e-5
GRAD_REL_L2 = 1e-4
BF16_RTOL = 2e-2
N_RANKS = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small convolutions gain nothing from more threads, and the other
    workers of a parallel run keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _assert_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """|got - want| <= atol * max(1, max|want|) + rtol * |want|."""
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_tree_close(got, want, what, rtol=RTOL, atol=ATOL, skip=()):
    got_l, _ = tree_flatten_with_path(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for (path, g), w in zip(got_l, want_l):
        name = "/".join(path)
        if any(name.startswith(s) for s in skip):
            continue
        _assert_close(g, w, rtol, atol, f"{what} {name}")


def _assert_grads(got, want, what, tol=GRAD_REL_L2):
    got_l, _ = tree_flatten_with_path(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    rel = {"/".join(p): _rel_l2(g, w) for (p, g), w in zip(got_l, want_l)}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= tol, f"{what}: {worst} rel L2 {rel[worst]:.3e}"


def _port_grads(loss_fn, params):
    """``(loss, aux, grads)`` of ``loss_fn(params) -> (loss, aux)``."""
    leaves, treedef = tree_flatten(params)
    own = [l.detach().clone().requires_grad_(True) for l in leaves]
    loss, aux = loss_fn(tree_unflatten(treedef, own))
    grads = torch.autograd.grad(loss, own)
    return loss.detach(), aux, tree_unflatten(treedef, list(grads))


# -- layers -------------------------------------------------------------------

class TestConv:
    @pytest.mark.parametrize("k", [1, 3, 7])
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("hw", [(8, 10), (9, 11)], ids=["even", "odd"])
    @pytest.mark.parametrize("bias", [False, True])
    def test_conv_apply(self, k, stride, padding, hw, bias):
        rng = np.random.default_rng(k * 100 + stride * 10 + hw[0])
        p = {"w": rng.standard_normal((k, k, 3, 5)).astype(np.float32)}
        if bias:
            p["b"] = rng.standard_normal(5).astype(np.float32)
        x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
        want = jnn.conv_apply(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), stride=stride, padding=padding)
        got = nn.conv_apply(tree_map(_t, p), _t(x), stride=stride,
                            padding=padding)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    def test_same_pads_are_xla_s(self):
        """3x3/s2 on an even axis pads (0, 1): the odd pixel at the end,
        which F.conv2d's symmetric padding cannot express."""
        assert nn.same_pads(112, 3, 2) == (0, 1)
        assert nn.same_pads(113, 3, 2) == (1, 1)
        assert nn.same_pads(56, 1, 2) == (0, 0)
        assert nn.same_pads(224, 7, 2) == (2, 3)

    def test_stacked_leading_axes_fold_into_the_batch(self):
        rng = np.random.default_rng(3)
        p = {"w": _t(rng.standard_normal((3, 3, 4, 6)).astype(np.float32))}
        x = _t(rng.standard_normal((2, 3, 8, 8, 4)).astype(np.float32))
        got = nn.conv_apply(p, x, stride=2)
        want = nn.conv_apply(p, x.reshape(6, 8, 8, 4), stride=2)
        assert torch.equal(got, want.reshape(2, 3, 4, 4, 6))


class TestStem:
    def _pw(self):
        p = jnn.conv_init(jax.random.PRNGKey(0), 3, 16, (7, 7))
        x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
        return p, {"w": _t(p["w"])}, x

    def test_s2d_against_reference_and_direct_conv(self):
        jp, tp, x = self._pw()
        want = jnn.conv_stem_s2d_apply(jp, jnp.asarray(x))
        got = nn.conv_stem_s2d_apply(tp, _t(x))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        direct = nn.conv_apply(tp, _t(x), stride=2)
        np.testing.assert_allclose(_np(got), _np(direct), rtol=1e-5,
                                   atol=1e-5)

    def test_s2d_gradient(self):
        jp, tp, x = self._pw()
        want = jax.grad(lambda w: jnp.sum(
            jnn.conv_stem_s2d_apply({"w": w}, jnp.asarray(x)) ** 2))(jp["w"])
        w = tp["w"].clone().requires_grad_(True)
        (got,) = torch.autograd.grad(
            nn.conv_stem_s2d_apply({"w": w}, _t(x)).square().sum(), [w])
        direct_w = tp["w"].clone().requires_grad_(True)
        (direct,) = torch.autograd.grad(nn.conv_apply(
            {"w": direct_w}, _t(x), stride=2).square().sum(), [direct_w])
        # the reference's rtol 1e-4; its atol 1e-4 is 1e-7 of these
        # gradients (|g| ~ 1e3, sums of 2048 f32 products in another
        # order here), so atol is 1e-6 of the largest |g|
        for other in (np.asarray(want), _np(direct)):
            _assert_close(got, other, rtol=1e-4, atol=1e-6)

    def test_odd_size_falls_back(self):
        jp, tp, x = self._pw()
        x_odd = x[:, :63, :63, :]
        want = jnn.conv_stem_s2d_apply(jp, jnp.asarray(x_odd))
        got = nn.conv_stem_s2d_apply(tp, _t(x_odd))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(
            _np(got), _np(nn.conv_apply(tp, _t(x_odd), stride=2)),
            rtol=1e-5, atol=1e-5)


def _bn_inputs(seed=0, shape=(4, 6, 6, 8)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    st = {"mean": rng.standard_normal(c).astype(np.float32),
          "var": (rng.random(c) + 0.5).astype(np.float32)}
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    return p, st, x


class TestBatchNorm:
    @pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
    @pytest.mark.parametrize("dtype,compute", [
        ("float32", None), ("bfloat16", None), ("bfloat16", "float32"),
        ("bfloat16", "env_f32")])
    def test_batchnorm_apply(self, train, dtype, compute, monkeypatch):
        p, st, x = _bn_inputs()
        if compute == "env_f32":
            monkeypatch.setenv("KF_TPU_BN_COMPUTE", "f32")
        jcd = jnp.float32 if compute == "float32" else None
        tcd = torch.float32 if compute == "float32" else None
        jx = jnp.asarray(x, getattr(jnp, dtype))
        tx = _t(x).to(getattr(torch, dtype))
        want_y, want_st = jnn.batchnorm_apply(
            jax.tree_util.tree_map(jnp.asarray, p),
            jax.tree_util.tree_map(jnp.asarray, st), jx, train,
            compute_dtype=jcd)
        got_y, got_st = nn.batchnorm_apply(tree_map(_t, p), tree_map(_t, st),
                                           tx, train, compute_dtype=tcd)
        assert got_y.dtype == tx.dtype
        if dtype == "float32":
            tol = dict(rtol=1e-5, atol=1e-5)
        else:
            # one bf16 rounding of the output (2^-8 relative) either side
            tol = dict(rtol=2 ** -7, atol=2 ** -7)
        np.testing.assert_allclose(_np(got_y.float()),
                                   np.asarray(want_y.astype(jnp.float32)),
                                   **tol)
        for k in ("mean", "var"):
            np.testing.assert_allclose(_np(got_st[k]), np.asarray(want_st[k]),
                                       rtol=1e-5, atol=1e-5)

    def test_bf16_chain_matches_its_dtype(self, monkeypatch):
        """The normalize chain runs in bf16 by default and in f32 under
        the knob: the two outputs differ, each as the reference's."""
        p, st, x = _bn_inputs(1)
        tx = _t(x).bfloat16()
        args = (tree_map(_t, p), tree_map(_t, st), tx, True)
        y16, _ = nn.batchnorm_apply(*args)
        monkeypatch.setenv("KF_TPU_BN_COMPUTE", "f32")
        y32, _ = nn.batchnorm_apply(*args)
        assert not torch.equal(y16, y32)
        assert nn.bn_compute_dtype(torch.bfloat16) == torch.float32

    def test_train_gradient(self):
        p, st, x = _bn_inputs(2, (8, 5, 5, 6))

        def jloss(pp, xx):
            y, _ = jnn.batchnorm_apply(pp, st, xx, True)
            return jnp.sum(jnp.sin(y))

        gp, gx = jax.grad(jloss, argnums=(0, 1))(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
        tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
        tx = _t(x).requires_grad_(True)
        y, _ = nn.batchnorm_apply(tp, tree_map(_t, st), tx, True)
        grads = torch.autograd.grad(y.sin().sum(), [tp["bias"], tp["scale"],
                                                    tx])
        for got, want in zip(grads, (gp["bias"], gp["scale"], gx)):
            assert _rel_l2(got, want) <= GRAD_REL_L2


class TestSyncBatchNorm:
    """Sync-BN over four stacked ranks: the raw moments mean-allreduced
    before the variance is formed."""

    def _stacked(self, p, st, x):
        xs = _t(x).reshape(N_RANKS, x.shape[0] // N_RANKS, *x.shape[1:])
        with collective.rank_world([("dp", N_RANKS)]):
            return nn.batchnorm_apply(tree_map(_t, p), tree_map(_t, st), xs,
                                      True, axis_name="dp")

    def test_against_reference_shard_map(self):
        p, st, x = _bn_inputs(5, (8, 6, 6, 3))
        mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("dp",))
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        jst = jax.tree_util.tree_map(jnp.asarray, st)
        f = shard_map(
            lambda xs: jnn.batchnorm_apply(jp, jst, xs, train=True,
                                           axis_name="dp"),
            mesh=mesh, in_specs=P("dp"), out_specs=(P("dp"), P()))
        want_y, want_st = jax.jit(f)(jnp.asarray(x))
        y, stats = self._stacked(p, st, x)
        assert tuple(y.shape) == (N_RANKS, 2, 6, 6, 3)
        np.testing.assert_allclose(_np(y).reshape(x.shape),
                                   np.asarray(want_y), rtol=2e-5, atol=2e-5)
        for k in ("mean", "var"):
            assert tuple(stats[k].shape) == (N_RANKS, 3)
            for r in range(N_RANKS):
                np.testing.assert_allclose(_np(stats[k][r]),
                                           np.asarray(want_st[k]),
                                           rtol=2e-5, atol=2e-5)

    def test_equals_one_bn_on_the_concatenated_batch(self):
        p, st, x = _bn_inputs(6, (8, 4, 4, 5))
        y, stats = self._stacked(p, st, x)
        ref_y, ref_st = nn.batchnorm_apply(tree_map(_t, p), tree_map(_t, st),
                                           _t(x), True)
        np.testing.assert_allclose(_np(y).reshape(x.shape), _np(ref_y),
                                   rtol=2e-5, atol=2e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(_np(stats[k][2]), _np(ref_st[k]),
                                       rtol=2e-5, atol=2e-5)

    def test_outside_a_world_is_local_bn(self):
        p, st, x = _bn_inputs(7)
        args = (tree_map(_t, p), tree_map(_t, st), _t(x), True)
        a, _ = nn.batchnorm_apply(*args, axis_name="dp")
        b, _ = nn.batchnorm_apply(*args)
        assert torch.equal(a, b)


class TestNorms:
    def test_rmsnorm(self):
        x = np.random.default_rng(0).standard_normal((3, 7, 16)).astype(
            np.float32)
        p = {"scale": np.linspace(0.5, 2, 16).astype(np.float32)}
        want = jnn.rmsnorm_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                 jnp.asarray(x))
        got = nn.rmsnorm_apply(tree_map(_t, p), _t(x))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        assert set(nn.rmsnorm_init(16)) == set(jnn.rmsnorm_init(16))

    def test_num_params_and_cast_floats(self):
        tree = {"a": torch.ones(3, 4), "b": {"c": torch.arange(5)}}
        assert nn.num_params(tree) == 17
        out = nn.cast_floats(tree, torch.bfloat16)
        assert out["a"].dtype == torch.bfloat16
        assert out["b"]["c"].dtype == torch.int64

    def test_he_normal_std(self):
        w = nn.he_normal(torch.Generator().manual_seed(0), (3, 3, 64, 64))
        assert abs(float(w.std()) - math.sqrt(2 / (9 * 64))) < 5e-3


# -- models -------------------------------------------------------------------

_X32 = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
_Y32 = np.array([1, 2])


def _init(tmodel, seed=0):
    """The port's random init on the CPU and the same trees as jnp
    arrays (the reference's eager init of ResNet-50 takes ~14 s)."""
    tp, ts = tmodel.init(torch.Generator().manual_seed(seed), device="cpu")
    np_p, np_s = interop.image_params_to_jax(tp, ts)
    return jax.tree_util.tree_map(jnp.asarray, (np_p, np_s))


def _reference_run(jmodel, tmodel, train, dtype=jnp.float32):
    """The reference's loss, new state and gradients, and its logits,
    from one jitted program."""
    jp, js = _init(tmodel)

    def f(p, s):
        loss, new_state = jmodel.loss(p, s, (_X32, _Y32), train=train,
                                      dtype=dtype)
        logits, _ = jmodel.apply(p, s, _X32, train=train, dtype=dtype)
        return loss, (new_state, logits)

    (loss, (new_state, logits)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(jp, js)
    return {"params": jp, "state": js, "loss": loss, "new_state": new_state,
            "grads": grads, "logits": logits}


def _port_run(model, ref, train, dtype=torch.float32):
    params, state = interop.image_params_from_jax(
        *jax.tree_util.tree_map(np.asarray, (ref["params"], ref["state"])),
        device="cpu")
    batch = (_t(_X32), _t(_Y32))
    loss, new_state, grads = _port_grads(
        lambda p: model.loss(p, state, batch, train=train, dtype=dtype),
        params)
    with torch.no_grad():
        logits, _ = model.apply(params, state, batch[0], train=train,
                                dtype=dtype)
    return {"params": params, "state": state, "loss": loss,
            "new_state": new_state, "grads": grads, "logits": logits}


MODELS = {
    "resnet50": (lambda: JResNet(50, num_classes=10, width=8),
                 lambda: ResNet(50, num_classes=10, width=8)),
    "vgg16_bn": (lambda: JVGG(16, 10, batch_norm=True, hidden=64),
                 lambda: VGG(16, 10, batch_norm=True, hidden=64)),
    "vgg16": (lambda: JVGG(16, 10, batch_norm=False, hidden=64),
              lambda: VGG(16, 10, batch_norm=False, hidden=64)),
}
#: (model, train mode) pairs held in full: logits, loss, state, grads
FULL = [("resnet50", False), ("vgg16_bn", True), ("vgg16_bn", False),
        ("vgg16", True)]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name, train):
        key = (name, train)
        if key not in cache:
            jmk, tmk = MODELS[name]
            ref = _reference_run(jmk(), tmk(), train)
            cache[key] = (ref, _port_run(tmk(), ref, train))
        return cache[key]

    return get


class TestModels:
    @pytest.mark.parametrize("name,train", FULL,
                             ids=[f"{n}-{'train' if t else 'eval'}"
                                  for n, t in FULL])
    def test_f32_parity(self, runs, name, train):
        ref, got = runs(name, train)
        assert _rel_l2(got["logits"], ref["logits"]) <= RTOL
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=RTOL)
        _assert_tree_close(got["new_state"], ref["new_state"], "state")
        _assert_grads(got["grads"], ref["grads"], f"{name} grads")

    def test_resnet_train_loss_and_early_stats(self, runs):
        """Train mode: the loss, and the running stats of every batch
        norm before stage 3 (see the module docstring)."""
        ref, got = runs("resnet50", True)
        _assert_close(got["loss"], ref["loss"], rtol=1e-3, what="loss")
        _assert_tree_close(got["new_state"], ref["new_state"], "state",
                           skip=("s3",))
        for k in ("mean", "var"):
            # the stem's stats move from their init in train mode
            assert not np.allclose(_np(got["new_state"]["stem_bn"][k]),
                                   np.asarray(ref["state"]["stem_bn"][k]))

    def test_resnet_bottleneck_train_gradient(self):
        """One bottleneck block (1x1, 3x3/s2, 1x1 and the projection, each
        with train-mode BN over 2 x 8 x 8 samples a channel): the port's
        ``resnet.bottleneck``, which ResNet.apply runs, against the same
        ops in the reference, gradients at 1e-4."""
        jp, js = _init(ResNet(50, num_classes=10, width=8), seed=1)
        blk, bst = jp["s1b0"], js["s1b0"]
        x = np.random.RandomState(2).randn(2, 16, 16, 32).astype(np.float32)

        def jblock(p, h):
            y = jnn.conv_apply(p["conv1"], h)
            y, _ = jnn.batchnorm_apply(p["bn1"], bst["bn1"], y, True)
            y = jax.nn.relu(y)
            y = jnn.conv_apply(p["conv2"], y, stride=2)
            y, _ = jnn.batchnorm_apply(p["bn2"], bst["bn2"], y, True)
            y = jax.nn.relu(y)
            y = jnn.conv_apply(p["conv3"], y)
            y, _ = jnn.batchnorm_apply(p["bn3"], bst["bn3"], y, True)
            s = jnn.conv_apply(p["proj"], h, stride=2)
            s, _ = jnn.batchnorm_apply(p["proj_bn"], bst["proj_bn"], s, True)
            return jnp.sum(jnp.sin(jax.nn.relu(y + s)))

        want = jax.grad(jblock)(blk, jnp.asarray(x))
        tblk, tbst = interop.image_params_from_jax(
            *jax.tree_util.tree_map(np.asarray, (blk, bst)), device="cpu")

        def tblock(p):
            y, _ = bottleneck(p, tbst, _t(x), stride=2, train=True,
                              dtype=torch.float32)
            return y.sin().sum(), None

        _, _, got = _port_grads(tblock, tblk)
        _assert_grads(got, want, "bottleneck")

    @pytest.mark.parametrize("name,train", [("resnet50", False),
                                            ("vgg16_bn", True)])
    def test_bf16_loss(self, runs, name, train):
        ref, got = runs(name, train)
        jm, tm = (mk() for mk in MODELS[name])
        want = jax.jit(lambda p, s: jm.loss(p, s, (_X32, _Y32), train=train,
                                            dtype=jnp.bfloat16)[0])(
            ref["params"], ref["state"])
        loss, _ = tm.loss(got["params"], got["state"],
                          (_t(_X32), _t(_Y32)), train=train,
                          dtype=torch.bfloat16)
        np.testing.assert_allclose(float(loss), float(want), rtol=BF16_RTOL)

    def test_stacked_sync_bn_resnet_equals_concatenated_batch(self):
        """ResNet.apply on a stacked [n, N, H, W, 3] batch with sync-BN
        over the ranks gives the one-device logits of the whole batch."""
        m = ResNet(50, num_classes=10, width=8)
        params, state = m.init(device="cpu")
        x = _t(np.random.RandomState(3).rand(4, 64, 64, 3).astype(np.float32))
        with torch.no_grad():
            whole, ws = m.apply(params, state, x, train=True,
                                dtype=torch.float32)
            with collective.rank_world([("dp", 2)]):
                got, gs = m.apply(params, state, x.reshape(2, 2, 64, 64, 3),
                                  train=True, dtype=torch.float32,
                                  axis_name="dp")
        np.testing.assert_allclose(_np(got).reshape(4, 10), _np(whole),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(_np(gs["stem_bn"]["var"][1]),
                                   _np(ws["stem_bn"]["var"]), rtol=2e-5,
                                   atol=2e-5)


class TestShapes:
    @pytest.mark.parametrize("depth,blocks", [(50, 16), (101, 33),
                                              (152, 50)])
    def test_block_counts(self, depth, blocks):
        pspec, _ = ResNet(depth, num_classes=10, width=8).param_spec()
        names = {p.split("/")[0] for p, _, _ in pspec}
        assert sum(1 for k in names if k[0] == "s" and k[1].isdigit()) \
            == blocks

    @pytest.mark.parametrize("name", ["resnet50", "vgg16"])
    def test_full_size_trees_equal_the_reference(self, name):
        """Keys and shapes from ``jax.eval_shape`` (no draw) against the
        port's spec (no draw)."""
        jm, tm = ((JResNet(50, 1000), resnet50()) if name == "resnet50"
                  else (JVGG(16, 1000), vgg16()))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        for jtree, spec in zip(shapes, tm.param_spec()):
            flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
                    for path, leaf in
                    jax.tree_util.tree_flatten_with_path(jtree)[0]}
            assert flat == {p: tuple(s) for p, s, _ in spec}
        n = sum(math.prod(s) for _, s, _ in tm.param_spec()[0])
        assert n == jnn.num_params(shapes[0])
        if name == "resnet50":
            assert 25.4e6 < n < 25.8e6

    def test_init_tree_matches_spec(self):
        m = VGG(11, num_classes=10, hidden=32)
        params, state = m.init(device="cpu")
        assert nn.num_params(params) == sum(
            math.prod(s) for _, s, _ in m.param_spec()[0])
        assert all(t.dtype == torch.float32 for t in tree_leaves(params))
        assert float(state["conv0_bn"]["var"].min()) == 1.0


class TestMLP:
    def test_slp_loss_and_grads(self):
        jm, tm = jmnist_slp(), mnist_slp()
        jp = jm.init(jax.random.PRNGKey(0))
        x = np.random.RandomState(0).rand(16, 28, 28).astype(np.float32)
        y = np.random.RandomState(1).randint(0, 10, 16)
        want_l, want_g = jax.value_and_grad(jm.loss)(jp, (x, y))
        tp, _ = interop.image_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), None, device="cpu")
        loss, _, grads = _port_grads(
            lambda p: (tm.loss(p, (_t(x), _t(y))), None), tp)
        np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-6)
        _assert_grads(grads, want_g, "slp", tol=1e-6)
        assert nn.num_params(tp) == 7850
        acc = float(tm.accuracy(tp, (_t(x), _t(y))))
        assert acc == pytest.approx(float(jm.accuracy(jp, (x, y))))

    def test_mlp_hidden(self):
        jm, tm = JMLP([32]), MLP([32])
        jp = jm.init(jax.random.PRNGKey(1))
        x = np.random.RandomState(2).rand(8, 784).astype(np.float32)
        tp, _ = interop.image_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), None, device="cpu")
        np.testing.assert_allclose(_np(tm.apply(tp, _t(x))),
                                   np.asarray(jm.apply(jp, x)), rtol=1e-5,
                                   atol=1e-6)
        assert set(tm.init(device="cpu")) == set(jp)


class TestFake:
    def test_names_and_sizes(self):
        assert fake.fake_model_names() == jfake.fake_model_names()
        for name in fake.fake_model_names():
            assert fake.fake_model_sizes(name) == jfake.fake_model_sizes(name)
            assert fake.total_params(name) == jfake.total_params(name)
        with pytest.raises(ValueError, match="unknown fake model"):
            fake.fake_model_sizes("nope")

    @pytest.mark.parametrize("stacked", [0, 3])
    def test_grads_bitwise(self, stacked):
        want = jfake.fake_grads("slp-mnist", stacked=stacked, seed=4)
        got = fake.fake_grads("slp-mnist", stacked=stacked, seed=4,
                              device="cpu")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(_np(g), w)

    def test_bf16_rounds_the_same_draw(self):
        import ml_dtypes

        want = jfake.fake_grads("slp-mnist", dtype=ml_dtypes.bfloat16)
        got = fake.fake_grads("slp-mnist", dtype=torch.bfloat16,
                              device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), w.view(np.int16))


class TestInterop:
    def test_round_trip_and_refusal(self):
        np_p, np_s = jax.tree_util.tree_map(np.asarray, _init(
            VGG(11, 10, hidden=16)))
        tp, ts = interop.image_params_from_jax(np_p, np_s, device="cpu")
        back_p, back_s = interop.image_params_to_jax(tp, ts)
        for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                        jax.tree_util.tree_leaves((np_p, np_s))):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="dtype"):
            interop.image_params_from_jax({"w": np.arange(3)}, None,
                                          device="cpu")


# -- dp_train_step with the BN aux --------------------------------------------

MOMENTUM = 0.9
#: (model, train mode, steps, lr).  ResNet in eval mode for three steps:
#: its train-mode gradient is ill-conditioned (module docstring), and at
#: eval its logits reach ~90, so lr 1e-4 (the update still moves every
#: leaf by ~1e-3 relative).  VGG-16-BN in train mode for one step: each
#: rank's BN aux moves and the step averages the four rows; after the
#: step the params carry a train-mode gradient of two images a rank, which
#: a 6e-8 perturbation moves by up to 1e-2 in either package, so the
#: params are checked replicated and moved, the loss and aux against the
#: reference.
DP_CASES = [("resnet50", False, 3, 1e-4), ("vgg16_bn", True, 1, 0.1)]


def _dp_batches(steps):
    rng = np.random.RandomState(7)
    return [(rng.rand(2 * N_RANKS, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, 2 * N_RANKS)) for _ in range(steps)]


@pytest.fixture(scope="module")
def dp_reference():
    """The reference's dp_train_step over four virtual devices (psum):
    params, BN state and loss after each step."""
    cache = {}

    def get(name, train, steps, lr):
        if name not in cache:
            jm = MODELS[name][0]()
            jp, js = _init(MODELS[name][1]())
            comm = JCommunicator(devices=jax.devices()[:N_RANKS],
                                 local_size=N_RANKS)
            tx = jsync(optax.sgd(lr, momentum=MOMENTUM), comm.axis)

            def loss_fn(p, s, b):
                return jm.loss(p, s, b, train=train, dtype=jnp.float32)

            step = jdp_train_step(loss_fn, tx, comm, has_aux=True)
            p, s, o = jp, js, tx.init(jp)
            out = []
            for b in _dp_batches(steps):
                p, s, o, loss = step(p, s, o, b)
                out.append(jax.tree_util.tree_map(np.asarray,
                                                  (p, s, float(loss))))
            cache[name] = (jax.tree_util.tree_map(np.asarray, (jp, js)), out)
        return cache[name]

    return get


class TestDPTrainStep:
    @pytest.mark.parametrize("schedule", ["psum", "pallas_ring"])
    @pytest.mark.parametrize("name,train,steps,lr", DP_CASES,
                             ids=[f"{c[0]}-{'train' if c[1] else 'eval'}"
                                  for c in DP_CASES])
    def test_steps(self, dp_reference, name, train, steps, lr, schedule):
        (jp, js), ref = dp_reference(name, train, steps, lr)
        model = MODELS[name][1]()
        params, state = interop.image_params_from_jax(jp, js, device="cpu")
        comm = Communicator(devices=["cpu"] * N_RANKS, local_size=N_RANKS)
        tx = synchronous_sgd(sgd(lr, momentum=MOMENTUM), comm.axis,
                             schedule=schedule)
        rows = []

        def loss_fn(p, s, b):
            loss, new = model.loss(p, s, b, train=train, dtype=torch.float32)
            rows.append(tree_map(lambda t: t.detach().clone(), new))
            return loss, new

        step = dp_train_step(loss_fn, tx, comm, has_aux=True)
        opt = tx.init(params)
        start = params
        for i, (b, (want_p, want_s, want_loss)) in enumerate(
                zip(_dp_batches(steps), ref)):
            rows.clear()
            collective.CHECK_REPLICAS = True
            try:
                params, state, opt, loss = step(params, state, opt,
                                                (_t(b[0]), _t(b[1])))
            finally:
                collective.CHECK_REPLICAS = False
            what = f"{schedule} step {i + 1}"
            np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5,
                                       err_msg=what)
            _assert_grads(state, want_s, f"BN state after {what}", tol=1e-5)
            # the aux is the mean of the four ranks' rows
            assert len(rows) == N_RANKS
            mean = tree_map(lambda *r: torch.stack(r).mean(0), *rows)
            _assert_grads(state, jax.tree_util.tree_map(np.asarray, tree_map(
                _np, mean)), f"aux mean after {what}", tol=1e-6)
            if not train:
                _assert_grads(params, want_p, f"params after {what}",
                              tol=1e-5)
        moved = [_rel_l2(a, b) for a, b in zip(tree_leaves(params),
                                               tree_leaves(start))]
        assert min(moved) > 1e-5
        assert all(t.dim() == s.dim() for t, s in
                   zip(tree_leaves(params), tree_leaves(start)))
        if train:
            assert not np.allclose(_np(state["conv0_bn"]["mean"]),
                                   js["conv0_bn"]["mean"])
