"""Port parity at every head width the JAX package runs.

The reference's Pallas flash kernels take the whole head dim as one
block, so any ``d_model / n_heads`` runs there.  The port's kernels are
compiled for 32, 64, 96, 128 and 256; on the card every other width up
to 256 runs zero-padded to the next of them, with the scale
``1/sqrt(D)`` of the unpadded width passed to the launchers
(``attention.kernel_head_dim``), and a wider head is refused.  Here, on
the CPU, the padded route runs through the kernels' plain versions with
the same explicit scale, which the card's kernels are held to by
chip_smoke.py: against the JAX flash forward and backward (Pallas in
interpret mode, ``KF_PALLAS_BWD=pallas`` as tests/test_pallas.py:84 sets
it), against the unpadded route, and inside a two-layer ``Transformer``
at head 80 and 256 against the JAX package through ``interop``.  The
C launchers' batch-head chunks are checked as a pure helper.  Inputs
come from numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.ops.pallas import make_flash_attn as jmake_flash
from kungfu_tpu.ops.pallas.attention import (
    flash_attention_with_lse as jax_flash_with_lse)
from kungfu_tpu.ops.pallas.xent import XENT_ENV as JXENT_ENV
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.ops.cuda import attention
from kungfu_tpu_torch.ops.cuda.attention import (
    COMPILED_HEAD_DIMS, MAX_GRID_Y, MAX_HEAD_DIM, bh_chunks, kernel_head_dim)
from kungfu_tpu_torch.ops.xent import XENT_ENV
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

#: the widths between (and at) the compiled ones that the tests cover:
#: the serving demo's 16, 48 (D = 64 kernels with a scale that is not a
#: power of two), Pythia-2.8B's 80, the compiled 96, 160 and 256
WIDTHS = (16, 48, 80, 96, 160, 256)

#: tests/test_torch_port_attention.py's tolerances: f32 forward against
#: the JAX kernel, bf16 O (rounded to bf16; P rounded against another
#: running max in the blocked JAX kernel), f32 gradients against the
#: Pallas backward in interpret mode
F32_ATOL = 2e-5
BF16_ATOL = 2e-2
GRAD_ATOL_PLAIN = 5e-4
#: bf16 gradients, as a share of the largest |gradient|: chip_smoke.py's
#: BF16_GRAD_RTOL for the kernels against the plain versions (both sides
#: round dO V^T's inputs, P and dS at other points)
BF16_GRAD_RTOL = 2e-2
#: padded against unpadded through the same plain versions: only the
#: f32 sums over the zero lanes' places differ
PAD_ATOL = 1e-6
#: loss and gradients of one f32 model step against the JAX package:
#: tests/test_torch_port_train.py's LOSS_ATOL and GRAD_ATOL
LOSS_ATOL = 2e-5
GRAD_ATOL = 2e-5


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _padded_pair(q, k, v, causal):
    """The card's route for a width of ``q``: zero-padded to the next
    compiled width with the unpadded width's scale, through the plain
    versions on these CPU tensors."""
    d = q.shape[-1]
    dp, _ = kernel_head_dim(d)
    return attention._flash_padded(q, k, v, causal, dp)


class TestWidthRule:
    def test_every_width_maps_to_the_narrowest_compiled_width(self):
        for d in range(1, MAX_HEAD_DIM + 1):
            dp, scale = kernel_head_dim(d)
            assert dp in COMPILED_HEAD_DIMS and dp >= d, d
            assert not [c for c in COMPILED_HEAD_DIMS if d <= c < dp], d
            assert scale == 1.0 / (d ** 0.5) and math.isclose(
                scale * math.sqrt(d), 1.0, rel_tol=1e-15), d
        assert all(kernel_head_dim(c)[0] == c for c in COMPILED_HEAD_DIMS)
        assert [kernel_head_dim(d)[0] for d in (16, 48, 80, 160)] == [
            32, 64, 96, 256]

    @pytest.mark.parametrize("d", [257, 0])
    def test_width_outside_the_range_raises(self, d):
        with pytest.raises(ValueError, match=f"head dim {d} .*256"):
            kernel_head_dim(d)


class TestBatchHeadChunks:
    @pytest.mark.parametrize("bh", [1, 65534, 65535, 65536, 70000,
                                    3 * 65535 + 1])
    def test_chunks_cover_the_batch_heads_in_order(self, bh):
        chunks = bh_chunks(bh)
        assert len(chunks) == -(-bh // MAX_GRID_Y)
        assert chunks[0][0] == 0
        for (b0, n), (b1, _) in zip(chunks, chunks[1:]):
            assert n == MAX_GRID_Y and b1 == b0 + n
        assert chunks[-1][0] + chunks[-1][1] == bh
        assert all(1 <= n <= MAX_GRID_Y for _, n in chunks)

    def test_small_limit(self):
        assert bh_chunks(7, limit=3) == [(0, 3), (3, 3), (6, 1)]


class TestPaddedRouteVersusJax:
    """The padded route with the explicit scale, through the plain
    versions, against the JAX flash forward and its Pallas backward."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("s", [7, 130])
    @pytest.mark.parametrize("d", WIDTHS)
    def test_matches_jax_flash(self, monkeypatch, d, s, causal, dtype):
        monkeypatch.setenv("KF_PALLAS_BWD", "pallas")
        q, k, v, do = _arrays((2, s, d), seed=1000 + d + s)
        dl = np.random.default_rng(d * s).normal(size=(2, s)).astype(
            np.float32)
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

        def jloss(q_, k_, v_):
            o, lse = jax_flash_with_lse(q_, k_, v_, causal=causal,
                                        interpret=True)
            return (jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))
                    + jnp.sum(lse * jnp.asarray(dl))), (o, lse)

        (_, (jo, jl)), jg = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(a, jdt) for a in (q, k, v)))
        ts = [torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (q, k, v)]
        o, lse = _padded_pair(*ts, causal)
        assert o.shape == (2, s, d) and o.dtype == tdt
        tg = torch.autograd.grad(
            (o, lse), ts, (torch.from_numpy(do).to(tdt), torch.from_numpy(dl)))
        atol = F32_ATOL if dtype == "float32" else BF16_ATOL
        np.testing.assert_allclose(o.detach().float().numpy(),
                                   np.asarray(jo, np.float32), atol=atol)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                                   atol=atol)
        for name, a, b in zip("qkv", tg, jg):
            ref = np.asarray(b, np.float32)
            gtol = (GRAD_ATOL_PLAIN if dtype == "float32"
                    else BF16_GRAD_RTOL * np.abs(ref).max())
            np.testing.assert_allclose(a.float().numpy(), ref, atol=gtol,
                                       err_msg=f"d{name}")


class TestPaddedRouteEqualsUnpadded:
    """Zero lanes change nothing: O, lse and the q/k/v gradients through
    the padded route equal the unpadded plain versions'."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("s", [7, 130])
    @pytest.mark.parametrize("d", WIDTHS)
    def test_padded_equals_unpadded(self, d, s, causal):
        q, k, v, do = (torch.from_numpy(a)
                       for a in _arrays((3, s, d), seed=2000 + d + s))
        dl = torch.from_numpy(np.random.default_rng(s + d).normal(
            size=(3, s)).astype(np.float32))

        def run(fn):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out, lse = fn(*ts)
            return [out.detach(), lse.detach(),
                    *torch.autograd.grad((out, lse), ts, (do, dl))]

        got = run(lambda *t: _padded_pair(*t, causal))
        want = run(lambda *t: attention._Flash.apply(*t, causal))
        for name, a, b in zip(("O", "lse", "dq", "dk", "dv"), got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PAD_ATOL,
                                       rtol=PAD_ATOL, err_msg=name)


@pytest.fixture
def plain_xent(monkeypatch):
    monkeypatch.setenv("KF_TPU_XENT", "plain")
    XENT_ENV.reload()
    JXENT_ENV.reload()
    yield
    monkeypatch.undo()
    XENT_ENV.reload()
    JXENT_ENV.reload()


def _padded_attn(q, k, v, causal):
    """The ``attn_fn`` of ``Transformer.apply`` through the padded route
    on ``[B, H, S, D]`` operands."""
    b, h, s, d = q.shape
    out = _padded_pair(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                       v.reshape(b * h, s, d), causal)[0]
    return out.reshape(b, h, s, d)


class TestTransformerAtWideAndOddHeads:
    """A two-layer f32 Transformer at head 80 (d_model 160, 2 heads) and
    256 (d_model 512, 2 heads): loss and gradients through the flash
    adapter's plain version and through the padded route, against the
    reference with its flash kernel in interpret mode."""

    @pytest.mark.parametrize("route", ["flash", "padded"])
    @pytest.mark.parametrize("d_model", [160, 512])
    def test_loss_and_grads_match_jax(self, plain_xent, d_model, route):
        kw = dict(vocab_size=64, d_model=d_model, n_layers=2, n_heads=2,
                  d_ff=2 * d_model, max_seq=32, causal=True, pos="rope",
                  dtype="float32")
        jcfg, tcfg = jtr.TransformerConfig(**kw), ttr.TransformerConfig(**kw)
        jmodel, tmodel = jtr.Transformer(jcfg), ttr.Transformer(tcfg)
        jp = jmodel.init(jax.random.PRNGKey(3))
        tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu")
        rng = np.random.default_rng(d_model)
        ids, tgt = (rng.integers(0, 64, size=(2, 24)) for _ in range(2))
        jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(
            p, (jnp.asarray(ids, jnp.int32), jnp.asarray(tgt, jnp.int32)),
            attn_fn=jmake_flash()))(jp)
        attn = (attention.make_flash_attn() if route == "flash"
                else _padded_attn)
        leaves, treedef = tree_flatten(tp)
        leaves = [t.requires_grad_(True) for t in leaves]
        tloss = tmodel.loss(tp, (torch.from_numpy(ids),
                                 torch.from_numpy(tgt)), attn_fn=attn)
        grads = tree_unflatten(treedef, torch.autograd.grad(tloss, leaves))
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   atol=LOSS_ATOL)
        tflat = ttr.flatten(grads)
        jflat = ttr.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
        assert tflat.keys() == jflat.keys()
        for name in tflat:
            np.testing.assert_allclose(tflat[name].numpy(), jflat[name],
                                       atol=GRAD_ATOL, err_msg=name)
