"""Port parity: the fused LM head (plain versions of the CUDA kernels) and
``Transformer.loss`` under ``KF_TPU_LM_HEAD=fused`` against the JAX
reference.

The JAX side runs ``kungfu_tpu.ops.pallas.lm_head.lm_head_nll`` as
tests/test_pallas.py:359-481 runs it on the CPU (Pallas in interpret
mode, the reference's block sizes); the port side takes the kernels'
plain versions on CPU tensors.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.  The
tolerances are the reference's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.ops.pallas.lm_head import _fwd_call as jfwd_call
from kungfu_tpu.ops.pallas.lm_head import lm_head_nll as jlm_head_nll
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.ops.cuda import lm_head as kernels
from kungfu_tpu_torch.ops.lm_head import lm_head_nll

#: tests/test_pallas.py:384-395 (f32) and :412-420 (bf16)
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 0.1, 5e-3


def _data(n, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    return h, w, t


def _jax(h, w, t, dtype=jnp.float32):
    """Loss and mean-loss gradients of the reference on the CPU."""
    jh, jw = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    jt = jnp.asarray(t, jnp.int32)

    def f(h, w):
        return jlm_head_nll(h, w, jt, block_n=8, block_v=128)

    loss = f(jh, jw)
    grads = jax.grad(lambda h, w: jnp.mean(f(h, w)), argnums=(0, 1))(jh, jw)
    return np.asarray(loss, np.float32), grads


def _port(h, w, t, dtype=torch.float32):
    th = torch.from_numpy(h).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    loss = lm_head_nll(th, tw, torch.from_numpy(t))
    grads = torch.autograd.grad(loss.mean(), (th, tw))
    return loss.detach(), grads


class TestLossAndGradsVersusJax:
    @pytest.mark.parametrize("shape", [(16, 32, 256), (20, 48, 300),
                                       (8, 128, 1000)])
    def test_f32(self, shape):
        h, w, t = _data(*shape, seed=1)
        jloss, jgrads = _jax(h, w, t)
        loss, grads = _port(h, w, t)
        assert loss.dtype == torch.float32 and loss.shape == (shape[0],)
        np.testing.assert_allclose(loss.numpy(), jloss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        for a, b in zip(grads, jgrads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)

    def test_bf16(self):
        h, w, t = _data(16, 64, 384, seed=2)
        jloss, jgrads = _jax(h, w, t, jnp.bfloat16)
        loss, grads = _port(h, w, t, torch.bfloat16)
        np.testing.assert_allclose(float(loss.mean()), float(jloss.mean()),
                                   rtol=BF16_LOSS_RTOL)
        assert grads[0].dtype == torch.bfloat16
        assert grads[1].dtype == torch.bfloat16
        for a, b in zip(grads, jgrads):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=BF16_GRAD_RTOL, atol=BF16_GRAD_ATOL)

    def test_bf16_features_f32_weights(self):
        """The flagship's mix: bf16 features against f32 head weights; the
        products are f32 in both, dh comes back bf16 and dW f32."""
        h, w, t = _data(24, 64, 300, seed=3)
        h = np.asarray(jnp.asarray(h, jnp.bfloat16), np.float32)
        jh, jw, jt = (jnp.asarray(h, jnp.bfloat16), jnp.asarray(w),
                      jnp.asarray(t))
        f = lambda a, b: jlm_head_nll(a, b, jt, block_n=8, block_v=128)  # noqa: E731
        jgrads = jax.grad(lambda a, b: jnp.mean(f(a, b)), argnums=(0, 1))(jh, jw)
        th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        loss = lm_head_nll(th, tw, torch.from_numpy(t))
        np.testing.assert_allclose(loss.detach().numpy(),
                                   np.asarray(f(jh, jw)), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        dh, dw = torch.autograd.grad(loss.mean(), (th, tw))
        assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
        np.testing.assert_allclose(dw.numpy(), np.asarray(jgrads[1]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        # both round an f32 sum to bf16 once: two ulps (2^-6) cover a
        # rounding flip where the sums straddle a boundary
        np.testing.assert_allclose(dh.float().numpy(),
                                   np.asarray(jgrads[0], np.float32),
                                   rtol=2 ** -6, atol=GRAD_ATOL)

    def test_leading_batch_dims(self):
        rng = np.random.default_rng(4)
        b, s, d, v = 2, 10, 32, 200
        h = rng.standard_normal((b, s, d)).astype(np.float32)
        w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
        t = rng.integers(0, v, (b, s)).astype(np.int32)
        ref = jlm_head_nll(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                           block_n=8, block_v=128)
        got = lm_head_nll(torch.from_numpy(h), torch.from_numpy(w),
                          torch.from_numpy(t))
        assert got.shape == (b, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)

    def test_out_of_vocab_targets(self):
        """A target outside [0, V) gives loss = lse and no onehot term in
        both packages.  (The reference pads V to its vocab block, and a
        target inside the padding picks the -1e30 mask value, a loss of
        1e30; the port has no padding, so those targets are left out.)"""
        h, w, t = _data(12, 32, 200, seed=5)
        t[:4] = [-1, 256, 350, -200]
        jloss, jgrads = _jax(h, w, t)
        loss, grads = _port(h, w, t)
        np.testing.assert_allclose(loss.numpy(), jloss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        _, lse = kernels.lm_head_forward_reference(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t))
        np.testing.assert_array_equal(loss.numpy()[:4], lse.numpy()[:4])
        for a, b in zip(grads, jgrads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)

    def test_lse_matches_jax(self):
        h, w, t = _data(20, 48, 300, seed=6)
        _, lse = kernels.lm_head_forward_reference(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t))
        _, jlse = jfwd_call(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                            8, 128, True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)


class TestModelPath:
    _KW = dict(vocab_size=128, d_model=32, n_layers=1, n_heads=2, d_ff=64,
               max_seq=16, dtype="float32")

    def _models(self, seed):
        jcfg, tcfg = (jtr.TransformerConfig(**self._KW),
                      ttr.TransformerConfig(**self._KW))
        jp = jtr.Transformer(jcfg).init(jax.random.PRNGKey(seed))
        tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu")
        return jtr.Transformer(jcfg), jp, ttr.Transformer(tcfg), tp

    def test_hidden_path_matches_apply(self):
        """Transformer.hidden + lm_head_nll == token_nll over apply's
        logits, in the port and against the reference's fused head."""
        jmodel, jp, model, tp = self._models(0)
        rng = np.random.default_rng(4)
        ids = rng.integers(0, 128, (2, 16))
        tgt = rng.integers(0, 128, (2, 16))
        attn = ttr.default_attention
        logits = model.apply(tp, torch.from_numpy(ids), attn_fn=attn)
        plain = -torch.log_softmax(logits, -1).gather(
            -1, torch.from_numpy(tgt)[..., None]).squeeze(-1)
        h = model.hidden(tp, torch.from_numpy(ids), attn_fn=attn)
        fused = lm_head_nll(h, tp["head"]["w"], torch.from_numpy(tgt))
        np.testing.assert_allclose(fused.detach().numpy(),
                                   plain.detach().numpy(), rtol=2e-5, atol=1e-5)
        jh = jmodel.hidden(jp, jnp.asarray(ids, jnp.int32),
                           attn_fn=jtr.default_attention)
        jfused = jlm_head_nll(jh, jp["head"]["w"], jnp.asarray(tgt, jnp.int32),
                              block_n=8, block_v=128)
        np.testing.assert_allclose(fused.detach().numpy(), np.asarray(jfused),
                                   rtol=2e-5, atol=1e-5)

    def test_loss_fused_matches_jax_fused(self, monkeypatch):
        monkeypatch.setenv("KF_TPU_LM_HEAD", "fused")
        jmodel, jp, model, tp = self._models(1)
        rng = np.random.default_rng(5)
        ids, tgt = (rng.integers(0, 128, (2, 16)) for _ in range(2))
        jloss = jmodel.loss(jp, (jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(tgt, jnp.int32)),
                            attn_fn=jtr.default_attention)
        loss = model.loss(tp, (torch.from_numpy(ids), torch.from_numpy(tgt)),
                          attn_fn=ttr.default_attention)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)


class TestKernelContract:
    def test_cpu_path_launches_no_kernel(self):
        kernels.reset_launch_counts()
        h, w, t = _data(8, 16, 64, seed=7)
        _port(h, w, t)
        assert kernels.launch_counts == {"lm_head_fwd": 0, "lm_head_bwd_dh": 0,
                                         "lm_head_bwd_dw": 0,
                                         "lm_head_split": 0}

    def test_block_sizes_are_ignored(self):
        h, w, t = (torch.from_numpy(a) for a in _data(9, 16, 70, seed=8))
        a = lm_head_nll(h, w, t)
        b = lm_head_nll(h, w, t, block_n=8, block_v=128)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("block_v", [1, 64, 2048])
    def test_plain_versions_do_not_depend_on_the_vocab_block(self, block_v):
        h, w, t = (torch.from_numpy(a) for a in _data(10, 24, 130, seed=9))
        g = torch.linspace(-1, 1, 10)
        loss, lse = kernels.lm_head_forward_reference(h, w, t)
        bl, blse = kernels.lm_head_forward_reference(h, w, t, block_v=block_v)
        np.testing.assert_allclose(bl.numpy(), loss.numpy(), rtol=1e-6)
        np.testing.assert_allclose(blse.numpy(), lse.numpy(), rtol=1e-6)
        ref = kernels.lm_head_backward_reference(h, w, t, lse, g)
        got = kernels.lm_head_backward_reference(h, w, t, lse, g,
                                                 block_v=block_v)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("h,w,t", [
        (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(8, 16),
         torch.zeros(4, dtype=torch.long)),
        (torch.zeros(4, 8), torch.zeros(7, 16), torch.zeros(4, dtype=torch.long)),
        (torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(3, dtype=torch.long)),
        (torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(4)),
        (torch.zeros(4, 8, device="meta"), torch.zeros(8, 16, device="meta"),
         torch.zeros(4, dtype=torch.long, device="meta")),
    ])
    def test_rejects_bad_operands(self, h, w, t):
        with pytest.raises(ValueError):
            kernels.forward(h, w, t)

    def test_targets_must_match_features(self):
        with pytest.raises(ValueError):
            lm_head_nll(torch.zeros(2, 3, 8), torch.zeros(8, 16),
                        torch.zeros(2, 4, dtype=torch.long))

    def test_auto_stays_plain(self, monkeypatch):
        """``auto`` is ``plain`` on every device here (the reference's
        budget is a TPU setting): Transformer.loss never reaches the
        fused head under it."""
        calls = []
        real = kernels.forward
        monkeypatch.setattr(kernels, "forward",
                            lambda *a: calls.append(1) or real(*a))
        model = ttr.Transformer(ttr.TransformerConfig(**TestModelPath._KW))
        tp = model.init(device="cpu")
        ids = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (1, 8)))
        for mode, fused in (("auto", False), ("plain", False), ("fused", True)):
            calls.clear()
            monkeypatch.setenv("KF_TPU_LM_HEAD", mode)
            model.loss(tp, (ids, ids), attn_fn=ttr.default_attention)
            assert bool(calls) == fused, mode


class TestSplitPlainVersion:
    """The plain version of the split kernel, which chip_smoke.py holds
    the kernel to bit for bit."""

    @pytest.mark.parametrize("d,v", [(24, 70), (203, 130), (768, 64)])
    def test_terms_and_pitch(self, d, v):
        rng = np.random.default_rng(d + v)
        w = torch.from_numpy((rng.standard_normal((d, v)) * 0.05)
                             .astype(np.float32))
        hi, lo = kernels.split_w_reference(w)
        ld = kernels.split_ld(d)
        assert ld % 8 == 0 and d <= ld < d + 8
        assert hi.shape == lo.shape == (v, ld)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi[:, :d], w.t().to(torch.bfloat16))
        assert not hi[:, d:].any() and not lo[:, d:].any()
        wt = w.t().double()
        got = hi[:, :d].double() + lo[:, :d].double()
        assert ((got - wt).abs() <= 2.0 ** -16 * wt.abs()).all()

    def test_bf16_weights_need_one_term(self):
        w = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (40, 33)).astype(np.float32)).to(torch.bfloat16)
        hi, lo = kernels.split_w_reference(w)
        assert lo is None and hi.shape == (33, 40)
        assert torch.equal(hi, w.t())


def _dw_split_emulation(h, w, t, lse, g):
    """dW as the wgmma kernel computes it: logits h W_hi + h W_lo (one
    product for a bf16 W), dl split into bf16 dl_hi and dl_lo, dW = hᵀ
    dl_hi + hᵀ dl_lo, every product f32, rounded once to W's dtype."""
    d, v = w.shape
    w_hi, w_lo = kernels.split_w_reference(w)
    hf = h.float()
    x = hf @ w_hi[:, :d].float().t()
    if w_lo is not None:
        x = x + hf @ w_lo[:, :d].float().t()
    cols = torch.arange(v)
    dl = (torch.exp(x - lse[:, None]) - (cols[None, :] == t.long()[:, None])
          .float()) * g[:, None]
    dl_hi = dl.to(torch.bfloat16).float()
    dl_lo = (dl - dl_hi).to(torch.bfloat16).float()
    return (hf.t() @ dl_hi + hf.t() @ dl_lo).to(w.dtype)


class TestSplitArithmetic:
    """The wgmma dW kernel's arithmetic, emulated on the CPU, against the
    reference's dW (Pallas in interpret mode) at chip_smoke.py's dW
    tolerances: ``rtol`` 1e-4 for f32 W (two bf16 ulps for bf16 W) plus
    1e-5 of max|dW|.  The flagship's statistics: bf16 h ~ N(0, 1), W ~
    0.05 N(0, 1), g ~ N(0, 1); ragged V, out-of-vocab targets."""

    @pytest.mark.parametrize("n,d,v,w_bf16", [
        (64, 96, 200, False), (48, 64, 130, False), (40, 128, 70, True),
        (72, 256, 1000, False)])
    def test_matches_jax_gradient(self, n, d, v, w_bf16):
        rng = np.random.default_rng(100 + n + d + v)
        h = np.asarray(jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16),
                       np.float32)
        w = (rng.standard_normal((d, v)) * 0.05).astype(np.float32)
        if w_bf16:
            w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
        t = rng.integers(0, v, n).astype(np.int32)
        t[:2] = [-1, 2 * v + 256]  # out of vocab, past the padded block
        g = rng.standard_normal(n).astype(np.float32)
        wdt = jnp.bfloat16 if w_bf16 else jnp.float32
        jh, jw = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, wdt)
        _, vjp = jax.vjp(lambda a, b: jlm_head_nll(a, b, jnp.asarray(t),
                                                   block_n=8, block_v=128),
                         jh, jw)
        ref = np.asarray(vjp(jnp.asarray(g))[1], np.float32)
        th = torch.from_numpy(h).to(torch.bfloat16)
        tw = torch.from_numpy(w).to(torch.bfloat16 if w_bf16
                                    else torch.float32)
        _, lse = kernels.lm_head_forward_reference(th, tw, torch.from_numpy(t))
        got = _dw_split_emulation(th, tw, torch.from_numpy(t), lse,
                                  torch.from_numpy(g))
        assert got.dtype == tw.dtype
        rtol = 2 ** -6 if w_bf16 else 1e-4
        atol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                   atol=atol)


def _logits_split_emulation(h, w):
    """The logits as the wgmma kernels take them: h W_hi + h W_lo (one
    product for a bf16 W), every product f32."""
    d = w.shape[0]
    w_hi, w_lo = kernels.split_w_reference(w)
    hf = h.float()
    x = hf @ w_hi[:, :d].float().t()
    if w_lo is not None:
        x = x + hf @ w_lo[:, :d].float().t()
    return x, w_hi[:, :d].float(), None if w_lo is None else w_lo[:, :d].float()


def _fwd_split_emulation(h, w, t):
    """Loss and lse as the wgmma forward computes them: the split logits,
    then the max, the sum of exponentials and the target logit in f32; a
    target outside [0, V) gives loss = lse."""
    x, _, _ = _logits_split_emulation(h, w)
    m = x.amax(dim=1)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(1).clamp_min(1e-30))
    cols = torch.arange(w.shape[1])
    tl = torch.where(cols[None, :] == t.long()[:, None], x, 0.0).sum(1)
    return lse - tl, lse


def _dh_split_emulation(h, w, t, lse, g):
    """dh as the wgmma dh kernel computes it, in f32 before its one
    rounding: the split logits, dl split into bf16 dl_hi and dl_lo, dh =
    dl_hi W_hi + dl_hi W_lo + dl_lo W_hi (dl_hi W + dl_lo W for a bf16
    W); the kernel leaves dl_lo W_lo out."""
    x, w_hi, w_lo = _logits_split_emulation(h, w)
    cols = torch.arange(w.shape[1])
    dl = (torch.exp(x - lse[:, None]) - (cols[None, :] == t.long()[:, None])
          .float()) * g[:, None]
    dl_hi = dl.to(torch.bfloat16).float()
    dl_lo = (dl - dl_hi).to(torch.bfloat16).float()
    dh = dl_hi @ w_hi + dl_lo @ w_hi
    if w_lo is not None:
        dh = dh + dl_hi @ w_lo
    return dh


#: TestSplitArithmetic's shapes, a ragged V past the 128-column vocab
#: tile of the forward, and the flagship's ratio of D to V at a small N
_SPLIT_SHAPES = [(64, 96, 200, False), (48, 64, 130, False),
                 (40, 128, 70, True), (72, 256, 1000, False),
                 (33, 200, 777, False), (24, 128, 517, True)]


class TestForwardAndDhSplitArithmetic:
    """The wgmma forward's and dh kernel's arithmetic, emulated on the
    CPU, against the reference's Pallas kernels in interpret mode at
    chip_smoke.py's tolerances: loss and lse ``rtol`` 2e-5, ``atol``
    1e-6; dh before its rounding against the f32 gradient, ``rtol`` 1e-4
    plus 1e-5 of max|dh|; dh rounded to bf16 (the kernel's output for
    bf16 h) against the reference's bf16 dh within two bf16 ulps
    (2^-6) plus the same share.  bf16 h ~ N(0, 1), W ~ 0.05 N(0, 1), g ~
    N(0, 1), out-of-vocab targets."""

    @staticmethod
    def _inputs(n, d, v, w_bf16):
        rng = np.random.default_rng(300 + n + d + v)
        h = np.asarray(jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16),
                       np.float32)
        w = (rng.standard_normal((d, v)) * 0.05).astype(np.float32)
        if w_bf16:
            w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
        t = rng.integers(0, v, n).astype(np.int32)
        t[:2] = [-1, 2 * v + 256]  # out of vocab, past the padded block
        g = rng.standard_normal(n).astype(np.float32)
        tw = torch.from_numpy(w).to(torch.bfloat16 if w_bf16 else torch.float32)
        return h, w, t, g, tw

    @pytest.mark.parametrize("kind", ["forward", "dh"])
    @pytest.mark.parametrize("n,d,v,w_bf16", _SPLIT_SHAPES)
    def test_matches_jax_kernels(self, kind, n, d, v, w_bf16):
        h, w, t, g, tw = self._inputs(n, d, v, w_bf16)
        wdt = jnp.bfloat16 if w_bf16 else jnp.float32
        th = torch.from_numpy(h).to(torch.bfloat16)
        tt = torch.from_numpy(t)
        if kind == "forward":
            jloss, jlse = jfwd_call(jnp.asarray(h, jnp.bfloat16),
                                    jnp.asarray(w, wdt), jnp.asarray(t), 8,
                                    128, True)
            loss, lse = _fwd_split_emulation(th, tw, tt)
            np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                                       rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                                       rtol=2e-5, atol=1e-6)
            np.testing.assert_array_equal(loss.numpy()[:2], lse.numpy()[:2])
            return
        _, lse = kernels.lm_head_forward_reference(th, tw, tt)
        dh = _dh_split_emulation(th, tw, tt, lse, torch.from_numpy(g))
        for hdt, got, rtol in ((jnp.float32, dh, 1e-4),
                               (jnp.bfloat16, dh.to(torch.bfloat16), 2 ** -6)):
            _, vjp = jax.vjp(lambda a, b: jlm_head_nll(a, b, jnp.asarray(t),
                                                       block_n=8, block_v=128),
                             jnp.asarray(h, hdt), jnp.asarray(w, wdt))
            ref = np.asarray(vjp(jnp.asarray(g))[0], np.float32)
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                       atol=1e-5 * np.abs(ref).max())


class TestSplitResidual:
    def test_lm_head_passes_the_forward_split_to_backward(self, monkeypatch):
        """``_LMHead`` keeps the forward's split of W and hands it to the
        backward, so a training step splits W once; on the CPU nothing
        launches."""
        kernels.reset_launch_counts()
        seen = {}
        real_fwd, real_bwd = kernels.forward, kernels.backward

        def forward(h, w, targets):
            loss, lse, _ = real_fwd(h, w, targets)
            seen["split"] = kernels.split_w_reference(w)
            return loss, lse, seen["split"]

        def backward(h, w, targets, lse, g, split=None):
            seen["backward_split"] = split
            return real_bwd(h, w, targets, lse, g, split)

        monkeypatch.setattr(kernels, "forward", forward)
        monkeypatch.setattr(kernels, "backward", backward)
        h, w, t = _data(10, 24, 130, seed=12)
        loss, grads = _port(h, w, t)
        hi, lo = seen["backward_split"]
        assert hi is seen["split"][0] and lo is seen["split"][1]
        ref_loss, ref_grads = _jax(h, w, t)
        np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        for a, b in zip(grads, ref_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        assert set(kernels.launch_counts.values()) == {0}

    def test_cpu_forward_keeps_no_split(self):
        h, w, t = (torch.from_numpy(a) for a in _data(6, 16, 40, seed=13))
        loss, lse, split = kernels.forward(h, w, t)
        assert split is None
        ref_loss, ref_lse = kernels.lm_head_forward_reference(h, w, t)
        assert torch.equal(loss, ref_loss) and torch.equal(lse, ref_lse)

    @pytest.mark.parametrize("case", ["shape", "dtype", "lo_for_bf16_w",
                                      "no_lo_for_f32_w", "lo_shape"])
    def test_a_split_that_does_not_match_w_is_refused(self, case):
        w = torch.zeros(20, 36)
        hi, lo = kernels.split_w_reference(w)
        split = {"shape": (hi[:, :16], lo), "dtype": (hi.float(), lo),
                 "lo_for_bf16_w": (hi, lo), "no_lo_for_f32_w": (hi, None),
                 "lo_shape": (hi, lo[:-1])}[case]
        if case == "lo_for_bf16_w":
            w = w.to(torch.bfloat16)
        with pytest.raises(ValueError):
            kernels._split_for(w, split)
        got = kernels._split_for(w.float(), (hi, lo))
        assert got[0] is hi and got[1] is lo
