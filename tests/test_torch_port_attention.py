"""Port parity: the flash-attention forward and backward plain versions
against the JAX reference kernels.

The JAX side runs as tests/test_pallas.py runs it on the CPU (Pallas in
interpret mode); the port side runs on ``device="cpu"``, where the
wrapper takes the kernel's plain version.  The CUDA kernel itself is
held against the same plain version on the card by chip_smoke.py.
Inputs come from numpy seeds and reach both frameworks as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from kungfu_tpu.models.transformer import default_attention as jax_default
from kungfu_tpu.ops.pallas import flash_attention as jax_flash
from kungfu_tpu.ops.pallas.attention import _bwd_blocked as jax_bwd_blocked
from kungfu_tpu.ops.pallas.attention import (
    flash_attention_with_lse as jax_flash_with_lse)
from kungfu_tpu_torch.models.transformer import default_attention
from kungfu_tpu_torch.ops.cuda import _build, attention
from kungfu_tpu_torch.ops.cuda.attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_reference,
    flash_attention_with_lse, make_flash_attn)

#: f32: the reference kernel's own tolerance against plain attention
#: (tests/test_pallas.py:26-55)
F32_ATOL = 2e-5
#: bf16: O is rounded to bf16 (8-bit mantissa, |O| < 4 here, so a half
#: ulp is <= 2^-7) and P is rounded against a different running max in
#: the blocked JAX kernel than in the one-pass plain version
BF16_ATOL = 2e-2
#: gradients, f32: the reference's tolerances (tests/test_pallas.py:61-145)
#: against autograd through plain attention, and between two blocked or
#: kernel backwards on the same saved (out, lse)
GRAD_ATOL_PLAIN = 5e-4
GRAD_ATOL_BLOCKED = 2e-4


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _port(arrs, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


def _jax(arrs, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrs)


class TestPlainVersusJaxKernel:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax_flash(self, causal):
        arrs = _rand((2, 2, 256, 32))
        ref = jax_flash(*_jax(arrs), causal=causal, interpret=True)
        got = flash_attention(*_port(arrs), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_ragged_seq_len(self, causal):
        arrs = _rand((1, 2, 200, 32), seed=1)
        ref = jax_flash(*_jax(arrs), causal=causal, interpret=True)
        got = flash_attention(*_port(arrs), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)

    def test_small_blocks(self):
        arrs = _rand((1, 1, 128, 16), seed=2)
        ref = jax_flash(*_jax(arrs), causal=True, block_q=32, block_k=64,
                        interpret=True)
        got = flash_attention(*_port(arrs), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)

    def test_three_dim_input_equals_four_dim(self):
        arrs = _rand((1, 3, 128, 16), seed=3)
        q, k, v = _port(arrs)
        got3 = flash_attention(q.reshape(3, 128, 16), k.reshape(3, 128, 16),
                               v.reshape(3, 128, 16), causal=True)
        got4 = flash_attention(q, k, v, causal=True)
        np.testing.assert_allclose(got3.numpy(),
                                   got4.reshape(3, 128, 16).numpy(), atol=1e-6)
        ref = jax_flash(*_jax(tuple(a.reshape(3, 128, 16) for a in arrs)),
                        causal=True, interpret=True)
        np.testing.assert_allclose(got3.numpy(), np.asarray(ref), atol=F32_ATOL)

    @pytest.mark.parametrize("causal,s", [(True, 256), (False, 256),
                                          (True, 200)])
    def test_with_lse_matches_jax(self, causal, s):
        arrs = _rand((3, s, 32), seed=4)
        ref_o, ref_lse = jax_flash_with_lse(*_jax(arrs), causal=causal,
                                            interpret=True)
        got_o, got_lse = flash_attention_with_lse(*_port(arrs), causal=causal)
        assert got_lse.dtype == torch.float32 and got_lse.shape == (3, s)
        np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o),
                                   atol=F32_ATOL)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(ref_lse),
                                   atol=F32_ATOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_bf16_matches_jax(self, causal):
        arrs = _rand((2, 2, 128, 64), seed=5)
        ref = jax_flash(*_jax(arrs, jnp.bfloat16), causal=causal,
                        interpret=True)
        got = flash_attention(*_port(arrs, torch.bfloat16), causal=causal)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), atol=BF16_ATOL)

    def test_adapter_slot(self):
        arrs = _rand((1, 2, 64, 32), seed=6)
        got = make_flash_attn()(*_port(arrs), True)
        ref = jax_flash(*_jax(arrs), causal=True, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)


def _jax_grads(arrs, causal, with_lse, cot):
    """JAX gradients of ``sum(O * dO) (+ sum(lse * dlse))``."""
    do = jnp.asarray(cot[0])

    if with_lse:
        dl = jnp.asarray(cot[1])

        def loss(q, k, v):
            o, lse = jax_flash_with_lse(q, k, v, causal=causal, interpret=True)
            return jnp.sum(o * do) + jnp.sum(lse * dl)
    else:
        def loss(q, k, v):
            return jnp.sum(jax_flash(q, k, v, causal=causal,
                                     interpret=True) * do)

    return jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrs))


def _port_grads(arrs, causal, with_lse, cot):
    q, k, v = (t.requires_grad_(True) for t in _port(arrs))
    if with_lse:
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        outs, cots = (o, lse), (torch.from_numpy(cot[0]),
                                torch.from_numpy(cot[1]))
    else:
        outs = (flash_attention(q, k, v, causal=causal),)
        cots = (torch.from_numpy(cot[0]),)
    return torch.autograd.grad(outs, (q, k, v), cots)


class TestBackwardVersusJax:
    """The port's CPU backward (the blocked plain version) against the
    JAX flash gradients, through its blocked backward and through its
    Pallas backward kernels in interpret mode (``KF_PALLAS_BWD=pallas``,
    as tests/test_pallas.py:84 sets it)."""

    @pytest.mark.parametrize("bwd,with_lse", [("blocked", False),
                                              ("blocked", True),
                                              ("pallas", True)])
    @pytest.mark.parametrize("causal,s", [(True, 128), (False, 96),
                                          (True, 100)])
    def test_grads_match_jax(self, monkeypatch, bwd, with_lse, causal, s):
        if bwd == "pallas":
            monkeypatch.setenv("KF_PALLAS_BWD", "pallas")
        arrs = _rand((2, s, 32), seed=10)
        rng = np.random.default_rng(11)
        cot = (rng.normal(size=(2, s, 32)).astype(np.float32),
               rng.normal(size=(2, s)).astype(np.float32))
        ref = _jax_grads(arrs, causal, with_lse, cot)
        got = _port_grads(arrs, causal, with_lse, cot)
        atol = GRAD_ATOL_BLOCKED if bwd == "blocked" else GRAD_ATOL_PLAIN
        for name, a, b in zip("qkv", got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                       err_msg=f"d{name}")

    def test_four_dim_grads_match_plain_attention(self):
        """dq/dk/dv of sum(O^2) through the 4-D adapter against autograd
        through plain attention, in both packages."""
        arrs = _rand((1, 2, 80, 32), seed=12)
        q, k, v = (t.requires_grad_(True) for t in _port(arrs))
        got = torch.autograd.grad(
            (flash_attention(q, k, v, causal=True) ** 2).sum(), (q, k, v))
        q2, k2, v2 = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        plain = torch.autograd.grad(
            (default_attention(q2, k2, v2, True) ** 2).sum(), (q2, k2, v2))
        ref = jax.grad(lambda *a: jnp.sum(jax_default(*a, True) ** 2),
                       argnums=(0, 1, 2))(*_jax(arrs))
        for name, a, b, c in zip("qkv", got, plain, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=GRAD_ATOL_PLAIN, err_msg=name)
            np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                       atol=GRAD_ATOL_PLAIN, err_msg=name)

    @pytest.mark.parametrize("causal", [True, False])
    def test_blocked_plain_version_matches_jax_blocked(self, causal):
        """The two blocked backwards on the same saved (out, lse), with a
        ragged last block (S=200 against 64-wide blocks)."""
        rng = np.random.default_rng(13)
        q, k, v, do = (rng.normal(size=(2, 200, 32)).astype(np.float32)
                       for _ in range(4))
        tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
        out, lse = flash_attention_reference(tq, tk, tv, causal)
        got = flash_attention_backward_reference(tq, tk, tv, out, lse, tdo,
                                                 causal, block_k=64)
        ref = jax_bwd_blocked(*map(jnp.asarray, (q, k, v, out.numpy(),
                                                 lse.numpy(), do)),
                              causal, 128)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=GRAD_ATOL_BLOCKED, err_msg=name)


class TestDifferentiableLse:
    """The lse output carries its cotangent into the backward as
    ``delta -= dlse`` (the reference's ``_flash_pair_bwd``)."""

    def test_autograd_function_grads_through_both_outputs(self):
        q, k, v = (t.requires_grad_(True)
                   for t in _port(_rand((2, 48, 32), seed=14)))
        rng = np.random.default_rng(15)
        do = torch.from_numpy(rng.normal(size=(2, 48, 32)).astype(np.float32))
        dl = torch.from_numpy(rng.normal(size=(2, 48)).astype(np.float32))
        out, lse = attention._Flash.apply(q, k, v, True)
        got = torch.autograd.grad((out, lse), (q, k, v), (do, dl))
        o2, l2 = flash_attention_reference(q, k, v, True)
        want = torch.autograd.grad((o2, l2), (q, k, v), (do, dl))
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=GRAD_ATOL_BLOCKED, err_msg=name)

    def test_dlse_shifts_delta(self):
        q, k, v, do = _port(_rand((1, 32, 32), seed=16) + (
            np.random.default_rng(17).normal(size=(1, 32, 32)).astype(
                np.float32),))
        out, lse = flash_attention_reference(q, k, v, True)
        dl = torch.full((1, 32), 0.5)
        got = flash_attention_backward(q, k, v, out, lse, do, dl, True)
        delta = (do * out).sum(-1) - dl
        want = flash_attention_backward_reference(q, k, v, out, lse, do, True,
                                                  delta=delta)
        without = flash_attention_backward(q, k, v, out, lse, do, None, True)
        for a, b, c in zip(got, want, without):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not torch.allclose(got[0], without[0])


class TestPlainVersionSemantics:
    def test_lse_is_logsumexp_of_scaled_scores(self):
        q, k, v = _port(_rand((2, 40, 32), seed=7))
        _, lse = flash_attention_reference(q, k, v, causal=True)
        logits = (q @ k.transpose(-1, -2)) / 32 ** 0.5
        mask = torch.ones(40, 40, dtype=torch.bool).tril()
        want = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
        np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)

    def test_cpu_path_launches_no_kernel(self):
        attention.reset_launch_counts()
        q, k, v = (t.requires_grad_(True)
                   for t in _port(_rand((1, 1, 64, 32))))
        flash_attention(q, k, v, causal=True).sum().backward()
        assert attention.launch_counts == {
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


class TestKernelContract:
    """What the CUDA wrapper refuses before it launches (the launch
    itself is checked on the card by chip_smoke.py)."""

    def test_unsupported_head_dim_raises(self):
        """A head wider than 256 is refused on the card (ROADMAP C47):
        every width up to 256 runs, padded to a compiled one, and nothing
        falls back to a plain version."""
        q = torch.zeros(2, 16, 257)
        with pytest.raises(ValueError, match="head dim 257 .*256"):
            attention._check(q, q, q)

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
    def test_unsupported_dtype_raises(self, dtype):
        q = torch.zeros(2, 16, 64, dtype=dtype)
        with pytest.raises(ValueError):
            attention._check(q, q, q)

    def test_mismatched_shapes_raise(self):
        with pytest.raises(ValueError):
            attention._check(torch.zeros(2, 16, 64), torch.zeros(2, 8, 64),
                             torch.zeros(2, 16, 64))

    def test_backward_raises_not_implemented(self):
        """The backward is ported (kernels on CUDA, the blocked plain
        version on the CPU); what stays unimplemented, as for the
        reference's ``custom_vjp``, is forward-mode differentiation."""
        q, k, v = (t.requires_grad_(True)
                   for t in _port(_rand((1, 16, 32), seed=8)))
        out, lse = flash_attention_with_lse(q, k, v)
        assert out.grad_fn is not None and lse.grad_fn is not None
        with pytest.raises(NotImplementedError):
            attention._Flash.jvp(None, None, None, None, None)

    def test_non_cpu_non_cuda_device_raises(self):
        q = torch.zeros(1, 16, 64, device="meta")
        with pytest.raises(ValueError):
            flash_attention_with_lse(q, q, q)


class TestBuildKey:
    def test_edited_source_changes_the_build_key(self, tmp_path):
        src = tmp_path / "k.cu"
        src.write_text("extern \"C\" int f() { return 0; }\n")
        a = _build._source_key(src, "nvcc")
        assert a == _build._source_key(src, "nvcc")
        src.write_text("extern \"C\" int f() { return 1; }\n")
        assert _build._source_key(src, "nvcc") != a

    def test_flags_target_sm90a(self):
        assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
