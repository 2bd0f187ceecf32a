"""Port parity: the flash-attention forward's plain version against the
JAX reference kernel.

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

from kungfu_tpu.ops.pallas import flash_attention as jax_flash
from kungfu_tpu.ops.pallas.attention import (
    flash_attention_with_lse as jax_flash_with_lse)
from kungfu_tpu_torch.ops.cuda import _build, attention
from kungfu_tpu_torch.ops.cuda.attention import (flash_attention,
                                                 flash_attention_reference,
                                                 flash_attention_with_lse,
                                                 make_flash_attn)

#: f32: the reference kernel's own tolerance against plain attention
#: (tests/test_pallas.py:26-55)
F32_ATOL = 2e-5
#: bf16: O is rounded to bf16 (8-bit mantissa, |O| < 4 here, so a half
#: ulp is <= 2^-7) and P is rounded against a different running max in
#: the blocked JAX kernel than in the one-pass plain version
BF16_ATOL = 2e-2


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
        flash_attention(*_port(_rand((1, 1, 64, 32))), causal=True)
        assert attention.launch_counts["flash_fwd"] == 0


class TestKernelContract:
    """What the CUDA wrapper refuses before it launches (the launch
    itself is checked on the card by chip_smoke.py)."""

    def test_unsupported_head_dim_raises(self):
        q = torch.zeros(2, 16, 48)
        with pytest.raises(ValueError, match="head dim 48"):
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
        with pytest.raises(NotImplementedError, match="training slice"):
            attention._FlashForward.backward(None, None, None)

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
