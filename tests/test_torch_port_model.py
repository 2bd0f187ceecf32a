"""Port parity: layers, the flagship transformer forward, the weight
converter and the cost model against the JAX reference.

The same numpy-seeded inputs and the same weights (carried across by
kungfu_tpu_torch.interop) go through the JAX function and its port on
the CPU.  JAX's flash kernel runs in interpret mode, as in
tests/test_pallas.py; the port's flash adapter takes its plain version
on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import nn as jnn
from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.ops import costmodel as jcost
from kungfu_tpu.ops.pallas import make_flash_attn as jax_make_flash_attn
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models import nn as tnn
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.ops import costmodel as tcost
from kungfu_tpu_torch.ops.cuda.attention import make_flash_attn

#: the reference's own tolerance for flash-vs-plain transformer logits in
#: f32 (tests/test_pallas.py:148-165)
APPLY_ATOL = 2e-3
#: single f32 layers: a few ulps of reassociation apart
LAYER_ATOL = 1e-5


def _cfg(pos="rope", causal=True, dtype="float32"):
    kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
              max_seq=32, causal=causal, pos=pos, dtype=dtype)
    return jtr.TransformerConfig(**kw), ttr.TransformerConfig(**kw)


def _jax_params(cfg, seed=0):
    return jtr.Transformer(cfg).init(jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rng(seed=0):
    return np.random.default_rng(seed)


class TestLayers:
    @pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
    def test_dense(self, dtype):
        rng = _rng(1)
        w = rng.normal(size=(16, 24)).astype(np.float32)
        b = rng.normal(size=(24,)).astype(np.float32)
        x = rng.normal(size=(3, 16)).astype(np.float32)
        jdt = jnp.dtype(dtype) if dtype else None
        tdt = getattr(torch, dtype) if dtype else None
        ref = jnn.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x, jdt or jnp.float32), dtype=jdt)
        got = tnn.dense_apply({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                              torch.from_numpy(x).to(tdt or torch.float32),
                              dtype=tdt)
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        atol = 5e-2 if dtype == "bfloat16" else LAYER_ATOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), atol=atol)

    def test_dense_promotes_like_jnp(self):
        """bf16 activations @ f32 head weights -> f32 logits, as the
        reference's LM head without a dtype."""
        w = torch.ones(4, 3)
        x = torch.ones(2, 4, dtype=torch.bfloat16)
        assert tnn.dense_apply({"w": w}, x).dtype == torch.float32

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_layernorm(self, dtype):
        rng = _rng(2)
        x = (rng.normal(size=(4, 32)) * 3 + 1).astype(np.float32)
        scale = rng.normal(size=(32,)).astype(np.float32)
        bias = rng.normal(size=(32,)).astype(np.float32)
        ref = jnn.layernorm_apply({"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)},
                                  jnp.asarray(x, jnp.dtype(dtype)))
        got = tnn.layernorm_apply({"scale": torch.from_numpy(scale),
                                   "bias": torch.from_numpy(bias)},
                                  torch.from_numpy(x).to(getattr(torch, dtype)))
        atol = 3e-2 if dtype == "bfloat16" else LAYER_ATOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), atol=atol)

    def test_embedding(self):
        rng = _rng(3)
        table = rng.normal(size=(50, 8)).astype(np.float32)
        ids = rng.integers(0, 50, size=(2, 7))
        ref = jnn.embedding_apply({"table": jnp.asarray(table)},
                                  jnp.asarray(ids, jnp.int32), dtype=jnp.bfloat16)
        got = tnn.embedding_apply({"table": torch.from_numpy(table)},
                                  torch.from_numpy(ids), dtype=torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))

    @pytest.mark.parametrize("dtype", [None, "bfloat16"])
    def test_embedding_out_of_range_ids(self, dtype):
        """``jnp.take``'s fill: ids in [-V, -1] wrap, ids outside [-V, V)
        give NaN rows; the port matches value for value and NaN for NaN."""
        table = _rng(10).normal(size=(50, 8)).astype(np.float32)
        ids = np.array([[-51, -50, -1, 0, 49], [50, 89, 7, -7, 1000]])
        jdt = jnp.dtype(dtype) if dtype else None
        tdt = getattr(torch, dtype) if dtype else None
        ref = np.asarray(jnn.embedding_apply(
            {"table": jnp.asarray(table)}, jnp.asarray(ids, jnp.int32),
            dtype=jdt), np.float32)
        got = tnn.embedding_apply({"table": torch.from_numpy(table)},
                                  torch.from_numpy(ids), dtype=tdt)
        np.testing.assert_array_equal(np.isnan(got.float().numpy()),
                                      np.isnan(ref))
        assert np.isnan(ref).any(axis=-1).sum() == 4
        np.testing.assert_array_equal(got.float().numpy(), ref)

    def test_embedding_out_of_range_gradient(self):
        """NaN rows take no part in the table's gradient."""
        table = torch.ones(6, 3, requires_grad=True)
        out = tnn.embedding_apply({"table": table}, torch.tensor([0, 9, -1]))
        torch.nansum(out).backward()
        np.testing.assert_array_equal(table.grad.sum(-1).numpy(),
                                      [3, 0, 0, 0, 0, 3])

    def test_transformer_out_of_vocab_id_gives_nan_rows(self):
        jcfg, tcfg = _cfg()
        jp = _jax_params(jcfg, seed=2)
        tp = interop.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        ids = _rng(11).integers(0, 64, size=(1, 8))
        ids[0, 5] = 70
        ref = np.asarray(jtr.Transformer(jcfg).apply(
            jp, jnp.asarray(ids, jnp.int32), attn_fn=jtr.default_attention))
        got = ttr.Transformer(tcfg).apply(
            tp, torch.from_numpy(ids), attn_fn=ttr.default_attention).numpy()
        # the NaN row reaches every position in both packages: its value
        # row meets the masked (zero) probabilities of earlier positions,
        # and 0 * NaN is NaN
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(got).all()

    def test_gelu_tanh(self):
        x = _rng(4).normal(size=(1000,)).astype(np.float32) * 4
        np.testing.assert_allclose(
            tnn.gelu(torch.from_numpy(x)).numpy(),
            np.asarray(jnn.gelu(jnp.asarray(x))), atol=LAYER_ATOL)

    def test_rope(self):
        rng = _rng(5)
        q = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
        k = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
        pos = np.stack([np.arange(10), np.arange(5, 15)])
        rq, rk = jtr._rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
        tq, tk = ttr._rope(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(tq.numpy(), np.asarray(rq), atol=LAYER_ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=LAYER_ATOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_default_attention(self, causal):
        arrs = [_rng(6 + i).normal(size=(2, 2, 24, 16)).astype(np.float32)
                for i in range(3)]
        ref = jtr.default_attention(*map(jnp.asarray, arrs), causal)
        got = ttr.default_attention(*map(torch.from_numpy, arrs), causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LAYER_ATOL)


class TestTransformerApply:
    @pytest.mark.parametrize("attn", ["flash", "default"])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("pos", ["rope", "learned"])
    def test_apply_matches_jax(self, pos, causal, attn):
        jcfg, tcfg = _cfg(pos=pos, causal=causal)
        jp = _jax_params(jcfg)
        tp = interop.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        ids = _rng(7).integers(0, 64, size=(2, 32))
        j_attn = jax_make_flash_attn() if attn == "flash" else jtr.default_attention
        t_attn = make_flash_attn() if attn == "flash" else ttr.default_attention
        ref = jtr.Transformer(jcfg).apply(jp, jnp.asarray(ids, jnp.int32),
                                          attn_fn=j_attn)
        got = ttr.Transformer(tcfg).apply(tp, torch.from_numpy(ids),
                                          attn_fn=t_attn)
        assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=APPLY_ATOL)

    def test_explicit_positions(self):
        jcfg, tcfg = _cfg()
        jp = _jax_params(jcfg, seed=1)
        tp = interop.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        ids = _rng(8).integers(0, 64, size=(1, 16))
        pos = np.arange(8, 24)[None]
        ref = jtr.Transformer(jcfg).apply(jp, jnp.asarray(ids, jnp.int32),
                                          attn_fn=jtr.default_attention,
                                          positions=jnp.asarray(pos))
        got = ttr.Transformer(tcfg).apply(tp, torch.from_numpy(ids),
                                          attn_fn=ttr.default_attention,
                                          positions=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=APPLY_ATOL)

    def test_pick_attention_knob(self, monkeypatch):
        monkeypatch.setenv("KF_TPU_ATTN", "xla")
        assert ttr.pick_attention() is ttr.default_attention
        monkeypatch.setenv("KF_TPU_ATTN", "bogus")
        with pytest.raises(ValueError):
            ttr.pick_attention()

    @pytest.mark.parametrize("mode", ["auto", "flash"])
    def test_pick_attention_flash_on_cpu_tensors(self, monkeypatch, mode):
        """``auto``/``flash`` give the flash adapter, whose CPU path is
        the kernel's plain version — the same logits as default."""
        monkeypatch.setenv("KF_TPU_ATTN", mode)
        _, tcfg = _cfg()
        model = ttr.Transformer(tcfg)
        tp = model.init(torch.Generator().manual_seed(3), device="cpu")
        ids = torch.from_numpy(_rng(9).integers(0, 64, size=(2, 32)))
        np.testing.assert_allclose(
            model.apply(tp, ids).numpy(),
            model.apply(tp, ids, attn_fn=ttr.default_attention).numpy(),
            atol=APPLY_ATOL)


class TestInitAndConverter:
    @pytest.mark.parametrize("pos", ["rope", "learned"])
    def test_init_tree_matches_jax_tree(self, pos):
        jcfg, tcfg = _cfg(pos=pos)
        jflat = ttr.flatten(_np_tree(_jax_params(jcfg)))
        tflat = ttr.flatten(ttr.Transformer(tcfg).init(device="cpu"))
        assert {k: tuple(v.shape) for k, v in jflat.items()} == \
            {k: tuple(v.shape) for k, v in tflat.items()}
        assert all(v.dtype == torch.float32 for v in tflat.values())

    def test_init_is_seeded(self):
        _, tcfg = _cfg()
        model = ttr.Transformer(tcfg)
        a = model.init(torch.Generator().manual_seed(5), device="cpu")
        b = model.init(torch.Generator().manual_seed(5), device="cpu")
        for k, t in ttr.flatten(a).items():
            assert torch.equal(t, ttr.flatten(b)[k]), k

    @pytest.mark.parametrize("pos", ["rope", "learned"])
    def test_round_trip_is_exact(self, pos):
        jcfg, tcfg = _cfg(pos=pos)
        tree = _np_tree(_jax_params(jcfg))
        back = interop.params_to_jax(
            interop.params_from_jax(tree, tcfg, device="cpu"))
        flat, flat_back = ttr.flatten(tree), ttr.flatten(back)
        assert flat.keys() == flat_back.keys()
        for k in flat:
            np.testing.assert_array_equal(flat[k], flat_back[k], err_msg=k)

    def test_missing_leaf_raises(self):
        jcfg, tcfg = _cfg()
        tree = _np_tree(_jax_params(jcfg))
        del tree["layer_1"]["wq"]["b"]
        with pytest.raises(ValueError, match="layer_1/wq/b"):
            interop.params_from_jax(tree, tcfg, device="cpu")

    def test_extra_leaf_raises(self):
        jcfg, tcfg = _cfg()
        tree = _np_tree(_jax_params(jcfg))
        tree["head"]["b"] = np.zeros(64, np.float32)
        with pytest.raises(ValueError, match="head/b"):
            interop.params_from_jax(tree, tcfg, device="cpu")

    def test_shape_mismatch_raises(self):
        jcfg, tcfg = _cfg()
        tree = _np_tree(_jax_params(jcfg))
        tree["head"]["w"] = np.zeros((64, 32), np.float32)
        with pytest.raises(ValueError, match="head/w"):
            interop.params_from_jax(tree, tcfg, device="cpu")


class TestCostModel:
    @pytest.mark.parametrize("pos", ["rope", "learned"])
    def test_flops_and_params_match_reference(self, pos):
        jcfg, tcfg = _cfg(pos=pos)
        assert tcost.transformer_param_count(tcfg) == \
            jcost.transformer_param_count(jcfg) == \
            sum(t.numel() for t in ttr.flatten(
                ttr.Transformer(tcfg).init(device="cpu")).values())
        assert tcost.forward_flops(tcfg, 4, 32) == jcost.forward_flops(jcfg, 4, 32)
        assert tcost.serve_prefill_flops(tcfg, 20, 16) == \
            jcost.serve_prefill_flops(jcfg, 20, 16)
        assert tcost.serve_decode_flops(tcfg, 77) == \
            jcost.serve_decode_flops(jcfg, 77)
        assert tcost.kv_bytes_per_token(tcfg) == jcost.kv_bytes_per_token(jcfg)

    def test_card_table_keeps_sxm_and_pcie_apart(self):
        sxm = tcost.card_spec("NVIDIA H100 80GB HBM3")
        pcie = tcost.card_spec("NVIDIA H100 PCIe")
        assert sxm["bf16_flops"] == 989e12 and pcie["bf16_flops"] == 756e12
        assert tcost.card_spec("NVIDIA A100-SXM4-80GB") is None

    def test_peak_env_overrides(self, monkeypatch):
        monkeypatch.setenv("KF_XRAY_PEAK_FLOPS", "123e12")
        assert tcost.chip_peak_flops() == 123e12
        monkeypatch.delenv("KF_XRAY_PEAK_FLOPS")
        assert tcost.chip_peak_flops("cpu") is None

    def test_meter_reports_rate(self):
        meter = tcost.MFUMeter(peak_flops=1e12)
        meter.add_flops(5e11)
        assert meter.step(wall_s=1.0) == pytest.approx(5e11)
        assert meter.mfu == pytest.approx(0.5)
