"""Port parity: fused softmax cross-entropy (plain versions of the Triton
kernels) and its routing against the JAX reference.

The JAX side runs as tests/test_pallas.py runs it on the CPU (Pallas in
interpret mode; the backward through the blocked jnp version, or through
the Pallas kernel with ``KF_PALLAS_BWD=pallas``); the port side takes the
kernels' plain versions on CPU tensors.  The Triton kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.ops.pallas import xent as jxent
from kungfu_tpu_torch.ops import xent as txent
from kungfu_tpu_torch.ops.triton import xent as kernels

#: loss: the reference kernel's tolerances against -log_softmax[target]
#: (tests/test_pallas.py:181-225), f32 and bf16 logits
LOSS_ATOL_F32 = 1e-4
LOSS_ATOL_BF16 = 1e-3
#: dlogits of the mean loss: the reference's autograd tolerance
DLOGITS_ATOL = 1e-6


@pytest.fixture
def knobs(monkeypatch):
    """Set routing env vars for one test; both sides re-read them, and
    the port's knobs are re-read once the environment is restored."""
    def set_env(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        txent.XENT_ENV.reload()
        jxent.XENT_ENV.reload()

    yield set_env
    monkeypatch.undo()
    txent.XENT_ENV.reload()


def _data(n=37, v=1000, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, v)) * 3).astype(np.float32)
    targets = rng.integers(0, v, size=(n,))
    return logits, targets


def _jax_loss(logits, targets, dtype=jnp.float32):
    return jxent.softmax_cross_entropy(jnp.asarray(logits, dtype),
                                       jnp.asarray(targets, jnp.int32),
                                       interpret=True)


class TestForwardVersusJax:
    @pytest.mark.parametrize("n,v", [(37, 1000), (64, 512), (5, 130)])
    def test_f32(self, n, v):
        logits, targets = _data(n, v)
        ref = _jax_loss(logits, targets)
        got = txent.softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(targets))
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOSS_ATOL_F32)

    def test_bf16(self):
        logits, targets = _data(48, 512, seed=1)
        ref = _jax_loss(logits, targets, jnp.bfloat16)
        got = txent.softmax_cross_entropy(
            torch.from_numpy(logits).to(torch.bfloat16),
            torch.from_numpy(targets))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                                   atol=LOSS_ATOL_BF16)

    def test_leading_dims(self):
        logits, targets = _data(2 * 16, 300, seed=2)
        logits, targets = logits.reshape(2, 16, 300), targets.reshape(2, 16)
        ref = _jax_loss(logits, targets)
        got = txent.softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(targets))
        assert got.shape == (2, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOSS_ATOL_F32)

    def test_lse_is_logsumexp(self):
        logits, targets = _data(9, 200, seed=3)
        _, lse = kernels.xent_forward_reference(torch.from_numpy(logits),
                                                torch.from_numpy(targets))
        _, jlse = jxent._fwd_call(jnp.asarray(logits),
                                  jnp.asarray(targets, jnp.int32), 8, 128, True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5)


class TestBackwardVersusJax:
    @pytest.mark.parametrize("bwd", ["blocked", "pallas"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dlogits(self, monkeypatch, bwd, dtype):
        if bwd == "pallas":
            monkeypatch.setenv("KF_PALLAS_BWD", "pallas")
        logits, targets = _data(40, 700, seed=4)
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        jt = jnp.asarray(targets, jnp.int32)
        ref = jax.grad(lambda x: jnp.mean(jxent.softmax_cross_entropy(
            x, jt, interpret=True)))(jnp.asarray(logits, jdt))
        x = torch.from_numpy(logits).to(tdt).requires_grad_(True)
        txent.softmax_cross_entropy(x, torch.from_numpy(targets)).mean(
            ).backward()
        assert x.grad.dtype == tdt
        # bf16: both round (softmax - onehot) / N to bf16 from f32 values
        # that agree to f32 rounding; one bf16 ulp of |d| <= 1/N apart
        atol = DLOGITS_ATOL if dtype == "float32" else 2 ** -8 / 40
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   np.asarray(ref, np.float32), atol=atol)

    def test_blocked_plain_version_matches_jax_blocked(self):
        logits, targets = _data(16, 1000, seed=5)
        g = np.random.default_rng(6).normal(size=(16,)).astype(np.float32)
        x, t = torch.from_numpy(logits), torch.from_numpy(targets)
        _, lse = kernels.xent_forward_reference(x, t)
        got = kernels.xent_backward_reference(x, t, lse, torch.from_numpy(g),
                                              block_v=256)
        ref = jxent._bwd_blocked(jnp.asarray(logits), jnp.asarray(targets),
                                 jnp.asarray(lse.numpy()), jnp.asarray(g), 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


class TestTokenNllRouting:
    @pytest.mark.parametrize("mode", ["plain", "xla", "auto", "fused"])
    def test_modes_match_jax(self, knobs, mode):
        knobs(KF_TPU_XENT=mode)
        logits, targets = _data(2 * 24, 500, seed=7)
        logits, targets = logits.reshape(2, 24, 500), targets.reshape(2, 24)
        ref = jxent.token_nll(jnp.asarray(logits),
                              jnp.asarray(targets, jnp.int32))
        got = txent.token_nll(torch.from_numpy(logits),
                              torch.from_numpy(targets))
        np.testing.assert_allclose(float(got), float(ref), atol=LOSS_ATOL_F32)

    @pytest.mark.parametrize("mode,fused", [("fused", True), ("plain", False),
                                            ("xla", False), ("auto", False)])
    def test_fused_only_when_asked(self, knobs, monkeypatch, mode, fused):
        """``auto`` stays ``plain`` (no H100 crossover yet); only
        ``fused`` reaches the kernels' dispatch."""
        knobs(KF_TPU_XENT=mode)
        calls = []
        real = kernels.forward
        monkeypatch.setattr(kernels, "forward",
                            lambda *a: calls.append(1) or real(*a))
        logits, targets = _data(8, 64, seed=8)
        txent.token_nll(torch.from_numpy(logits), torch.from_numpy(targets))
        assert bool(calls) == fused

    def test_bad_mode_fails_loudly(self, knobs):
        with pytest.raises(ValueError, match="KF_TPU_XENT"):
            knobs(KF_TPU_XENT="bogus")

    def test_xla_alias(self, knobs):
        knobs(KF_TPU_XENT="xla")
        assert txent.XENT_ENV.mode == "plain"

    def test_mode_is_read_at_reload_only(self, monkeypatch, knobs):
        knobs(KF_TPU_XENT="fused")
        monkeypatch.setenv("KF_TPU_XENT", "plain")
        assert txent.XENT_ENV.mode == "fused"
        assert txent.XENT_ENV.reload().mode == "plain"


class TestOutOfVocabTargets:
    """A target outside [0, V): the kernels (Pallas and Triton) and their
    plain versions give loss = lse; the plain ``token_nll`` picks the
    target as ``take_along_axis`` does (wrap [-V, -1], NaN outside
    [-V, V)).  The reference pads V to its vocab block, and a target
    inside the padding picks the -1e30 mask value (a loss of 1e30); the
    port has no padding, so those targets are left out."""

    TARGETS = np.array([-1, 300, 0, 129, -130, 7, -131, 500])

    def test_forward_gives_lse(self):
        logits, _ = _data(8, 130, seed=9)
        x, t = torch.from_numpy(logits), torch.from_numpy(self.TARGETS)
        loss, lse = kernels.xent_forward_reference(x, t)
        jloss, jlse = jxent._fwd_call(jnp.asarray(logits),
                                      jnp.asarray(self.TARGETS, jnp.int32),
                                      8, 128, True)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                                   atol=LOSS_ATOL_F32)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5)
        out = ~((self.TARGETS >= 0) & (self.TARGETS < 130))
        np.testing.assert_array_equal(loss.numpy()[out], lse.numpy()[out])

    def test_backward_has_no_onehot_term(self):
        logits, _ = _data(8, 130, seed=10)
        g = np.full(8, 0.5, np.float32)
        x, t = torch.from_numpy(logits), torch.from_numpy(self.TARGETS)
        _, lse = kernels.xent_forward_reference(x, t)
        got = kernels.xent_backward_reference(x, t, lse, torch.from_numpy(g))
        ref = jxent._bwd_blocked(jnp.asarray(logits),
                                 jnp.asarray(self.TARGETS, jnp.int32),
                                 jnp.asarray(lse.numpy()), jnp.asarray(g), 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)

    @pytest.mark.parametrize("rows,nan", [(slice(0, 8), True),
                                          (slice(4, 6), False),
                                          (slice(0, 1), False)])
    def test_plain_token_nll_matches_take_along_axis(self, knobs, rows, nan):
        knobs(KF_TPU_XENT="plain")
        logits, _ = _data(8, 130, seed=11)
        logits, targets = logits[rows], self.TARGETS[rows]
        ref = float(jxent.token_nll(jnp.asarray(logits),
                                    jnp.asarray(targets, jnp.int32)))
        got = float(txent.token_nll(torch.from_numpy(logits),
                                    torch.from_numpy(targets)))
        assert np.isnan(got) == np.isnan(ref) == nan
        if not nan:
            np.testing.assert_allclose(got, ref, atol=LOSS_ATOL_F32)


class TestShapeRouting:
    SHAPES = [(8192, 32128, 4, True), (8192, 32128, 2, True),
              (1024, 1024, 4, True), (4096, 1024, 4, False),
              (1000, 1000, 4, False), (16384, 65536, 2, True)]

    @pytest.mark.parametrize("budget,min_el", [(None, None), ("64", "1000")])
    def test_route_fused_matches_jax(self, knobs, budget, min_el):
        env = {}
        if budget:
            env = {"KF_XENT_XLA_BUDGET_MB": budget,
                   "KF_XENT_FWD_MIN_ELEMENTS": min_el}
        knobs(**env)
        for n, v, itemsize, training in self.SHAPES:
            assert txent._route_fused(n, v, itemsize, training) == \
                jxent._route_fused(n, v, itemsize, training), (n, v)
            assert txent.route_fused_lm_head(n, v) == \
                jxent.route_fused_lm_head(n, v)

    def test_thresholds_match_jax(self):
        assert txent.XENT_FWD_MIN_ELEMENTS == jxent.XENT_FWD_MIN_ELEMENTS
        assert txent.XENT_TRAIN_XLA_BUDGET_MB == jxent.XENT_TRAIN_XLA_BUDGET_MB


class TestKernelContract:
    def test_cpu_path_launches_no_kernel(self):
        kernels.reset_launch_counts()
        logits, targets = _data(8, 64)
        x = torch.from_numpy(logits).requires_grad_(True)
        txent.softmax_cross_entropy(x, torch.from_numpy(targets)).sum(
            ).backward()
        assert kernels.launch_counts == {"xent_fwd": 0, "xent_bwd": 0}

    def test_rejects_bad_operands(self):
        with pytest.raises(ValueError):
            kernels.forward(torch.zeros(4, 8, dtype=torch.float64),
                            torch.zeros(4, dtype=torch.long))
        with pytest.raises(ValueError):
            kernels.forward(torch.zeros(4, 8), torch.zeros(3, dtype=torch.long))
        with pytest.raises(ValueError):
            kernels.forward(torch.zeros(4, 8, device="meta"),
                            torch.zeros(4, dtype=torch.long, device="meta"))
        with pytest.raises(ValueError):
            txent.softmax_cross_entropy(torch.zeros(2, 3, 8),
                                        torch.zeros(2, 4, dtype=torch.long))
