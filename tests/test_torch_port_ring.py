"""Port parity: ring attention, the forward's collectives and the tp pair
over stacked co-resident ranks.

The same numpy inputs go through the reference under ``shard_map`` on
the conftest's 8 virtual CPU devices (Pallas flash blocks in interpret
mode) and through the port on the CPU, where the ranks run in lockstep
on a leading axis inside a ``rank_world`` and the flash blocks take
their plain versions.  Ring attention is held to the reference at
2e-5 in the forward and 1e-4 in the q/k/v gradients, and to dense
attention on the whole sequence; ``ppermute`` and ``all_to_all`` are
data movement and are held bitwise, their gradients too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.models.transformer import default_attention as jdense
from kungfu_tpu.parallel import ring as jring
from kungfu_tpu.parallel import tp as jtp
from kungfu_tpu.utils.jaxcompat import shard_map
from kungfu_tpu_torch.models.transformer import default_attention
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.ops.cuda import attention
from kungfu_tpu_torch.parallel import ring, tp

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the lockstep ranks'
    small products gain nothing from more, and the other workers of a
    parallel run keep their cores (their socket tests have deadlines)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _stack_seq(x, n_sp):
    """``[B, H, S, D]`` -> the sp ranks' ``[n_sp, B, H, S/n_sp, D]``."""
    B, H, S, D = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(B, H, n_sp, S // n_sp, D).transpose(2, 0, 1, 3, 4)))


def _unstack_seq(t):
    n, B, H, s, D = t.shape
    return t.permute(1, 2, 0, 3, 4).reshape(B, H, n * s, D)


def _ref_ring(q, k, v, causal, n_sp, **kw):
    """The reference's ring over ``n_sp`` devices: output and the q/k/v
    gradients of ``sum(out**2)``."""
    mesh = Mesh(np.array(jax.devices()[:n_sp]), ("sp",))
    f = shard_map(functools.partial(jring.ring_attention, causal=causal,
                                    axis="sp", **kw),
                  mesh=mesh, in_specs=(P(None, None, "sp", None),) * 3,
                  out_specs=P(None, None, "sp", None), check_vma=False)
    args = [jnp.asarray(t) for t in (q, k, v)]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                             argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(q, k, v, causal, n_sp, axes=None, **kw):
    """The port's ring over ``n_sp`` stacked ranks (inside ``axes``, by
    default just ``sp``): output and gradients, unstacked."""
    axes = axes or [("sp", n_sp)]
    ts = [_stack_seq(t, n_sp).requires_grad_(True) for t in (q, k, v)]
    with collective.rank_world(axes):
        out = ring.ring_attention(*ts, causal=causal, axis="sp", **kw)
        (out.float() ** 2).sum().backward()
    return (_unstack_seq(out.detach()).numpy(),
            [_unstack_seq(t.grad).numpy() for t in ts])


def _dense(q, k, v, causal):
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = default_attention(*ts, causal)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


class TestRingAttention:
    @pytest.mark.parametrize("causal", [True, False])
    def test_einsum_matches_reference(self, causal):
        q, k, v = _qkv((2, 2, 32, 16), 1)
        ro, rg = _ref_ring(q, k, v, causal, 4)
        po, pg = _port_ring(q, k, v, causal, 4, block_impl="einsum")
        np.testing.assert_allclose(po, ro, **FWD_TOL)
        for got, want in zip(pg, rg):
            np.testing.assert_allclose(got, want, **GRAD_TOL)
        do, dg = _dense(q, k, v, causal)
        np.testing.assert_allclose(po, do, **FWD_TOL)
        for got, want in zip(pg, dg):
            np.testing.assert_allclose(got, want, **GRAD_TOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_flash_blocks_match_reference(self, causal):
        """block_impl='flash': the port's plain flash versions with the
        lse merge against the reference's Pallas blocks in interpret
        mode, forward and gradients (the lse cotangent shifts delta)."""
        q, k, v = _qkv((1, 2, 32, 16), 3)
        ro, rg = _ref_ring(q, k, v, causal, 4, block_impl="flash")
        po, pg = _port_ring(q, k, v, causal, 4, block_impl="flash")
        np.testing.assert_allclose(po, ro, **FWD_TOL)
        for got, want, name in zip(pg, rg, "qkv"):
            np.testing.assert_allclose(got, want, **GRAD_TOL,
                                       err_msg=f"d{name}")
        do, dg = _dense(q, k, v, causal)
        np.testing.assert_allclose(po, do, **FWD_TOL)
        for got, want in zip(pg, dg):
            np.testing.assert_allclose(got, want, **GRAD_TOL)

    @pytest.mark.parametrize("kv_gather", ["lax", "pallas_ring"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_kv_gather_matches_reference(self, kv_gather, causal):
        q, k, v = _qkv((2, 2, 32, 16), 4)
        ro, rg = _ref_ring(q, k, v, causal, 4, kv_gather=kv_gather)
        po, pg = _port_ring(q, k, v, causal, 4, kv_gather=kv_gather)
        np.testing.assert_allclose(po, ro, **FWD_TOL)
        for got, want in zip(pg, rg):
            np.testing.assert_allclose(got, want, **GRAD_TOL)

    def test_kv_gather_refuses_flash(self):
        q = torch.zeros(1, 1, 1, 8, 16)
        with collective.rank_world([("sp", 1)]):
            with pytest.raises(ValueError, match="cannot honor"):
                ring.ring_attention(q, q, q, kv_gather="lax",
                                    block_impl="flash")
            with pytest.raises(ValueError, match="unknown kv_gather"):
                ring.ring_attention(q, q, q, kv_gather="ring")
        with pytest.raises(ValueError, match="unknown block_impl"):
            ring.ring_attention(q[0], q[0], q[0], block_impl="pallas")

    @pytest.mark.parametrize("impl", ["einsum", "flash"])
    def test_rings_inside_a_larger_world(self, impl):
        """sp as the middle axis of dp x sp x tp: each (dp, tp) pair is
        its own strided ring over its own data; every ring equals dense
        attention on its sequence."""
        B, H, S, D = 1, 2, 16, 8
        rng = np.random.default_rng(7)
        xs = rng.standard_normal((3, 2, 2, B, H, S, D)).astype(np.float32)
        # [qkv, dp, tp, B, H, S, D] -> stacked [dp, sp, tp] ranks
        st = torch.from_numpy(np.ascontiguousarray(
            xs.reshape(3, 2, 2, B, H, 4, S // 4, D).transpose(
                0, 1, 5, 2, 3, 4, 6, 7))).reshape(3, 16, B, H, S // 4, D)
        with collective.rank_world([("dp", 2), ("sp", 4), ("tp", 2)]):
            out = ring.ring_attention(st[0], st[1], st[2], causal=True,
                                      axis="sp", block_impl=impl)
        out = out.reshape(2, 4, 2, B, H, S // 4, D)
        for d in range(2):
            for t in range(2):
                got = out[d, :, t].permute(1, 2, 0, 3, 4).reshape(B, H, S, D)
                want = np.asarray(jdense(*(jnp.asarray(xs[i, d, t])
                                           for i in range(3)), causal=True))
                np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)

    def test_flash_rows_partition_by_branch(self, monkeypatch):
        """Causal rounds launch at most twice (full rows, diagonal rows);
        round 0 is one diagonal launch over every rank, masked rows
        launch nothing."""
        calls = []
        real = attention.flash_attention_with_lse

        def spy(q, k, v, causal=True):
            calls.append((q.shape[0], causal))
            return real(q, k, v, causal=causal)

        monkeypatch.setattr(attention, "flash_attention_with_lse", spy)
        q, k, v = _qkv((1, 2, 32, 16), 5)
        _port_ring(q, k, v, True, 4, block_impl="flash")
        # 4 ranks x B*H = 2 rows; round r: ranks i >= 4 - r are full
        assert calls == [(8, True), (2, False), (4, False), (6, False)]
        calls.clear()
        _port_ring(q, k, v, False, 4, block_impl="flash")
        assert calls == [(8, False)] * 4

    def test_one_rank_outside_a_world(self):
        q, k, v = (torch.from_numpy(t) for t in _qkv((1, 2, 16, 8), 6))
        out = ring.ring_attention(q, k, v, causal=True)
        want = default_attention(q, k, v, True)
        np.testing.assert_allclose(out.numpy(), want.numpy(), **FWD_TOL)
        attn = ring.make_ring_attn(block_impl="flash")
        np.testing.assert_allclose(attn(q, k, v, True).numpy(),
                                   want.numpy(), **FWD_TOL)


def _jstacked(axes, fn, x):
    names = tuple(a for a, _ in axes)
    sizes = tuple(s for _, s in axes)
    n = int(np.prod(sizes))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(sizes), names)
    f = shard_map(fn, mesh=mesh, in_specs=(P(names),), out_specs=P(names),
                  check_vma=False)
    return f


class TestForwardCollectives:
    AXES = [("dp", 2), ("sp", 4)]

    @pytest.mark.parametrize("perm", [
        [((j + 1) % 4, j) for j in range(4)],   # the ring's rotation
        [(j, j + 1) for j in range(3)],         # the pipeline's hop
        [(0, 2), (3, 1)]])
    def test_ppermute_bitwise_with_transpose(self, perm):
        x = np.random.default_rng(0).standard_normal((8, 3, 5)).astype(
            np.float32)
        w = np.random.default_rng(1).standard_normal((8, 3, 5)).astype(
            np.float32)
        f = _jstacked(self.AXES, lambda a: jax.lax.ppermute(a, "sp", perm),
                      jnp.asarray(x))
        want = np.asarray(jax.jit(f)(jnp.asarray(x)))
        gwant = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * w))(
            jnp.asarray(x)))
        t = torch.from_numpy(x).requires_grad_(True)
        with collective.rank_world(self.AXES):
            got = collective.ppermute(t, "sp", perm)
        (got * torch.from_numpy(w)).sum().backward()
        assert np.array_equal(got.detach().numpy(), want)
        assert np.array_equal(t.grad.numpy(), gwant)

    @pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (2, 2)])
    def test_all_to_all_bitwise_with_transpose(self, split, concat):
        axes = [("dp", 4), ("tp", 2)]
        x = np.random.default_rng(2).standard_normal((8, 4, 8, 4)).astype(
            np.float32)
        w_shape = list(x.shape[1:])
        w_shape[split] //= 4
        w_shape[concat] *= 4
        w = np.random.default_rng(3).standard_normal([8] + w_shape).astype(
            np.float32)
        f = _jstacked(axes, lambda a: jax.lax.all_to_all(
            a, "dp", split + 1, concat + 1, tiled=True), jnp.asarray(x))
        want = np.asarray(jax.jit(f)(jnp.asarray(x)))
        gwant = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * w))(
            jnp.asarray(x)))
        t = torch.from_numpy(x).requires_grad_(True)
        with collective.rank_world(axes):
            got = collective.all_to_all(t, "dp", split, concat)
        (got * torch.from_numpy(w)).sum().backward()
        assert np.array_equal(got.detach().numpy(), want)
        assert np.array_equal(t.grad.numpy(), gwant)

    def test_axis_index_and_edge_cases(self):
        with collective.rank_world(self.AXES):
            assert collective.axis_index("sp").tolist() == [0, 1, 2, 3] * 2
            assert collective.axis_index("dp").tolist() == [0] * 4 + [1] * 4
            with pytest.raises(ValueError, match="distinct"):
                collective.ppermute(torch.zeros(8), "sp", [(0, 1), (2, 1)])
        assert collective.axis_index("sp") == 0
        x = torch.ones(3)
        assert collective.ppermute(x, "sp", [(0, 0)]) is x
        assert collective.all_to_all(x, "dp", 0, 0) is x


class TestTensorParallelPair:
    def test_enter_exit_grads_match_reference(self):
        """x -> enter -> column(w1) -> gelu -> row(w2) (exit) per rank of
        a tp=4 ring: the output and dx/dw1/dw2 against the reference's
        custom-vjp pair under shard_map."""
        rng = np.random.default_rng(4)
        x = rng.standard_normal((6, 8)).astype(np.float32)
        w1 = rng.standard_normal((4, 8, 3)).astype(np.float32)
        w2 = rng.standard_normal((4, 3, 8)).astype(np.float32)
        mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))

        def body(x, w1, w2):
            h = jtp.tp_region_enter(x[0], "tp")
            h = jax.nn.gelu(jtp.column_dense({"w": w1[0]}, h))
            return jtp.row_dense({"w": w2[0]}, h, "tp")[None]

        # each rank's output row, the loss the sum over ranks of out**2
        f = shard_map(body, mesh=mesh, in_specs=(P("tp"), P("tp"), P("tp")),
                      out_specs=P("tp"), check_vma=False)
        xs = np.broadcast_to(x, (4,) + x.shape).copy()
        args = [jnp.asarray(a) for a in (xs, w1, w2)]
        want = np.asarray(f(*args))
        gwant = jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                         argnums=(0, 1, 2))(*args)

        ts = [torch.from_numpy(a).requires_grad_(True) for a in (xs, w1, w2)]
        with collective.rank_world([("tp", 4)]):
            h = tp.tp_region_enter(ts[0], "tp")
            h = torch.nn.functional.gelu(tp.column_dense({"w": ts[1]}, h),
                                         approximate="tanh")
            out = tp.row_dense({"w": ts[2]}, h, "tp")
        (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        for t, g in zip(ts, gwant):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-4)

    def test_outside_a_world_is_plain(self):
        x = torch.randn(3, 4)
        p = {"w": torch.randn(4, 5), "b": torch.randn(5)}
        assert tp.tp_region_enter(x, "tp") is x
        assert torch.equal(tp.column_dense(p, x), x @ p["w"] + p["b"])
        assert torch.equal(tp.row_dense(p, x, "tp"), x @ p["w"] + p["b"])
