"""Port parity: ring collectives, schedules and the Communicator over
stacked co-resident ranks.

The same numpy inputs go through the reference, under ``shard_map`` on
the conftest's 8 virtual CPU devices, and through the port on the CPU,
where the ranks' values are stacked on a leading axis inside a
``rank_world``.  The port's ring collectives take their plain versions
on CPU tensors; they are held **bitwise** against the reference's
``impl="lax"`` emulation (and, in a few cases, against its Pallas kernel
in interpret mode), which the reference's own suite pins bitwise to the
kernel.  Collectives whose reduction order is XLA's own (``psum``,
``psum_scatter``) are held to ``rtol 1e-6`` on floats and exactly on
integers.  No process group is started: every test is one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu import initializer as jinit
from kungfu_tpu.comm.device import Communicator as JCommunicator
from kungfu_tpu.ops import collective as jcoll
from kungfu_tpu.ops import schedules as jsched
from kungfu_tpu.ops.pallas import collectives as jring
from kungfu_tpu.utils.jaxcompat import shard_map
from kungfu_tpu_torch import initializer
from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.ops import collective, collectives, schedules
from kungfu_tpu_torch.utils import envs

WORLDS = (2, 3, 5, 8)
#: a chunk whose f32 tile rows split into two bands (2048), a full
#: single-tile chunk (1024, which does not split), a ragged chunk and a
#: chunk smaller than one tile: the reference suite's shapes
CHUNKS = (2048, 1024, 1000, 40)
#: floats reduced in XLA's order on one side and the port's on the other
RTOL = 1e-6
MESH_2x4 = (("kf_host", 2), ("kf_local", 4))


def _jworld(axes, fn, x, out_spec=True):
    """``fn`` per device under shard_map over a mesh of ``axes``
    (``[(name, size)]``, outer first), the stacked ``x`` split on its
    leading axis; returns the stacked result as numpy."""
    names = tuple(a for a, _ in axes)
    sizes = tuple(s for _, s in axes)
    n = int(np.prod(sizes))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(sizes), names)
    f = shard_map(fn, mesh=mesh, in_specs=(P(names),),
                  out_specs=P(names) if out_spec else P(),
                  check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(x))


def _ring(n):
    return (("x", n),)


def _bits(a) -> bytes:
    """The raw bytes of a torch tensor or numpy / jax array."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def _inputs(n, length, dtype, seed):
    """Stacked ``[n, length]`` data in ``dtype`` as (jax, torch) with the
    same bits."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, (n, length)).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.standard_normal((n, length)).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    jx = jnp.asarray(x, jnp.bfloat16)
    raw = np.asarray(jx).view(np.int16)
    return jx, torch.from_numpy(raw.copy()).view(torch.bfloat16)


def _port_rs(n, x, bidi, impl="lax"):
    with collective.rank_world(_ring(n)):
        return collectives.ring_reduce_scatter(x, "x", bidirectional=bidi,
                                               impl=impl)


def _port_ag(n, x, bidi, impl="lax"):
    with collective.rank_world(_ring(n)):
        return collectives.ring_all_gather(x, "x", bidirectional=bidi,
                                           impl=impl)


def _ref_rs(n, x, bidi, impl="lax"):
    return _jworld(_ring(n), lambda row: jring.ring_reduce_scatter(
        row[0], "x", bidirectional=bidi, impl=impl)[None], x)


def _ref_ag(n, x, bidi, impl="lax"):
    return _jworld(_ring(n), lambda row: jring.ring_all_gather(
        row[0], "x", bidirectional=bidi, impl=impl)[None], x)


class TestGeometry:
    def test_band_split_engages_in_this_suite(self):
        """At least one CHUNKS entry splits into two bands, so every
        ``bidi=True`` case below really runs both directions."""
        assert collectives._band_rows(8, torch.float32) == 0
        assert collectives._band_rows(16, torch.float32) == 8
        assert collectives._band_rows(24, torch.float32) == 16
        split = [c for c in CHUNKS
                 if collectives.band_cut(c, torch.float32, True) < c]
        assert split == [2048]
        assert collectives.band_cut(4096, torch.bfloat16, True) == 2048
        assert collectives.band_cut(2048, torch.float32, False) == 2048

    @pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                         (torch.bfloat16, jnp.bfloat16),
                                         (torch.int32, jnp.int32),
                                         (torch.int8, jnp.int8)])
    def test_tile_geometry_matches_reference(self, tdt, jdt):
        for chunk in (1, 40, 127, 128, 1000, 1024, 1025, 2048, 3968, 4096,
                      5000, 262144):
            rows = collectives._tile_rows(chunk, tdt)
            assert rows == jring._tile_rows(chunk, jdt), chunk
            assert collectives._band_rows(rows, tdt) == \
                jring._band_rows(rows, jdt), chunk

    @pytest.mark.parametrize("kind", ["reduce_scatter", "all_gather",
                                      "all_reduce"])
    def test_wire_bytes_match_reference(self, kind):
        for nbytes, n in ((4096, 2), (1000, 3), (1 << 20, 8)):
            assert collectives.ring_wire_bytes(nbytes, n, kind) == \
                jring.ring_wire_bytes(nbytes, n, kind)
        with pytest.raises(ValueError):
            collectives.ring_wire_bytes(8, 2, "bogus")


class TestRingBitwise:
    @pytest.mark.parametrize("n", WORLDS)
    @pytest.mark.parametrize("chunk", CHUNKS)
    @pytest.mark.parametrize("bidi", [False, True])
    def test_reduce_scatter_f32(self, n, chunk, bidi):
        jx, tx = _inputs(n, n * chunk, "float32", n * 7919 + chunk + bidi)
        got = _port_rs(n, tx, bidi)
        assert got.shape == (n, chunk)
        assert _bits(got) == _bits(_ref_rs(n, jx, bidi))

    @pytest.mark.parametrize("n", WORLDS)
    @pytest.mark.parametrize("chunk", CHUNKS)
    @pytest.mark.parametrize("bidi", [False, True])
    def test_all_gather_f32(self, n, chunk, bidi):
        jx, tx = _inputs(n, chunk, "float32", n * 31 + chunk + bidi)
        got = _port_ag(n, tx, bidi)
        assert got.shape == (n, n * chunk)
        assert _bits(got) == _bits(_ref_ag(n, jx, bidi))
        # pure data movement: every rank holds the concatenation
        assert torch.equal(got, tx.reshape(1, -1).expand(n, -1))

    @pytest.mark.parametrize("n,chunk,bidi", [(4, 400, False), (4, 4096, True),
                                              (3, 4096, True), (5, 5000, False),
                                              (8, 4096, True)])
    def test_bf16(self, n, chunk, bidi):
        jx, tx = _inputs(n, n * chunk, "bfloat16", chunk + n)
        got = _port_rs(n, tx, bidi)
        assert got.dtype == torch.bfloat16
        assert _bits(got) == _bits(_ref_rs(n, jx, bidi))
        assert _bits(_port_ag(n, got, bidi)) == \
            _bits(_ref_ag(n, jnp.asarray(np.asarray(_ref_rs(n, jx, bidi))),
                          bidi))

    @pytest.mark.parametrize("n", (3, 8))
    @pytest.mark.parametrize("bidi", [False, True])
    @pytest.mark.parametrize("chunk", (200, 4096))
    def test_int32_exact(self, n, bidi, chunk):
        """int32 adds exactly (wrapping), so every order gives the same
        bits: the port's fold equals the reference's and the plain sum."""
        jx, tx = _inputs(n, n * chunk, "int32", 11 + n)
        got = _port_rs(n, tx, bidi)
        assert _bits(got) == _bits(_ref_rs(n, jx, bidi))
        assert torch.equal(got, tx.view(n, n, chunk).sum(0, dtype=torch.int32))
        assert _bits(_port_ag(n, got, bidi)) == _bits(_ref_ag(
            n, jnp.asarray(got.numpy()), bidi))

    @pytest.mark.parametrize("n,chunk,bidi,dtype", [
        (3, 1000, False, "float32"),
        (4, 2048, True, "float32"),
        (2, 4096, True, "bfloat16"),
        (5, 40, False, "float32"),
    ])
    def test_against_pallas_interpret(self, n, chunk, bidi, dtype):
        """The chain reaches the Pallas kernel itself: the reference's
        ``impl="pallas"`` in interpret mode on the CPU."""
        jx, tx = _inputs(n, n * chunk, dtype, 5 + n + chunk)
        rs = _port_rs(n, tx, bidi)
        assert _bits(rs) == _bits(_ref_rs(n, jx, bidi, impl="pallas"))
        jshard = jnp.asarray(np.asarray(_ref_rs(n, jx, bidi)))
        assert _bits(_port_ag(n, rs, bidi)) == \
            _bits(_ref_ag(n, jshard, bidi, impl="pallas"))

    @pytest.mark.parametrize("n", range(2, 9))
    @pytest.mark.parametrize("bidi", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
    def test_fold_order_of_the_direct_kernel(self, n, bidi, dtype):
        """The per-element order the CUDA reduce-scatter folds in: rank
        ``r``'s element of chunk ``r`` is ``((x[r+s][r] + x[r+2s][r]) +
        ...) + x[r][r]``, ``s = +1`` on ``[0, cut)`` and ``-1`` on
        ``[cut, chunk)``, each step rounded to the element type, written
        here as a loop over source ranks; bitwise the plain version and
        the reference's ``impl="lax"`` ring."""
        chunk = 4096 if dtype == "bfloat16" else 2048
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int32": torch.int32}[dtype]
        cut = collectives.band_cut(chunk, tdt, bidi)
        assert (cut < chunk) == bidi
        jx, tx = _inputs(n, n * chunk, dtype, 31 * n + bidi)
        x = tx.view(n, n, chunk)
        want = torch.empty((n, chunk), dtype=tdt)
        for r in range(n):
            for s, lo, hi in ((1, 0, cut), (-1, cut, chunk)):
                if hi > lo:
                    acc = x[(r + s) % n, r, lo:hi]
                    for j in range(2, n + 1):
                        acc = acc + x[(r + s * j) % n, r, lo:hi]
                    want[r, lo:hi] = acc
        assert _bits(collectives.ring_reduce_scatter_reference(tx, cut)) == \
            _bits(want)
        assert _bits(_ref_rs(n, jx, bidi)) == _bits(want)

    @pytest.mark.parametrize("n", (3, 4))
    @pytest.mark.parametrize("shape", [(5, 7), (3, 37), (1,)])
    def test_all_reduce(self, n, shape):
        rng = np.random.default_rng(n)
        x = rng.standard_normal((n,) + shape).astype(np.float32)
        ref = _jworld(_ring(n), lambda row: jring.ring_all_reduce(
            row[0], "x", impl="lax")[None], jnp.asarray(x))
        with collective.rank_world(_ring(n)):
            got = collectives.ring_all_reduce(torch.from_numpy(x), "x",
                                              impl="lax")
        assert got.shape == x.shape
        assert _bits(got) == _bits(ref)


class TestRingAutograd:
    @pytest.mark.parametrize("n,chunk,bidi", [(4, 2048, True), (3, 1000, False)])
    def test_gather_backward_is_scatter(self, n, chunk, bidi):
        """grad through the all-gather is the ring reduce-scatter of the
        cotangent, bitwise against ``jax.grad`` through the reference."""
        rng = np.random.default_rng(chunk)
        shard = rng.standard_normal((n, chunk)).astype(np.float32)
        w = rng.standard_normal((n, n * chunk)).astype(np.float32)

        def jbody(args):
            s, wr = args[0][0], args[1][0]
            g = jax.grad(lambda v: jnp.sum(jring.ring_all_gather(
                v, "x", bidirectional=bidi, impl="lax") * wr))(s)
            return g[None]

        mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
        f = shard_map(jbody, mesh=mesh, in_specs=((P("x"), P("x")),),
                      out_specs=P("x"), check_vma=False)
        ref = np.asarray(jax.jit(f)((jnp.asarray(shard), jnp.asarray(w))))
        ts = torch.from_numpy(shard).requires_grad_(True)
        with collective.rank_world(_ring(n)):
            full = collectives.ring_all_gather(ts, "x", bidirectional=bidi,
                                               impl="lax")
            (g,) = torch.autograd.grad((full * torch.from_numpy(w)).sum(), ts)
            want = collectives.ring_reduce_scatter(torch.from_numpy(w), "x",
                                                   bidirectional=bidi,
                                                   impl="lax")
        assert _bits(g) == _bits(ref)
        assert torch.equal(g, want)

    def test_scatter_backward_is_gather(self):
        n, chunk = 4, 300
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((n, n * chunk)).astype(
            np.float32)).requires_grad_(True)
        ct = torch.from_numpy(rng.standard_normal((n, chunk)).astype(
            np.float32))
        with collective.rank_world(_ring(n)):
            out = collectives.ring_reduce_scatter(x, "x", impl="lax")
            (g,) = torch.autograd.grad(out, x, ct)
        assert torch.equal(g, ct.reshape(1, -1).expand(n, -1))


class TestRingRouting:
    def test_pallas_impl_on_cpu_raises(self):
        x = torch.ones(2, 8)
        with collective.rank_world(_ring(2)):
            with pytest.raises(ValueError, match="CUDA"):
                collectives.ring_reduce_scatter(x, "x", impl="pallas")
            with pytest.raises(ValueError, match="CUDA"):
                collectives.ring_all_gather(x, "x", impl="pallas")
            with pytest.raises(ValueError, match="impl"):
                collectives.ring_all_gather(x, "x", impl="bogus")

    def test_kernel_wrappers_refuse_cpu(self):
        from kungfu_tpu_torch.ops.cuda import collectives as kernels

        with pytest.raises(ValueError, match="CUDA"):
            kernels.reduce_scatter(torch.ones(2, 8))
        with pytest.raises(ValueError, match="CUDA"):
            kernels.all_gather(torch.ones(2, 4))
        assert kernels.launch_counts == {"ring_rs": 0, "ring_ag": 0}

    def test_env_knob(self, monkeypatch):
        """``KF_PALLAS_COLLECTIVES`` is read at import and on reload,
        with the reference's values; ``auto`` takes the plain version on
        CPU tensors, ``pallas`` raises there."""
        x = torch.arange(8.0).reshape(2, 4)
        try:
            monkeypatch.setenv("KF_PALLAS_COLLECTIVES", "pallas")
            assert envs.COLLECTIVES_ENV.impl == "auto"  # not re-read yet
            envs.COLLECTIVES_ENV.reload()
            assert envs.COLLECTIVES_ENV.impl == "pallas"
            with collective.rank_world(_ring(2)):
                with pytest.raises(ValueError, match="CUDA"):
                    collectives.ring_reduce_scatter(x, "x")
            monkeypatch.setenv("KF_PALLAS_COLLECTIVES", "LAX")
            assert envs.COLLECTIVES_ENV.reload().impl == "lax"
            monkeypatch.setenv("KF_PALLAS_COLLECTIVES", "bogus")
            with pytest.raises(ValueError, match="KF_PALLAS_COLLECTIVES"):
                envs.COLLECTIVES_ENV.reload()
        finally:
            monkeypatch.delenv("KF_PALLAS_COLLECTIVES")
            envs.COLLECTIVES_ENV.reload()
        assert envs.COLLECTIVES_ENV.impl == "auto"
        with collective.rank_world(_ring(2)):
            out = collectives.ring_reduce_scatter(x, "x")
        assert torch.equal(out, torch.tensor([[4.0, 6.0], [8.0, 10.0]]))

    def test_one_rank_and_shape_checks(self):
        x = torch.ones(1, 6)
        with collective.rank_world(_ring(1)):
            assert collectives.ring_reduce_scatter(x, "x") is x
            assert collectives.ring_all_gather(x, "x") is x
        with collective.rank_world(_ring(2)):
            with pytest.raises(ValueError, match="k\\*chunk"):
                collectives.ring_reduce_scatter(torch.ones(2, 5), "x")
            with pytest.raises(ValueError, match="leading rank axis"):
                collectives.ring_all_gather(torch.ones(3, 4), "x")

    def test_ring_bytes_counter(self):
        collectives.reset_ring_bytes()
        n, chunk = 4, 100
        with collective.rank_world(_ring(n)):
            s = collectives.ring_reduce_scatter(torch.ones(n, n * chunk), "x")
            collectives.ring_all_gather(s, "x")
        assert collectives.ring_bytes == {
            "reduce_scatter": jring.ring_wire_bytes(n * chunk * 4, n),
            "all_gather": jring.ring_wire_bytes(chunk * 4, n, "all_gather")}
        collectives.reset_ring_bytes()
        assert collectives.ring_bytes["all_gather"] == 0.0


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, ref, exact: bool):
    if exact:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6)


class TestScheduledAllReduce:
    @pytest.mark.parametrize("schedule", schedules.ALLREDUCE_SCHEDULES)
    @pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
    @pytest.mark.parametrize("axis", [("kf_host", "kf_local"), "kf_local",
                                      "kf_host"])
    def test_matches_reference_on_2x4(self, schedule, op, axis):
        x = _data((8, 5, 3), "float32", seed=len(op))
        ref = _jworld(MESH_2x4, lambda row: jsched.all_reduce_scheduled(
            row[0], axis, op=op, schedule=schedule)[None], jnp.asarray(x))
        with collective.rank_world(MESH_2x4):
            got = schedules.all_reduce_scheduled(torch.from_numpy(x), axis,
                                                 op=op, schedule=schedule)
        _close(got, ref, exact=op in ("min", "max"))

    @pytest.mark.parametrize("schedule", ["ring", "pallas_ring"])
    @pytest.mark.parametrize("n", (3, 8))
    def test_ring_schedules_bitwise_on_one_axis(self, schedule, n):
        """The explicit rings fold in the reference's order: bitwise."""
        x = _data((n, 4, 9), "float32", seed=n)
        ref = _jworld(_ring(n), lambda row: jsched.all_reduce_scheduled(
            row[0], "x", schedule=schedule)[None], jnp.asarray(x))
        with collective.rank_world(_ring(n)):
            got = schedules.all_reduce_scheduled(torch.from_numpy(x), "x",
                                                 schedule=schedule)
        assert _bits(got) == _bits(ref)

    @pytest.mark.parametrize("schedule", schedules.ALLREDUCE_SCHEDULES)
    def test_int32_and_tree(self, schedule):
        x = {"a": _data((8, 6), "int32"), "b": _data((8, 3), "int32", 1)}
        ref = _jworld(MESH_2x4, lambda row: jax.tree_util.tree_map(
            lambda a: a[None], jsched.all_reduce_scheduled(
                jax.tree_util.tree_map(lambda a: a[0], row),
                ("kf_host", "kf_local"), schedule=schedule)),
            jax.tree_util.tree_map(jnp.asarray, x))
        with collective.rank_world(MESH_2x4):
            got = schedules.all_reduce_scheduled(
                {k: torch.from_numpy(v) for k, v in x.items()},
                ("kf_host", "kf_local"), schedule=schedule)
        for k in x:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))

    def test_bad_names_raise(self):
        with collective.rank_world(MESH_2x4):
            with pytest.raises(ValueError, match="schedule"):
                schedules.all_reduce_scheduled(torch.ones(8), "kf_local",
                                               schedule="bogus")
            with pytest.raises(ValueError, match="op"):
                schedules.all_reduce_scheduled(torch.ones(8), "kf_local",
                                               op="prod")

    def test_size_buckets_match_reference(self):
        assert schedules.ALLREDUCE_SCHEDULES == jsched.ALLREDUCE_SCHEDULES
        assert schedules.FLAT_SCHEDULES == jsched.FLAT_SCHEDULES
        assert schedules.SIZE_BUCKETS == jsched.SIZE_BUCKETS
        for nbytes in (0, 1, (256 << 10) - 1, 256 << 10, 1 << 30):
            assert schedules.size_bucket(nbytes) == jsched.size_bucket(nbytes)

    @pytest.mark.parametrize("op,dtype", [("min", torch.float32),
                                          ("max", torch.int32),
                                          ("min", torch.int16),
                                          ("max", torch.bool),
                                          ("sum", torch.float32)])
    def test_pad_identity_matches_reference(self, op, dtype):
        jdt = {torch.float32: jnp.float32, torch.int32: jnp.int32,
               torch.int16: jnp.int16, torch.bool: jnp.bool_}[dtype]
        assert schedules._pad_identity(op, dtype) == \
            jsched._pad_identity(op, jdt)


class TestCollectiveOps:
    def _run(self, fn_ref, fn_port, x, axes=MESH_2x4):
        ref = _jworld(axes, lambda row: fn_ref(row[0])[None],
                      jnp.asarray(x))
        with collective.rank_world(axes):
            got = fn_port(torch.from_numpy(x))
        return got, ref

    @pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
    @pytest.mark.parametrize("axis", [("kf_host", "kf_local"), "kf_local",
                                      "kf_host"])
    def test_all_reduce(self, op, axis):
        x = _data((8, 4, 3), "float32", seed=3)
        got, ref = self._run(lambda a: jcoll.all_reduce(a, axis, op),
                             lambda a: collective.all_reduce(a, axis, op), x)
        _close(got, ref, exact=op in ("min", "max"))
        got, ref = self._run(lambda a: jcoll.group_all_reduce(a, axis, op),
                             lambda a: collective.group_all_reduce(a, axis,
                                                                   op), x)
        _close(got, ref, exact=op in ("min", "max"))

    @pytest.mark.parametrize("tiled", [False, True])
    @pytest.mark.parametrize("axis", [("kf_host", "kf_local"), "kf_local",
                                      "kf_host"])
    def test_all_gather(self, tiled, axis):
        x = _data((8, 3, 2), "float32", seed=4)
        got, ref = self._run(lambda a: jcoll.all_gather(a, axis, tiled),
                             lambda a: collective.all_gather(a, axis, tiled),
                             x)
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize("root", [0, 3])
    @pytest.mark.parametrize("axis", [("kf_host", "kf_local"), "kf_local"])
    def test_broadcast_ignores_nan_elsewhere(self, root, axis):
        x = _data((8, 5), "float32", seed=5)
        x[(root + 1) % 8, 2] = np.nan
        got, ref = self._run(lambda a: jcoll.broadcast(a, axis, root),
                             lambda a: collective.broadcast(a, axis, root), x)
        np.testing.assert_array_equal(got.numpy(), ref)
        got, ref = self._run(lambda a: jinit.device_broadcast(a, axis, root),
                             lambda a: initializer.device_broadcast(
                                 a, axis, root), x)
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize("axis", [("kf_host", "kf_local"), "kf_local",
                                      "kf_host", ("kf_local", "kf_host")])
    def test_peer_rank_size_and_barrier(self, axis):
        x = np.zeros((8, 1), np.int32)
        got, ref = self._run(
            lambda a: jnp.full((1,), jcoll.peer_rank(axis), jnp.int32),
            lambda a: collective.peer_rank(axis)[:, None].to(torch.int32), x)
        np.testing.assert_array_equal(got.numpy(), ref)
        got, ref = self._run(
            lambda a: jnp.full((1,), jcoll.barrier_value(axis), jnp.int32),
            lambda a: collective.barrier_value(axis)[:, None], x)
        np.testing.assert_array_equal(got.numpy(), ref)
        with collective.rank_world(MESH_2x4):
            assert collective.peer_size(axis) == {
                "kf_host": 2, "kf_local": 4}.get(axis, 8)

    def test_outside_a_world(self):
        x = torch.ones(3)
        assert collective.peer_size(("kf_host", "kf_local")) == 1
        assert collective.peer_rank("kf_local") == 0
        assert collective.broadcast(x, "kf_local") is x
        assert collective.all_gather(x, "kf_local").shape == (1, 3)
        assert int(collective.barrier_value("kf_local")) == 1
        with collective.rank_world(MESH_2x4):
            with pytest.raises(ValueError, match="not bound"):
                collective.peer_size("dp")
            with pytest.raises(ValueError, match="leading rank axis"):
                collective.all_reduce(torch.ones(4), "kf_local")

    def test_process_group_does_not_change_peer_size(self, monkeypatch,
                                                      tmp_path):
        """Collectives learn ``n`` from the rank world only: a
        ``torch.distributed`` group set up by other code (a real one-rank
        gloo group, then a reported world of 4) changes nothing."""
        import torch.distributed as dist

        store = dist.FileStore(str(tmp_path / "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 4)
            assert dist.is_initialized() and dist.get_world_size() == 4
            x = torch.ones(3)
            assert collective.peer_size("kf_local") == 1
            assert collective.all_reduce(x, "kf_local") is x
            with collective.rank_world(MESH_2x4):
                assert collective.peer_size("kf_local") == 4
                out = collective.all_reduce(torch.ones(8, 2), "kf_local")
            assert torch.equal(out, torch.full((8, 2), 4.0))
        finally:
            monkeypatch.undo()
            dist.destroy_process_group()


class TestFlatBuckets:
    @pytest.mark.parametrize("chunk,n,itemsize,bb", [
        (5, 8, 4, 16), (1000, 8, 4, 4 << 20), (33_601_152, 4, 4, 4 << 20),
        (0, 4, 4, 64), (7, 3, 2, 1), (100, 2, 4, 64)])
    def test_bucket_widths_match_reference(self, chunk, n, itemsize, bb):
        assert schedules.bucket_widths(chunk, n, itemsize, bb) == \
            jsched.bucket_widths(chunk, n, itemsize, bb)

    def test_flagship_bucket_count(self):
        """gpt_small(max_seq=2048): 134,404,608 f32 params over 4 ranks
        make 129 buckets of 4 MiB operands: 128 of 262,144 columns and
        the rest, 33,601,152 - 128 * 262,144 = 46,720."""
        widths = schedules.bucket_widths(134_404_608 // 4, 4, 4, 4 << 20)
        assert len(widths) == 129
        assert widths[0] == 262_144 and widths[-1] == 46_720

    @pytest.mark.parametrize("schedule", schedules.FLAT_SCHEDULES)
    def test_bucketing_is_bitwise_invariant(self, schedule):
        chunk = 5
        x = _data((8, 8 * chunk), "float32", seed=6)
        axes = ("kf_host", "kf_local")
        outs, gathered = [], []
        with collective.rank_world(MESH_2x4):
            for widths in (None, [5], [2, 3], [4, 1], [1] * 5):
                s = schedules.reduce_scatter_flat(
                    torch.from_numpy(x), axes, chunk, widths,
                    schedule=schedule)
                outs.append(s)
                gathered.append(schedules.all_gather_flat(
                    s, axes, widths, prefetch=True, schedule=schedule))
        for o, g in zip(outs[1:], gathered[1:]):
            assert _bits(o) == _bits(outs[0])
            assert _bits(g) == _bits(gathered[0])
        assert torch.equal(gathered[0], outs[0].reshape(1, -1).expand(8, -1))

    @pytest.mark.parametrize("schedule", schedules.FLAT_SCHEDULES)
    @pytest.mark.parametrize("widths", [None, [2, 3]])
    def test_matches_reference(self, schedule, widths):
        chunk = 5
        axes = ["kf_host", "kf_local"]
        x = _data((8, 8 * chunk), "float32", seed=7)
        ref = _jworld(MESH_2x4, lambda row: jsched.reduce_scatter_flat(
            row[0], axes, chunk, widths, schedule=schedule)[None],
            jnp.asarray(x))
        ref_ag = _jworld(MESH_2x4, lambda row: jsched.all_gather_flat(
            row[0], axes, widths, schedule=schedule)[None], jnp.asarray(ref))
        with collective.rank_world(MESH_2x4):
            got = schedules.reduce_scatter_flat(torch.from_numpy(x), axes,
                                                chunk, widths,
                                                schedule=schedule)
            got_ag = schedules.all_gather_flat(
                torch.from_numpy(ref.copy()), axes, widths, schedule=schedule)
        _close(got, ref, exact=False)
        np.testing.assert_array_equal(got_ag.numpy(), ref_ag)

    @pytest.mark.parametrize("schedule", schedules.FLAT_SCHEDULES)
    def test_gather_backward_is_scatter(self, schedule):
        chunk, widths = 6, [4, 2]
        axes = ("kf_host", "kf_local")
        rng = np.random.default_rng(8)
        shard = torch.from_numpy(rng.standard_normal((8, chunk)).astype(
            np.float32)).requires_grad_(True)
        w = torch.from_numpy(rng.standard_normal((8, 8 * chunk)).astype(
            np.float32))
        with collective.rank_world(MESH_2x4):
            full = schedules.all_gather_flat(shard, axes, widths,
                                             schedule=schedule)
            (g,) = torch.autograd.grad((full * w).sum(), shard)
            want = schedules.reduce_scatter_flat(w, axes, chunk, widths,
                                                 schedule=schedule)
        assert torch.equal(g, want)

    def test_bad_schedule_and_one_rank(self):
        with pytest.raises(ValueError, match="flat schedule"):
            schedules.reduce_scatter_flat(torch.ones(1, 4), ["x"], 4,
                                          schedule="ring")
        x = torch.arange(6.0).reshape(1, 6)
        assert torch.equal(schedules.reduce_scatter_flat(x, [], 6), x)
        assert schedules.all_gather_flat(x, []) is x


def _comms(strategy="psum"):
    jc = JCommunicator(devices=jax.devices()[:8], local_size=4,
                       strategy=strategy)
    tc = Communicator(devices=["cpu"] * 8, local_size=4, strategy=strategy)
    return jc, tc


class TestCommunicator:
    def test_metadata(self):
        jc, tc = _comms()
        assert (tc.size, tc.local_size, tc.num_hosts, tc.axis) == \
            (jc.size, jc.local_size, jc.num_hosts, jc.axis)
        assert Communicator(devices=["cpu"] * 4).local_size == 4
        with pytest.raises(ValueError, match="local_size"):
            Communicator(devices=["cpu"] * 6, local_size=4)

    @pytest.mark.parametrize("devices", [["cpu", "cuda:0"],
                                         ["cuda:0", "cuda:1"]])
    def test_distinct_cards_raise(self, devices):
        with pytest.raises(NotImplementedError, match="multi-card"):
            Communicator(devices=devices)

    def test_strategy_table(self):
        jc, tc = _comms()
        for c in (jc, tc):
            c.set_bucket_strategy(1, "pallas_ring")
        for nbytes in (16, 1 << 20):
            assert tc.strategy_for(nbytes) == jc.strategy_for(nbytes)
        assert tc.bucket_strategies() == jc.bucket_strategies()
        tc.set_bucket_strategy(1, None)
        assert tc.bucket_strategies() == {}
        with pytest.raises(ValueError):
            tc.set_bucket_strategy(2, "psum")
        with pytest.raises(ValueError):
            tc.set_bucket_strategy(0, "bogus")

    @pytest.mark.parametrize("strategy", schedules.ALLREDUCE_SCHEDULES)
    @pytest.mark.parametrize("op", ["sum", "mean", "min", "max", "prod"])
    def test_all_reduce(self, strategy, op):
        jc, tc = _comms(strategy)
        x = _data((8, 3, 5), "float32", seed=9)
        ref = np.asarray(jc.all_reduce(jnp.asarray(x), op=op))
        got = tc.all_reduce(torch.from_numpy(x), op=op)
        _close(got, ref, exact=op in ("min", "max"))
        for name in ("local_all_reduce", "cross_all_reduce"):
            ref = np.asarray(getattr(jc, name)(jnp.asarray(x), op=op))
            got = getattr(tc, name)(torch.from_numpy(x), op=op)
            _close(got, ref, exact=op in ("min", "max"))

    @pytest.mark.parametrize("root", [0, 5])
    def test_reduce_broadcast_gather(self, root):
        jc, tc = _comms()
        x = _data((8, 4), "float32", seed=10)
        _close(tc.reduce(torch.from_numpy(x), root=root),
               np.asarray(jc.reduce(jnp.asarray(x), root=root)), exact=False)
        np.testing.assert_array_equal(
            tc.broadcast(torch.from_numpy(x), root=root).numpy(),
            np.asarray(jc.broadcast(jnp.asarray(x), root=root)))
        np.testing.assert_array_equal(
            tc.all_gather(torch.from_numpy(x)).numpy(),
            np.asarray(jc.all_gather(jnp.asarray(x))))
        np.testing.assert_array_equal(
            tc.gather(torch.from_numpy(x), root=root).numpy(),
            np.asarray(jc.gather(jnp.asarray(x), root=root)))
        with pytest.raises(ValueError, match="root"):
            tc.broadcast(torch.from_numpy(x), root=8)

    @pytest.mark.parametrize("strategy", ["psum", "pallas_ring"])
    @pytest.mark.parametrize("op", ["sum", "mean"])
    @pytest.mark.parametrize("shape,bucket_bytes", [((8, 37), 4 << 20),
                                                    ((8, 5, 7), 64)])
    def test_reduce_scatter_and_gather_shard(self, strategy, op, shape,
                                             bucket_bytes):
        jc, tc = _comms()
        for c in (jc, tc):
            c.set_bucket_strategy(0, strategy)
        x = _data(shape, "float32", seed=11)
        ref = np.asarray(jc.reduce_scatter(jnp.asarray(x), op=op,
                                           bucket_bytes=bucket_bytes))
        got = tc.reduce_scatter(torch.from_numpy(x), op=op,
                                bucket_bytes=bucket_bytes)
        assert got.shape == ref.shape
        _close(got, ref, exact=False)
        ref_ag = np.asarray(jc.all_gather_shard(jnp.asarray(ref),
                                                bucket_bytes=bucket_bytes))
        got_ag = tc.all_gather_shard(torch.from_numpy(ref.copy()),
                                     bucket_bytes=bucket_bytes)
        np.testing.assert_array_equal(got_ag.numpy(), ref_ag)

    @pytest.mark.parametrize("fuse", [True, False])
    def test_group_all_reduce_and_barrier(self, fuse):
        jc, tc = _comms()
        xs = [_data((8, 3), "float32", 12), _data((8, 2, 2), "float32", 13)]
        ref = jc.group_all_reduce([jnp.asarray(a) for a in xs], op="mean",
                                  fuse=fuse)
        got = tc.group_all_reduce([torch.from_numpy(a) for a in xs],
                                  op="mean", fuse=fuse)
        for g, r in zip(got, ref):
            _close(g, np.asarray(r), exact=False)
        tc.barrier()
        with pytest.raises(ValueError, match="leading"):
            tc.all_reduce(torch.ones(4, 2))
        with pytest.raises(ValueError, match="op"):
            tc.all_reduce(torch.ones(8, 2), op="bogus")
