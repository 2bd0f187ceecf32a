"""The cross-host pipeline of the port (``kungfu_tpu_torch/parallel/pp.py``)
against the reference's ``kungfu_tpu/parallel/pp.py``.

At the size of ``tests/test_pp.py``'s ``CFG`` (vocab 64, d 16, 4 layers,
2 heads, f32), with torch held to two intra-op threads:

* every pure helper and plan equals the reference's (the stage re-carve
  plan, the chunk splits, the flat layouts and segment plans, the shape
  skeletons), and the segments tile every new stage;
* ``StageModule``'s forward, recompute backward and loss backward equal
  the reference's on the same weights through ``interop``, under
  ``KF_TPU_ATTN=xla`` and under ``auto`` (the flash kernel's plain
  version here); tp = 2 equals tp = 1, and the reference's tp = 2 gives
  the sharded weights ``1/tp`` of their gradient (ROADMAP C23);
* the port's ``HostPipeline`` over port engines is bitwise its own
  ``reference_pipeline_step`` for 1F1B, ragged 1F1B, sequential,
  interleaved, ZeRO-2 with momentum over dp 2, tp 2 and bf16
  activations over the wire; the port's ``reference_pipeline_step``
  equals the reference's within the reference's own tolerances;
* ``StageBoundary``: the planned 2 -> 1 merge bitwise, the mirror blob's
  fields the reference's, the six refusals with the reference's
  exception types, and a chaos ``die_slice`` through
  ``Peer.recover_from_failure`` bitwise a fixed-world replay;
* xray's ``pp_bubble`` over the port's spans.

Every port socket binds port 0 (``start_local_cluster`` finds free
ports); no reference channel is opened here.
"""

import io
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kungfu_tpu.models.transformer import TransformerConfig as JConfig
from kungfu_tpu.parallel import pp as jpp
from kungfu_tpu_torch import chaos, interop
from kungfu_tpu_torch.checkpoint import StepSnapshot
from kungfu_tpu_torch.comm import host
from kungfu_tpu_torch.comm.engine import CollectiveEngine
from kungfu_tpu_torch.comm.faults import PeerFailureError
from kungfu_tpu_torch.models.transformer import TransformerConfig
from kungfu_tpu_torch.optimizers._transform import TraceState, sgd
from kungfu_tpu_torch.parallel import pp
from kungfu_tpu_torch.parallel.train import ParallelPlan
from kungfu_tpu_torch.peer import start_local_cluster
from kungfu_tpu_torch.plan import PeerID, PeerList, Strategy
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_flatten_with_path,
                                         tree_leaves, tree_map)
from tests._util import run_all

SIZE = dict(vocab_size=64, d_model=16, n_layers=4, n_heads=2, d_ff=32,
            max_seq=8)
CFG = TransformerConfig(**SIZE, dtype="float32")
JCFG = JConfig(**SIZE, dtype="float32")
#: StageModule against the reference's on the same weights, f32
OUT_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: the port's reference_pipeline_step against the reference's (the
#: reference's own limits for a step of the sharded trainer,
#: tests/test_parallel.py)
LOSS_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5
CPU = "cpu"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for k in ("KF_CHAOS_SPEC", "KF_TPU_HOST_TRANSPORT", "KF_TPU_ATTN",
              "MEGASCALE_NUM_SLICES", "KF_SLICE_RANKS", "MEGASCALE_SLICE_ID",
              "KF_CONFIG_ENABLE_TRACE", "KF_NATIVE_ENGINE"):
        monkeypatch.delenv(k, raising=False)
    chaos.reset()
    yield
    chaos.reset()
    torch.set_num_threads(threads)


# -- weights and worlds -------------------------------------------------------
def _full(seed, cfg=CFG, jcfg=JCFG):
    """The reference's stacked init and the port's copy of it."""
    jfull = jpp.init_stacked_params(jcfg, jax.random.PRNGKey(seed))
    full = interop.stacked_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jfull), cfg, device=CPU)
    return jfull, full


def _data(seed, B, S=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32))


def _tree_equal(a, b) -> bool:
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    return da == db and all(torch.equal(x, y) for x, y in zip(la, lb))


def _assert_close(got, want, rtol, atol=0.0):
    """A port tree against a reference tree of the same keys (both
    visit dict keys sorted)."""
    gl = tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for (path, g), w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol, err_msg=str(path))


class _World:
    """``n`` port engines over Python channels on ports the OS assigns."""

    def __init__(self, n):
        self.chans = [host.PyHostChannel(PeerID("127.0.0.1", 0),
                                         bind_host="127.0.0.1")
                      for _ in range(n)]
        peers = PeerList.of(*(c.self_id for c in self.chans))
        self.engines = [CollectiveEngine(c, peers, Strategy.STAR)
                        for c in self.chans]

    def close(self):
        for e in self.engines:
            e.close()
        for c in self.chans:
            c.close()


def _run_world(pipes, shards, steps=1):
    """Every rank's train_step in a thread of its own; per-rank last
    losses."""
    outs = [None] * len(pipes)

    def one(i):
        for _ in range(steps):
            outs[i] = pipes[i].train_step(*shards[i])

    run_all([lambda i=i: one(i) for i in range(len(pipes))], timeout=240)
    return outs


def _check_stages(pipes, full, cfg=CFG):
    """Each rank's stage params (every chunk) bitwise the slice of
    ``full``."""
    for pipe in pipes:
        part = pp.interleaved_partition(cfg.n_layers, pipe._S, pipe.v)
        for c in range(pipe.v):
            lo, hi = part[pipe.stage][c]
            vs = c * pipe._S + pipe.stage
            want = pp.slice_stage_params(cfg, full, lo, hi, vs == 0,
                                         vs == pipe._V - 1)
            got = pipe.mods[c].gather(pipe.params[c])
            assert _tree_equal(got, want), \
                f"rank {pipe.rank} chunk {c} diverged from the reference"


# -- pure helpers ---------------------------------------------------------------
class TestPureHelpers:
    @pytest.mark.parametrize("L", [4, 7, 12])
    def test_stage_recarve_plan(self, L):
        for old_n in range(1, min(L, 5) + 1):
            for new_n in range(1, min(L, 5) + 1):
                assert pp.stage_recarve_plan(L, old_n, new_n) == \
                    jpp.stage_recarve_plan(L, old_n, new_n)

    @pytest.mark.parametrize("args", [(5, 12, 20, 8, 16), (0, 0, 37, 5, 7),
                                      (3, 11, 64, 64, 3), (9, 2, 1, 4, 4)])
    def test_chunk_splits(self, args):
        assert list(pp._chunk_splits(*args)) == \
            list(jpp._chunk_splits(*args))

    @pytest.mark.parametrize("pos", ["rope", "learned"])
    def test_shapes_and_flat_layouts(self, pos):
        cfg = TransformerConfig(**SIZE, dtype="float32", pos=pos)
        jcfg = JConfig(**SIZE, dtype="float32", pos=pos)
        for first, last in [(True, False), (False, False), (False, True),
                            (True, True)]:
            got = pp.stage_param_shapes(cfg, 1, 3, first, last)
            want = jpp.stage_param_shapes(jcfg, 1, 3, first, last)
            gl = tree_flatten_with_path(got)[0]
            wl = jax.tree_util.tree_flatten_with_path(want)[0]
            assert [(p, tuple(t.shape), t.device.type) for p, t in gl] == [
                (tuple(k.key for k in p), tuple(s.shape), "meta")
                for p, s in wl]
            assert pp._flat_layout(got, 1) == jpp._flat_layout(want, 1)
        for n in (1, 2, 3, 4):
            smap = pp.stage_partition(cfg.n_layers, n)
            assert pp.stage_flat_layouts(cfg, smap) == \
                jpp.stage_flat_layouts(jcfg, smap)

    @pytest.mark.parametrize("old_n,new_n", [(2, 1), (3, 2), (2, 3),
                                             (4, 2), (1, 1), (1, 4), (4, 3)])
    def test_flat_segments_tile_and_equal_the_reference(self, old_n, new_n):
        old_map = pp.stage_partition(CFG.n_layers, old_n)
        new_map = pp.stage_partition(CFG.n_layers, new_n)
        segs = pp.flat_recarve_segments(CFG, old_map, new_map)
        assert segs == jpp.flat_recarve_segments(JCFG, old_map, new_map)
        old_lay, old_totals = pp.stage_flat_layouts(CFG, old_map)
        new_lay, new_totals = pp.stage_flat_layouts(CFG, new_map)

        def fill(lays, totals):
            flats = []
            for s, lay in enumerate(lays):
                f = np.zeros(totals[s])
                for key, gr0, rows, rowsize, off in lay:
                    for r in range(rows):
                        base = hash((key, gr0 + r)) % 100003
                        f[off + r * rowsize:off + (r + 1) * rowsize] = \
                            base + np.arange(rowsize) * 1e-7
                flats.append(f)
            return flats

        oldf, want = fill(old_lay, old_totals), fill(new_lay, new_totals)
        got = [np.full(t, np.nan) for t in new_totals]
        cover = [np.zeros(t, bool) for t in new_totals]
        for (os_, oo, ns, no, ln) in segs:
            assert not cover[ns][no:no + ln].any(), "segment overlap"
            cover[ns][no:no + ln] = True
            got[ns][no:no + ln] = oldf[os_][oo:oo + ln]
        for ns in range(new_n):
            assert cover[ns].all(), "new stage flat not tiled"
            assert np.array_equal(got[ns], want[ns])

    def test_segments_refuse_a_foreign_map(self):
        for mod, cfg in ((pp, CFG), (jpp, JCFG)):
            with pytest.raises(ValueError, match="stage_partition"):
                mod.flat_recarve_segments(cfg, [(0, 1), (1, 4)],
                                          [(0, 4)])

    def test_tree_flatten_with_path_is_jax_order(self):
        tree = {"b": [np.ones(1), {"z": np.ones(2), "a": np.ones(3)}],
                "a": (np.ones(4), np.ones(5)), "c": {"y": np.ones(6)}}
        got = tree_flatten_with_path(tree)[0]
        want = jax.tree_util.tree_flatten_with_path(tree)[0]

        def key(k):
            return getattr(k, "key", getattr(k, "idx", None))

        assert [(p, l.size) for p, l in got] == \
            [(tuple(key(k) for k in p), l.size) for p, l in want]
        st = TraceState(trace=torch.ones(2))
        assert tree_flatten_with_path(st)[0][0][0] == ("trace",)

    def test_stage_restore_plan(self):
        from kungfu_tpu.elastic import persist as jpersist
        from kungfu_tpu_torch.elastic import persist

        for old_n, new_n in [(4, 2), (2, 1), (3, 4), (1, 3)]:
            assert persist.stage_restore_plan(12, old_n, new_n) == \
                jpersist.stage_restore_plan(12, old_n, new_n)


# -- weights through interop -------------------------------------------------------
class TestInterop:
    def test_stacked_round_trip(self):
        jfull, full = _full(0)
        _assert_close(full, jfull, 0.0)
        back = interop.params_to_jax(full)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jfull)):
            assert np.array_equal(a, np.asarray(b))

    def test_layout_equals_the_reference(self):
        full = pp.init_stacked_params(CFG, device=CPU)
        jfull = jpp.init_stacked_params(JCFG, jax.random.PRNGKey(0))
        got = [(p, tuple(t.shape)) for p, t in
               tree_flatten_with_path(full)[0]]
        want = [(tuple(k.key for k in p), tuple(a.shape)) for p, a in
                jax.tree_util.tree_flatten_with_path(jfull)[0]]
        assert got == want
        for first, last in [(True, False), (False, True)]:
            st = pp.slice_stage_params(CFG, full, 1, 3, first, last)
            jst = jpp.slice_stage_params(JCFG, jfull, 1, 3, first, last)
            assert [tuple(t.shape) for t in tree_leaves(st)] == \
                [a.shape for a in jax.tree_util.tree_leaves(jst)]

    def test_refuses_a_foreign_depth(self):
        jfull, _ = _full(0)
        with pytest.raises(ValueError, match="rows"):
            interop.stacked_params_from_jax(
                jax.tree_util.tree_map(np.asarray, jfull),
                TransformerConfig(**{**SIZE, "n_layers": 3}), device=CPU)


# -- one stage's math ------------------------------------------------------------
STAGES = [(0, 2, True, False), (1, 3, False, False), (2, 4, False, True),
          (0, 4, True, True)]


def _stage_pair(full, jfull, lo, hi, first, last, tp=1, jtp=1):
    mod = pp.StageModule(CFG, lo, hi, first=first, last=last, tp=tp,
                         device=CPU)
    jmod = jpp.StageModule(JCFG, lo, hi, first=first, last=last, tp=jtp,
                           devices=jax.devices()[:jtp] if jtp > 1 else None)
    p = mod.place(pp.slice_stage_params(CFG, full, lo, hi, first, last))
    jp = jmod.place(jpp.slice_stage_params(JCFG, jfull, lo, hi, first,
                                           last))
    return mod, p, jmod, jp


def _stage_inputs(seed, first):
    """Ids or an activation, the cotangent of the output and targets for
    one [2, 8] microbatch.  The cotangent is at the scale a stage
    receives from the mean loss over the microbatch's tokens (normal
    over B * S), as ``GRAD_ATOL`` assumes."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32) if first
         else rng.standard_normal((2, 8, CFG.d_model)).astype(np.float32))
    dout = (rng.standard_normal((2, 8, CFG.d_model)) / 16).astype(np.float32)
    tgt = rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    return x, dout, tgt


class TestStageModule:
    @pytest.mark.parametrize("attn", ["xla", "auto"])
    @pytest.mark.parametrize("lo,hi,first,last", STAGES)
    def test_against_the_reference(self, attn, lo, hi, first, last,
                                   monkeypatch):
        """Under ``auto`` the port's stage takes the flash kernel's plain
        version (C22) where the reference's takes the plain softmax; the
        same limits hold for both."""
        monkeypatch.setenv("KF_TPU_ATTN", attn)
        jfull, full = _full(1)
        mod, p, jmod, jp = _stage_pair(full, jfull, lo, hi, first, last)
        x, dout, tgt = _stage_inputs(2, first)
        if last:
            loss, g, dx = mod.loss_backward(p, x, tgt)
            jloss, jg, jdx = jmod.loss_backward(jp, x, tgt)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=OUT_RTOL)
        else:
            np.testing.assert_allclose(mod.forward(p, x).numpy(),
                                       np.asarray(jmod.forward(jp, x)),
                                       rtol=OUT_RTOL, atol=1e-6)
            g, dx = mod.backward(p, x, dout)
            jg, jdx = jmod.backward(jp, x, dout)
        _assert_close(g, jg, GRAD_RTOL, GRAD_ATOL)
        if first:
            assert dx is None and jdx is None
        else:
            np.testing.assert_allclose(dx.numpy(), np.asarray(jdx),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)

    def test_loss_backward_belongs_to_the_last_stage(self):
        mod = pp.StageModule(CFG, 0, 2, first=True, last=False, device=CPU)
        with pytest.raises(ValueError, match="last stage"):
            mod.loss_backward({}, np.zeros((1, 8), np.int32),
                              np.zeros((1, 8), np.int32))

    def test_no_graph_between_forward_and_backward(self):
        _, full = _full(1)
        mod = pp.StageModule(CFG, 1, 3, first=False, last=False, device=CPU)
        p = mod.place(pp.slice_stage_params(CFG, full, 1, 3, False, False))
        x, dout, _ = _stage_inputs(3, False)
        out = mod.forward(p, x)
        assert out.grad_fn is None and not out.requires_grad
        g, dx = mod.backward(p, x, dout)
        assert all(t.grad_fn is None for t in tree_leaves(g))
        assert all(not t.requires_grad for t in tree_leaves(p))

    def test_tp_refuses_an_uneven_split(self):
        for mod, cfg, kw in ((pp, CFG, {"device": CPU}), (jpp, JCFG, {})):
            with pytest.raises(ValueError, match="must divide"):
                mod.StageModule(cfg, 0, 2, first=True, last=False, tp=3,
                                **kw)

    @pytest.mark.parametrize("lo,hi,first,last", STAGES)
    def test_tp2_equals_tp1_and_pins_the_reference_tp(self, lo, hi, first,
                                                       last, monkeypatch):
        """tp = 2 over two co-resident ranks gives tp = 1's outputs and
        gradients; the reference's tp = 2 stage gives its sharded
        weights 1/tp of theirs and every other leaf the same (C23)."""
        monkeypatch.setenv("KF_TPU_ATTN", "xla")
        jfull, full = _full(4)
        mod1, p1, _, _ = _stage_pair(full, jfull, lo, hi, first, last)
        mod2, p2, jmod2, jp2 = _stage_pair(full, jfull, lo, hi, first, last,
                                           tp=2, jtp=2)
        assert _tree_equal(mod2.gather(p2), p1)
        x, dout, tgt = _stage_inputs(5, first)
        if last:
            l1, g1, dx1 = mod1.loss_backward(p1, x, tgt)
            l2, g2, dx2 = mod2.loss_backward(p2, x, tgt)
            _, jg2, jdx2 = jmod2.loss_backward(jp2, x, tgt)
            np.testing.assert_allclose(float(l2), float(l1), rtol=OUT_RTOL)
        else:
            np.testing.assert_allclose(mod2.forward(p2, x).numpy(),
                                       mod1.forward(p1, x).numpy(),
                                       rtol=OUT_RTOL, atol=1e-6)
            g1, dx1 = mod1.backward(p1, x, dout)
            g2, dx2 = mod2.backward(p2, x, dout)
            jg2, jdx2 = jmod2.backward(jp2, x, dout)
        g2 = mod2.gather(g2)
        for (path, a), b in zip(tree_flatten_with_path(g2)[0],
                                tree_leaves(g1)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=str(path))
        sharded = {("layers", n, k) for n in ("wq", "wk", "wv", "ffn_in")
                   for k in ("w", "b")} | {("layers", "wo", "w"),
                                           ("layers", "ffn_out", "w")}
        for (path, a), b in zip(tree_flatten_with_path(g2)[0],
                                jax.tree_util.tree_leaves(jg2)):
            scale = 0.5 if path in sharded else 1.0
            np.testing.assert_allclose(a.numpy() * scale, np.asarray(b),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=str(path))
        if not first:
            np.testing.assert_allclose(dx2.numpy(), dx1.numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
            np.testing.assert_allclose(dx2.numpy(), np.asarray(jdx2),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


# -- the bitwise spine --------------------------------------------------------------
def _pipeline_case(plan, seed, inner_fn, shards, cfg=CFG, jcfg=JCFG,
                   steps=1):
    _, full = _full(seed, cfg, jcfg)
    ref, states = full, None
    for _ in range(steps):
        ref, ref_losses, states = pp.reference_pipeline_step(
            cfg, plan, ref, shards, inner_fn(), opt_states=states,
            device=CPU)
    world = _World(plan.pp * plan.dp)
    try:
        pipes = [pp.HostPipeline(e, plan, cfg, full_params=full,
                                 inner=inner_fn(), device=CPU)
                 for e in world.engines]
        outs = _run_world(pipes, [shards[i % plan.dp]
                                  for i in range(len(pipes))], steps)
        for i, pipe in enumerate(pipes):
            if pipe.stage == plan.pp - 1:
                assert outs[i] == float(np.mean(ref_losses[i % plan.dp]))
            else:
                assert outs[i] is None
            assert pipe.step_count == steps
        _check_stages(pipes, ref, cfg)
    finally:
        world.close()


class TestPipelineBitwise:
    @pytest.mark.parametrize("S,m,sched", [(2, 4, "1f1b"), (2, 3, "1f1b"),
                                           (2, 4, "sequential")])
    def test_bitwise_vs_reference_step(self, S, m, sched):
        plan = ParallelPlan(pp=S, n_micro=m, pp_schedule=sched)
        _pipeline_case(plan, 0, lambda: sgd(0.05), [_data(7, B=m * 2)])

    def test_gradients_are_what_the_step_applies(self):
        """``pipeline_gradients`` is the first half of the reference step:
        a plain sgd step from it is bitwise the step's params."""
        plan = ParallelPlan(pp=2, dp=2, n_micro=2)
        _, full = _full(13)
        shards = [_data(50 + d, B=4) for d in range(2)]
        new, losses, _ = pp.reference_pipeline_step(
            CFG, plan, full, shards, sgd(0.05), device=CPU)
        grads, glosses = pp.pipeline_gradients(CFG, plan, full, shards,
                                               device=CPU)
        assert glosses == losses
        assert _tree_equal(new, tree_map(lambda p, g: p + (-0.05 * g),
                                         full, grads))

    def test_interleaved(self):
        plan = ParallelPlan(pp=2, n_micro=4, pp_schedule="interleaved",
                            interleave=2)
        _pipeline_case(plan, 2, lambda: sgd(0.05), [_data(9, B=8)])

    @pytest.mark.parametrize("zero,momentum", [(2, 0.9), (2, None),
                                               (0, 0.9)])
    def test_pp_dp(self, zero, momentum):
        """pp 2 x dp 2: the bucketed dp reduce-scatter and the chunked
        (or replicated) update, two steps, bitwise the replicated
        reference."""
        plan = ParallelPlan(pp=2, dp=2, n_micro=2, zero_stage=zero)
        _pipeline_case(plan, 3, lambda: sgd(0.05, momentum=momentum),
                       [_data(10 + d, B=4) for d in range(2)], steps=2)

    def test_tp_within_stage(self):
        plan = ParallelPlan(pp=2, tp=2, n_micro=2)
        _pipeline_case(plan, 6, lambda: sgd(0.05), [_data(12, B=4)])

    def test_bf16_activations_over_the_wire(self):
        cfg = TransformerConfig(**SIZE, dtype="bfloat16")
        jcfg = JConfig(**SIZE, dtype="bfloat16")
        plan = ParallelPlan(pp=2, dp=2, n_micro=2, zero_stage=2)
        _pipeline_case(plan, 8, lambda: sgd(0.05, momentum=0.9),
                       [_data(30 + d, B=4) for d in range(2)], cfg, jcfg)

    def test_validation(self):
        world = _World(2)
        try:
            e = world.engines[0]
            _, full = _full(0)
            with pytest.raises(ValueError, match="does not tile"):
                pp.HostPipeline(e, ParallelPlan(pp=4), CFG, full_params=full,
                                device=CPU)
            with pytest.raises(ValueError, match="zero_stage=1"):
                pp.HostPipeline(e, ParallelPlan(pp=2, zero_stage=1), CFG,
                                full_params=full, device=CPU)
            with pytest.raises(ValueError, match="exceeds the async pool"):
                pp.HostPipeline(e, ParallelPlan(pp=2), CFG,
                                full_params=full, device=CPU, prefetch=3)
            with pytest.raises(ValueError, match="full_params"):
                pp.HostPipeline(e, ParallelPlan(pp=2), CFG, device=CPU)
            pipe = pp.HostPipeline(e, ParallelPlan(pp=2, n_micro=3), CFG,
                                   full_params=full, device=CPU)
            with pytest.raises(ValueError, match="n_micro"):
                pipe.train_step(*_data(0, B=4))
            assert pipe.stage_layers() == (0, 2)
            assert e.overlap_depth >= 8
        finally:
            world.close()


class TestReferenceParity:
    @pytest.mark.parametrize("plan", [
        ParallelPlan(pp=2, dp=2, n_micro=2, zero_stage=2),
        ParallelPlan(pp=2, n_micro=4, pp_schedule="interleaved",
                     interleave=2)], ids=["pp2dp2", "interleaved"])
    def test_step_against_the_reference(self, plan, monkeypatch):
        monkeypatch.setenv("KF_TPU_ATTN", "xla")
        jfull, full = _full(11)
        shards = [_data(40 + d, B=4) for d in range(plan.dp)]
        got, losses, _ = pp.reference_pipeline_step(
            CFG, plan, full, shards, sgd(0.05, momentum=0.9), device=CPU)
        want, jlosses, _ = jpp.reference_pipeline_step(
            JCFG, plan_j(plan), jfull, shards, optax.sgd(0.05, momentum=0.9))
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
        _assert_close(got, want, STEP_RTOL, STEP_ATOL)


def plan_j(plan):
    """The reference's ParallelPlan of the same fields."""
    from kungfu_tpu.parallel.train import ParallelPlan as JPlan

    return JPlan(dp=plan.dp, pp=plan.pp, tp=plan.tp, n_micro=plan.n_micro,
                 pp_schedule=plan.pp_schedule, interleave=plan.interleave,
                 zero_stage=plan.zero_stage)


# -- elastic stage boundary -----------------------------------------------------------
def _close_peers(peers):
    for p in peers:
        try:
            p.close()
        except Exception:  # noqa: BLE001 - best effort
            pass


def _boundaries(step, stage, n_stages, dp, dp_index, lo, hi, zero=2,
                momentum=0.9, chunk=4):
    """The same committed stage on a port and a reference boundary."""
    jfull, full = _full(0)
    first, last = stage == 0, stage == n_stages - 1
    trace = np.random.default_rng(step).standard_normal(chunk).astype(
        np.float32)
    sb, jsb = pp.StageBoundary(), jpp.StageBoundary()
    sb.commit(step, CFG, stage, n_stages, dp, dp_index,
              pp.slice_stage_params(CFG, full, lo, hi, first, last),
              TraceState(torch.from_numpy(trace)), zero)
    jsb.commit(step, JCFG, stage, n_stages, dp, dp_index,
               jpp.slice_stage_params(JCFG, jfull, lo, hi, first, last),
               (optax.TraceState(trace=jnp.asarray(trace)),
                optax.EmptyState()), zero)
    return sb, jsb


class TestStageBoundary:
    def test_blob_fields_equal_the_reference(self):
        sb, jsb = _boundaries(3, 1, 2, 2, 1, 2, 4)
        with np.load(io.BytesIO(sb._blob())) as z, \
                np.load(io.BytesIO(jsb._blob())) as jz:
            assert sorted(z.files) == sorted(jz.files) == \
                ["meta", "pflat", "v0"]
            for k in z.files:
                assert z[k].dtype == jz[k].dtype
                assert np.array_equal(z[k], jz[k])

    @pytest.mark.parametrize("case", [
        "partial", "dead_buddy", "missing_mirror", "stale_mirror",
        "step_gate", "stateful_replicated"])
    def test_refusals_match_the_reference(self, case):
        outcomes = []
        for mod in (pp, jpp):
            try:
                _refusal(mod, case)
            except Exception as e:  # noqa: BLE001 - compared below
                outcomes.append((type(e), str(e)))
            else:
                outcomes.append((None, ""))
        (t, msg), (jt, jmsg) = outcomes
        assert t is not None and t is jt and msg == jmsg

    def test_planned_merge_2_to_1(self, monkeypatch):
        """A planned 2-stage -> 1-stage merge (no deaths: the leaving
        stage serves its own spans): the restored params and ZeRO
        momentum chunk are bitwise the merged originals, the leaver
        drops its state."""
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        plan = ParallelPlan(pp=2, dp=1, n_micro=2, zero_stage=2)
        _, full = _full(4)
        peers = start_local_cluster(2, env={"KF_ALLREDUCE_STRATEGY": "STAR"},
                                    devices=[CPU])
        try:
            pipes = [pp.HostPipeline(p.engine(), plan, CFG, full_params=full,
                                     inner=sgd(0.05, momentum=0.9),
                                     peer=p, device=CPU) for p in peers]
            _run_world(pipes, [_data(11, B=4)] * 2)
            sbs = [pp.StageBoundary() for _ in pipes]
            for pipe, sb in zip(pipes, sbs):
                pipe.commit_boundary(sb)
            workers = peers[0].cluster.workers
            sent = run_all([lambda i=i: sbs[i].replicate_ring(
                peers[i].channel, workers, tag="s1") for i in range(2)])
            assert sent[0] == len(sbs[0]._blob())
            new_workers = workers.select([0])
            run_all([lambda i=i: sbs[i].recarve(
                1, peer=peers[i], old_workers=workers,
                new_workers=new_workers, tag="t") for i in range(2)])
            # the stayer assembles; the leaver serves its whole stage
            stats = [sb.last_recarve for sb in sbs]
            assert stats[0]["sent_param_bytes"] == 0 == \
                stats[0]["sent_opt_bytes"]
            assert stats[1]["sent_param_bytes"] == \
                4 * pipes[1]._flat_shapes[0]
            assert stats[1]["sent_opt_bytes"] == \
                4 * pipes[1]._flat_shapes[0]
            stage, n, params, opt = sbs[0].restore()
            assert (stage, n) == (0, 1)
            merged = pp.merge_stage_trees(
                CFG, 2, 1, [pipes[0].params[0], pipes[1].params[0]])
            assert _tree_equal(params, merged)
            smap = plan.stage_map(CFG.n_layers)
            traces = []
            for i, pipe in enumerate(pipes):
                lo, hi = smap[i]
                leaves, td = tree_flatten(pp.stage_param_shapes(
                    CFG, lo, hi, i == 0, i == 1))
                t = pipe.opt_state[0].trace[: pipe._flat_shapes[0]]
                traces.append(pp._unflatten_like(leaves, td, t))
            want = torch.cat([l.reshape(-1) for l in tree_leaves(
                pp.merge_stage_trees(CFG, 2, 1, traces))])
            assert torch.equal(opt.trace[: want.numel()], want)
            with pytest.raises(ValueError, match="restore before"):
                sbs[1].restore()
            # the restored boundary rebuilds a one-stage pipeline whose
            # step is bitwise the merged world's reference step
            plan1 = ParallelPlan(pp=1, n_micro=2, zero_stage=2)
            world = _World(1)
            try:
                pipe1 = pp.HostPipeline.from_boundary(
                    world.engines[0], plan1, CFG, sbs[0],
                    inner=sgd(0.05, momentum=0.9), device=CPU)
                assert pipe1.step_count == 1
                _run_world([pipe1], [_data(12, B=4)])
            finally:
                world.close()
            want, _, _ = pp.reference_pipeline_step(
                CFG, plan1, merged, [_data(12, B=4)],
                sgd(0.05, momentum=0.9), device=CPU,
                opt_states=[TraceState(pp.merge_stage_trees(CFG, 2, 1,
                                                            traces))])
            _check_stages([pipe1], want)
        finally:
            _close_peers(peers)

    def test_from_boundary_refuses_a_foreign_carve(self):
        sb, _ = _boundaries(1, 0, 1, 1, 0, 0, 4)
        world = _World(2)
        try:
            with pytest.raises(ValueError, match="recarve first"):
                pp.HostPipeline.from_boundary(
                    world.engines[0], ParallelPlan(pp=2), CFG, sb,
                    device=CPU)
        finally:
            world.close()


def _refusal(mod, case):
    """One of the reference's TestStageRecarve refusals on ``mod``'s
    StageBoundary (the port's or the reference's)."""
    port = mod is pp
    cfg = CFG if port else JCFG
    full = _full(0)[1] if port else \
        jpp.init_stacked_params(JCFG, jax.random.PRNGKey(0))

    def opt(momentum=None, params=None):
        if port:
            return sgd(0.1, momentum=momentum).init(
                torch.zeros(4) if params is None else params)
        return optax.sgd(0.1, momentum=momentum).init(
            jnp.zeros((4,)) if params is None else params)

    sb = mod.StageBoundary()
    if case == "partial":
        sb.commit(1, cfg, 0, 2, 2, 0, mod.slice_stage_params(
            cfg, full, 0, 2, True, False), opt(), 2)
        sb.recarve(1, dead=[2])
    elif case == "dead_buddy":
        sb.commit(1, cfg, 0, 4, 1, 0, mod.slice_stage_params(
            cfg, full, 0, 1, True, False), opt(), 2)
        sb.recarve(2, dead=[2, 3])
    elif case == "missing_mirror":
        sb.commit(1, cfg, 0, 2, 1, 0, mod.slice_stage_params(
            cfg, full, 0, 2, True, False), opt(), 2)
        sb.recarve(1, dead=[1])
    elif case == "stale_mirror":
        sb.commit(5, cfg, 0, 2, 1, 0, mod.slice_stage_params(
            cfg, full, 0, 2, True, False), opt(), 2)
        sb._buddy = {"pflat": np.zeros(4, np.float32),
                     "meta": np.array([4, 1, 2, 1, 0, 2], np.int64),
                     "vec": {}}
        sb._buddy_stage = 1
        sb.recarve(1, dead=[1])
    elif case == "step_gate":
        sb.commit(5, cfg, 0, 1, 1, 0, mod.slice_stage_params(
            cfg, full, 0, 4, True, True), opt(), 2)
        sb.recarve(1, expect_step=4)
    else:
        params = mod.slice_stage_params(cfg, full, 0, 4, True, True)
        sb.commit(1, cfg, 0, 1, 1, 0, params, opt(0.9, params), 0)


class TestChaosSliceLossRecarve:
    """A two-slice world (pp 2 across the slices, dp 2 within, tp 2 over
    each rank's co-resident pair, ZeRO-2 with momentum) trains through a
    chaos ``die_slice`` with one stage re-carve: the dead stage's params
    and optimizer chunks come from the predecessor slice's mirrors, and
    the step after it is bitwise a fixed-world replay from the same
    boundary."""

    def test_die_slice_recarve_bitwise(self, monkeypatch):
        monkeypatch.setenv("KF_TPU_HOST_TRANSPORT", "python")
        monkeypatch.setenv("KF_NATIVE_ENGINE", "0")
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        monkeypatch.setenv("KF_SLICE_RANKS", "2")
        monkeypatch.setenv("KF_CHAOS_SPEC",
                           "die_slice:slice=1,step=2,mode=raise,rps=2")
        # the tiny stages compute in milliseconds: a short deadline keeps
        # the post-kill detection bounded
        monkeypatch.setenv("KF_CONFIG_PEER_DEADLINE", "4")
        plan = ParallelPlan(pp=2, dp=2, tp=2, n_micro=2, zero_stage=2)
        _, full = _full(5)
        shards = [_data(20 + d, B=4) for d in range(2)]
        peers = start_local_cluster(4, env={"KF_ALLREDUCE_STRATEGY": "STAR"},
                                    devices=[CPU])
        results = [None] * 4

        def worker(i):
            pipe = pp.HostPipeline(peers[i].engine(), plan, CFG,
                                   full_params=full,
                                   inner=sgd(0.05, momentum=0.9),
                                   peer=peers[i], device=CPU)
            sb, snap = pp.StageBoundary(), StepSnapshot()
            ids, tgt = shards[i % 2]
            try:
                pipe.warmup(ids.shape[0], ids.shape[1])
                for s in (0, 1):
                    chaos.note_step(peers[i].chaos_rank(), s)
                    pipe.train_step(ids, tgt)
                pipe.commit_boundary(sb)
                sb.replicate_ring(peers[i].channel,
                                  peers[i].cluster.workers, tag="b2")
                snap.commit(2, {"anchor": np.int64(2)})
                chaos.note_step(peers[i].chaos_rank(), 2)
                pipe.train_step(ids, tgt)
                results[i] = ("no-death", None)
            except chaos.InjectedDeath:
                peers[i].close()
                results[i] = ("died", None)
            except PeerFailureError as err:
                shrunk, replay = peers[i].recover_from_failure(
                    err, snapshot=snap, stage_boundary=sb)
                assert shrunk and replay is not None and replay[0] == 2
                pipe2 = pp.HostPipeline.from_boundary(
                    peers[i].engine(), plan.with_stages(1), CFG, sb,
                    inner=sgd(0.05, momentum=0.9), peer=peers[i],
                    device=CPU)
                assert pipe2.stage_layers() == (0, CFG.n_layers)
                assert pipe2.step_count == 2
                pipe2.warmup(ids.shape[0], ids.shape[1])
                pipe2.train_step(ids, tgt)
                results[i] = ("recovered", pipe2, sb.last_recarve)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(4)]
        try:
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            assert not any(t.is_alive() for t in ts), "recovery hung"
            assert [r[0] for r in results] == ["recovered", "recovered",
                                               "died", "died"]
            full1, states1 = full, None
            for _ in range(2):
                full1, _, states1 = pp.reference_pipeline_step(
                    CFG, plan, full1, shards, sgd(0.05, momentum=0.9),
                    opt_states=states1, device=CPU)
            merged = TraceState(pp.merge_stage_trees(
                CFG, 2, 1, [states1[0].trace, states1[1].trace]))
            full2, _, _ = pp.reference_pipeline_step(
                CFG, plan.with_stages(1), full1, shards,
                sgd(0.05, momentum=0.9), opt_states=[merged], device=CPU)
            want = pp.slice_stage_params(CFG, full2, 0, CFG.n_layers, True,
                                         True)
            for i in (0, 1):
                # the dead stage's params come from the lane's own mirror
                assert results[i][2]["sent_param_bytes"] == 0
                pipe2 = results[i][1]
                assert _tree_equal(pipe2.mods[0].gather(pipe2.params[0]),
                                   want), \
                    "post-re-carve step diverged from the fixed-world replay"
        finally:
            _close_peers(peers[:2])


# -- xray's bubble phase ------------------------------------------------------------
class TestXrayBubble:
    def test_pp_bubble_over_the_port_spans(self, monkeypatch):
        """A traced two-stage run: the port's xray and the reference's
        split the port's spans identically, and the pipeline's waits
        show as a ``pp_bubble`` phase."""
        from kungfu_tpu.monitor import xray as jxray
        from kungfu_tpu_torch.monitor import timeline, xray

        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        plan = ParallelPlan(pp=2, n_micro=4, pp_schedule="sequential")
        _, full = _full(0)
        world = _World(2)
        try:
            pipes = [pp.HostPipeline(e, plan, CFG, full_params=full,
                                     device=CPU) for e in world.engines]
            cursor, _ = timeline.events_tail(0)
            _run_world(pipes, [_data(3, B=8)] * 2)
            _, evs = timeline.events_tail(cursor)
        finally:
            world.close()
        pp_evs = [e for e in evs if e.get("kind") == "pp"]
        assert {e["name"] for e in pp_evs} == {"fwd", "bwd", "bubble"}
        bubble = 0.0
        for r in (0, 1):
            mine = [e for e in evs if e.get("rank") == r]
            split = xray.rank_phase_split(mine)
            assert split == jxray.rank_phase_split(mine)
            bubble += split["pp_bubble"]
        assert bubble > 0

    def test_pp_bubble_is_a_distinct_phase(self):
        from kungfu_tpu_torch.monitor import xray

        t0 = 1000.0
        evs = [
            {"ts": t0, "rank": 0, "step": 1, "kind": "pp",
             "name": "bubble", "dur": 0.2, "attrs": {"stage": 1}},
            {"ts": t0 + 0.2, "rank": 0, "step": 1, "kind": "pp",
             "name": "fwd", "dur": 0.3, "attrs": {"stage": 1}},
            {"ts": t0 + 0.5, "rank": 0, "step": 1, "kind": "collective",
             "name": "engine.all_reduce", "dur": 0.1,
             "attrs": {"tag": "g1", "op": "all_reduce"}},
        ]
        split = xray.rank_phase_split(evs)
        assert split["pp_bubble"] == pytest.approx(0.2)
        assert split["comm_exposed"] == pytest.approx(0.1)
        assert split["compute"] == pytest.approx(0.3)
        assert "pp_bubble" in xray.PHASES and "pp" in xray.XRAY_KINDS
