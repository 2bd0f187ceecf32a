"""Port parity: the in-process host-plane examples (``overlap_pipeline``,
``pp_demo``, ``adapt_interference``), each called through its
``main(argv)`` at its defaults and passing its own assertions, the
wall-clock ones included (overlap > 0, 1F1B faster than sequential by
more than 1.1x, the steady step below the degraded one: each under the
chaos layer's 25-30 ms of injected wire delay, which dwarfs this host's
noise), then held against the JAX package:

* ``overlap_pipeline``: both runs' final params bitwise a numpy replay
  of the bucket loop over the reference's ``host_bucket_spans``;
* ``pp_demo``: both schedules' stage params, merged, bitwise the port's
  single-process ``reference_pipeline_step`` over the same three steps,
  and against the reference's ``reference_pipeline_step`` from the same
  weights (``interop.stacked_params_from_jax``) at ``rtol 2e-4, atol
  2e-5`` (``test_torch_port_pp.py``'s step tolerance);
* ``adapt_interference``: the bandit swaps off the throttled STAR onto
  the MST arm, as the reference's drill does.

Every main scopes its environment: each test also checks that
``os.environ`` is the same after the call.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu_torch import chaos, interop
from kungfu_tpu_torch.examples import (adapt_interference, overlap_pipeline,
                                       pp_demo)

STEP_RTOL, STEP_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("KF_TPU_USE_UNIXSOCK", "0")
    for k in ("KF_CHAOS_SPEC", "KF_CONFIG_ENABLE_MONITORING",
              "KF_CONFIG_ENABLE_CLUSTER_MONITOR", "KF_CONFIG_ENABLE_TRACE",
              "KF_JAX_PLATFORM", "KF_NATIVE_ENGINE"):
        monkeypatch.delenv(k, raising=False)
    chaos.reset()
    yield
    chaos.reset()
    torch.set_num_threads(threads)


def _run(mod, argv=()):
    before = dict(os.environ)
    report = {}
    assert mod.main(list(argv), report) == 0
    assert dict(os.environ) == before
    return report


# -- overlap_pipeline ------------------------------------------------------------

def _overlap_replay(steps: int) -> np.ndarray:
    """The bucket loop in plain numpy: every rank holds the same params,
    so a bucket's reduce-scatter sum is three times the gradient."""
    from kungfu_tpu.parallel.zero import host_bucket_spans

    n, chunk, nb = (overlap_pipeline.N_RANKS, overlap_pipeline.CHUNK,
                    overlap_pipeline.N_BUCKETS)
    widths = [chunk // nb] * nb
    spans = host_bucket_spans(chunk, widths)
    lr, mu = np.float32(0.125), np.float32(0.5)
    params = (np.arange(n * chunk, dtype=np.float32) % 64) / 64
    moms = [np.zeros(chunk, np.float32) for _ in range(n)]
    for k in range(steps):
        g = params * np.float32(0.5) + np.float32(2.0 ** -(k + 2))
        owns = []
        for i in range(n):
            own = params[i * chunk:(i + 1) * chunk].copy()
            for off, w in spans:
                sl = slice(i * chunk + off, i * chunk + off + w)
                red = (g[sl] + g[sl]) + g[sl]
                m = moms[i][off:off + w] * mu + red
                moms[i][off:off + w] = m
                own[off:off + w] -= lr * m
            owns.append(own)
        params = np.concatenate(owns)
    return params


def test_overlap_pipeline():
    rep = _run(overlap_pipeline)
    assert rep["pipelined_s"] < rep["serial_s"]
    want = _overlap_replay(4)
    assert rep["final_serial"].tobytes() == want.tobytes()
    assert rep["final_pipelined"].tobytes() == want.tobytes()


# -- pp_demo -------------------------------------------------------------------

def test_pp_demo(capsys):
    rep = _run(pp_demo)
    out = capsys.readouterr().out
    assert "stage re-carve 2 -> 1: merged world restored bitwise" in out
    assert "pp-demo OK" in out
    assert rep["times"]["sequential"] > 1.1 * rep["times"]["1f1b"]


def test_pp_demo_matches_reference(monkeypatch):
    """The demo's two schedules from the reference's stacked init: each
    bitwise the port's fixed-world replay, and the replay against the
    reference's."""
    from kungfu_tpu.models.transformer import TransformerConfig as JConfig
    from kungfu_tpu.parallel import pp as jpp
    from kungfu_tpu.parallel.train import ParallelPlan as JPlan
    from kungfu_tpu_torch.examples._local import scoped_env
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel import pp
    from kungfu_tpu_torch.parallel.train import ParallelPlan
    from kungfu_tpu_torch.utils.tree import tree_flatten

    monkeypatch.setenv("KF_TPU_ATTN", "xla")  # the reference's plain attention
    cfg = pp_demo.config()
    jcfg = JConfig(**vars(cfg))
    jfull = jpp.init_stacked_params(jcfg, jax.random.PRNGKey(0))
    full = interop.stacked_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jfull), cfg, device="cpu")
    ids, tgt = pp_demo.batch()
    with scoped_env(default=pp_demo.ENV_DEFAULT):
        finals, _ = pp_demo.schedules(full, ids, tgt)

    plan = ParallelPlan(pp=2, n_micro=4, pp_schedule="sequential")
    want, states = full, None
    for _ in range(pp_demo.STEPS):
        want, _, states = pp.reference_pipeline_step(
            cfg, plan, want, [(ids, tgt)], sgd(0.125), opt_states=states,
            device="cpu")
    wl, _ = tree_flatten(want)
    for sched, stages in finals.items():
        gl, _ = tree_flatten(pp.merge_stage_trees(cfg, 2, 1, stages))
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a.numpy().tobytes() == b.numpy().tobytes(), sched

    jplan = JPlan(pp=2, n_micro=4, pp_schedule="sequential")
    jwant, jstates = jfull, None
    for _ in range(pp_demo.STEPS):
        jwant, _, jstates = jpp.reference_pipeline_step(
            jcfg, jplan, jwant, [(ids, tgt)], optax.sgd(0.125),
            opt_states=jstates)
    jl = jax.tree_util.tree_leaves(jwant)
    assert len(jl) == len(wl)
    for a, b in zip(wl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)


# -- adapt_interference ----------------------------------------------------------

def test_adapt_interference(capsys):
    rep = _run(adapt_interference)
    assert "adapt-demo: swap fired at step" in capsys.readouterr().out
    assert rep["arm"] != "STAR"
    assert rep["steady_s"] < rep["degraded_s"]
