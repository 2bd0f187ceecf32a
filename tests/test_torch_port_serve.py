"""Port parity: the continuous-batching engine against the JAX engine.

The same scripted traffic (submits, steps, cancels, width changes) runs
through the reference's ``InferenceEngine`` and the port's, on the same
weights carried across by kungfu_tpu_torch.interop, in f32 on the CPU.
Every event — admissions with their reused/computed token counts,
every token, every completion — must be identical; only wall-clock
fields are dropped.  The scenarios mirror tests/test_serve.py:61-196.
"""

import numpy as np
import pytest
import torch

import jax

from kungfu_tpu.models.transformer import Transformer as JTransformer
from kungfu_tpu.models.transformer import TransformerConfig as JConfig
from kungfu_tpu.serve.engine import InferenceEngine as JEngine
from kungfu_tpu.serve.kvcache import KVCachePool as JPool
from kungfu_tpu.serve.kvcache import PageSpec as JPageSpec
from kungfu_tpu.serve.kvcache import chain_hashes as j_chain_hashes
from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models.transformer import Transformer, TransformerConfig
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.serve.engine import InferenceEngine
from kungfu_tpu_torch.serve.kvcache import (CacheExhausted, KVCachePool,
                                            PageSpec, chain_hashes)

_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=128, dtype="float32")
JCFG, CFG = JConfig(**_KW), TransformerConfig(**_KW)
_TIMING = ("ttft_s", "queue_s", "engine_s")


@pytest.fixture(scope="module")
def weights():
    jparams = JTransformer(JCFG).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, interop.params_from_jax(tree, CFG, device="cpu")


def _engines(weights, pages=128, max_batch=4):
    jparams, tparams = weights
    j = JEngine(JTransformer(JCFG), jparams,
                pool=JPool(JPageSpec.for_model(JCFG, page_tokens=8),
                           capacity_pages=pages),
                max_batch=max_batch, max_seq=128)
    t = InferenceEngine(Transformer(CFG), tparams,
                        pool=KVCachePool(PageSpec.for_model(CFG, page_tokens=8),
                                         capacity_pages=pages),
                        max_batch=max_batch, max_seq=128)
    return j, t


def _run(engine, script):
    """Replay ``script`` and record everything observable."""
    log = []
    for op, *args in script:
        if op == "submit":
            engine.submit(*args)
        elif op == "step":
            for _ in range(args[0]):
                log.append(("events", engine.step()))
        elif op == "drain":
            log.append(("events", engine.drain()))
        elif op == "cancel":
            log.append(("cancel", engine.cancel(args[0])))
        elif op == "width":
            log.append(("width", engine.set_width(args[0])))
        log.append(("counts", engine.active_count, engine.pending_count,
                    engine.pool.stats()))
    return [(kind, [{k: v for k, v in e.items() if k not in _TIMING}
                    for e in rest[0]]) if kind == "events" else (kind, *rest)
            for kind, *rest in log]


def _same(weights, script, **kw):
    j, t = _engines(weights, **kw)
    ref, got = _run(j, script), _run(t, script)
    assert got == ref
    return got


def _events(log):
    return [e for kind, *rest in log if kind == "events" for e in rest[0]]


SHARED = list(range(1, 20))  # 19 tokens: 2 full pages of 8


class TestEngineParity:
    def test_greedy(self, weights):
        _same(weights, [("submit", "a", [1, 2, 3, 4, 5], 6), ("drain",)])

    def test_continuous_batching_admits_mid_flight(self, weights):
        log = _same(weights, [("submit", "long", [1, 2, 3], 30), ("step", 5),
                              ("submit", "late", [9, 8], 5), ("step", 1),
                              ("drain",)])
        assert [c for c in log if c[0] == "counts"][-2][1] == 2

    def test_prefix_reuse(self, weights):
        log = _same(weights, [("submit", "first", SHARED + [21], 4), ("drain",),
                              ("submit", "second", SHARED + [22], 4),
                              ("drain",)])
        adm = [e for e in _events(log) if e["kind"] == "admit"]
        assert (adm[1]["reused"], adm[1]["computed"]) == (16, 4)

    def test_reused_prefix_decodes_identically(self, weights):
        prompt = list(range(1, 18))
        log = _same(weights, [("submit", "cold", prompt, 6), ("drain",),
                              ("submit", "warm", prompt, 6), ("drain",)])
        done = [e for e in _events(log) if e["kind"] == "done"]
        assert done[1]["reused_tokens"] == 16
        assert done[0]["tokens"] == done[1]["tokens"]

    def test_long_prompt_after_cached_prefix(self, weights):
        shared = list(range(1, 17))
        long_prompt = shared + [(31 + i) % 60 for i in range(100)]
        log = _same(weights, [("submit", "seed", shared + [30], 4), ("drain",),
                              ("submit", "long", long_prompt, 6), ("drain",)])
        adm = [e for e in _events(log) if e["kind"] == "admit"][1]
        assert adm["reused"] + adm["computed"] == 116

    def test_cancel(self, weights):
        log = _same(weights, [("submit", "victim", [1, 2, 3], 30), ("step", 1),
                              ("submit", "other", [4, 5], 3), ("step", 1),
                              ("cancel", "victim"), ("step", 1),
                              ("cancel", "victim"), ("drain",)])
        assert [c[1] for c in log if c[0] == "cancel"] == [True, False]

    def test_cache_exhaustion_keeps_request_pending(self, weights):
        log = _same(weights, [("submit", "a", [1, 2, 3, 4], 20),
                              ("submit", "b", [5, 6, 7, 8], 20), ("step", 1),
                              ("drain",)], pages=5)
        assert log[3][1:3] == (1, 1)  # a active, b queued
        done = {e["rid"] for e in _events(log) if e["kind"] == "done"}
        assert done == {"a", "b"}

    def test_width_control(self, weights):
        log = _same(weights, [("width", 2)]
                    + [("submit", f"r{i}", [1 + i, 2], 20) for i in range(3)]
                    + [("step", 4), ("width", 99), ("drain",)])
        assert [c[1] for c in log if c[0] == "width"] == [2, 4]


class TestEngineOnThePort:
    def test_tokens_match_full_context_apply(self, weights):
        _, tparams = weights
        model = Transformer(CFG)
        eng = InferenceEngine(model, tparams, max_batch=2, max_seq=128,
                              page_tokens=8)
        eng.submit("a", [1, 2, 3, 4, 5], 6)
        done = [e for e in eng.drain() if e["kind"] == "done"][0]
        out = [1, 2, 3, 4, 5]
        for _ in range(6):
            out.append(int(model.apply(tparams, torch.tensor([out]))[0, -1]
                           .argmax()))
        assert done["tokens"] == out[5:]

    def test_warmup_leaves_live_slab_untouched(self, weights):
        _, t = _engines(weights)
        t.submit("a", SHARED, 2)
        t.step()
        k, v = t._k.clone(), t._v.clone()
        t.warmup(prompt_lens=(40,))
        assert torch.equal(k, t._k) and torch.equal(v, t._v)

    def test_prefill_past_slab_raises(self, weights):
        _, t = _engines(weights)
        with pytest.raises(ValueError, match="does not fit"):
            t._prefill(t.params, t._k, t._v, torch.zeros(16, dtype=torch.long),
                       4, 120, 0)

    def test_spans_keep_their_names(self, weights, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()
        _, t = _engines(weights)
        t.submit("a", [1, 2, 3], 2, trace="req1")
        t.drain()
        names = [(e["kind"], e["name"]) for e in timeline.snapshot()]
        assert ("serve", "prefill") in names and ("serve", "decode") in names
        assert timeline.snapshot()[0]["attrs"]["trace"] == "req1"
        timeline.reset()

    def test_kv_gauge_tracks_pool(self, weights):
        _, t = _engines(weights)
        t.submit("a", [1, 2, 3], 4)
        t.step()
        assert REGISTRY.gauge("kf_kv_cache_bytes").value == \
            t.pool.footprint_bytes > 0
        t.drain()

    def test_bf16_engine_keeps_bf16_pages(self):
        cfg = TransformerConfig(**dict(_KW, dtype="bfloat16"))
        model = Transformer(cfg)
        params = model.init(torch.Generator().manual_seed(1), device="cpu")
        eng = InferenceEngine(model, params, max_batch=2, max_seq=128,
                              page_tokens=8)
        assert eng._k.dtype == torch.bfloat16
        eng.submit("a", SHARED, 4)
        eng.drain()
        eng.submit("b", SHARED, 4)
        evs = eng.drain()
        assert [e for e in evs if e["kind"] == "admit"][0]["reused"] == 16
        pages, _ = eng.pool.lookup(SHARED)
        k, v = eng.pool.page_data(pages[0])
        assert k.dtype == v.dtype == torch.bfloat16
        eng.pool.release(pages)


class TestKVCache:
    def test_bf16_page_bytes(self):
        """The reference's np.dtype("bfloat16") works only with jax's
        ml_dtypes registered; the port takes the size from torch."""
        spec = PageSpec.for_model(TransformerConfig(), page_tokens=16)
        assert spec.dtype == "bfloat16"
        assert spec.page_bytes == 2 * 12 * 12 * 16 * 64 * 2
        assert spec.page_bytes == JPageSpec.for_model(
            JConfig(), page_tokens=16).page_bytes

    def test_chain_hashes_match_reference(self):
        toks = list(range(40))
        assert chain_hashes(toks, 8) == j_chain_hashes(toks, 8)

    def test_page_data_refuses_other_dtypes(self):
        pool = KVCachePool(PageSpec(2, 2, 4, 8, dtype="bfloat16"),
                           capacity_pages=2)
        pid = pool.alloc(1)[0]
        with pytest.raises(ValueError, match="bfloat16"):
            pool.put_page_data(pid, torch.zeros(2, 2, 8, 4),
                               torch.zeros(2, 2, 8, 4))
        pool.put_page_data(pid, torch.zeros(2, 2, 8, 4, dtype=torch.bfloat16),
                           torch.zeros(2, 2, 8, 4, dtype=torch.bfloat16))
        assert pool.page_data(pid)[0].dtype == torch.bfloat16

    def test_exhaustion_and_refcounts(self):
        pool = KVCachePool(PageSpec(1, 1, 2, 4), capacity_pages=3)
        a = pool.alloc(2)
        with pytest.raises(CacheExhausted):
            pool.alloc(2)
        pool.release(a)
        assert pool.free_pages == 3 and pool.footprint_bytes == 0
