"""Continuous-batching inference engine over the flagship transformer.

Port of ``kungfu_tpu/serve/engine.py``.  One engine = one replica: it
owns the params, a device KV slab ``[L, B, H, S, D]`` of ``max_batch``
decode slots in the compute dtype, and a :class:`~kungfu_tpu_torch.
serve.kvcache.KVCachePool` for host-side page accounting.  The
scheduling is the reference's decode-priority continuous batching:
every :meth:`step` admits at most ``admit_per_step`` pending prefills
into free slots, then runs ONE decode step for all active slots.

* **prefill** — forward over the un-cached prompt suffix padded to a
  power-of-two bucket, writing K/V into the slab at ``[cached, cached +
  bucket)`` and emitting the first generated token.  A cached prefix is
  uploaded from the pool's host pages.
* **decode** — one token for every slot: each slot's K/V lands at its
  own position, attention covers ``[0, pos]``, greedy argmax.

The engine runs where its params live (``cuda`` or, for tests, the
CPU).  Its attention (``_attend``) is the plain masked softmax on both
devices, as in the reference, where no Pallas kernel computes it either.
PyTorch is eager, so the slab is updated in place; JAX's clamping
``dynamic_update_slice`` has no counterpart, and every slab write is
bounds-checked on the host before it is issued.  The only host<->device
copies besides the per-step token ids and readback are the cached-prefix
upload at admission and the page commit at completion.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.models.transformer import Transformer, _rope
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.ops import costmodel
from kungfu_tpu_torch.serve import slo
from kungfu_tpu_torch.serve.kvcache import (CacheExhausted, KVCachePool,
                                            PageSpec)
from kungfu_tpu_torch.utils import envs

DEFAULT_MAX_BATCH = 8


class _Req:
    __slots__ = ("rid", "tokens", "max_new", "generated", "slot", "pages",
                 "reused", "computed", "submitted_s", "admitted_s",
                 "first_token_s", "canceled", "trace", "parent")

    def __init__(self, rid: str, tokens: Sequence[int], max_new: int,
                 trace=None):
        self.rid = rid
        self.tokens = tuple(int(t) for t in tokens)
        self.max_new = int(max_new)
        self.trace, self.parent = timeline.parse_trace_context(trace)
        self.generated: List[int] = []
        self.slot = -1
        self.pages: List[int] = []
        self.reused = 0
        self.computed = 0
        self.submitted_s = time.perf_counter()
        self.admitted_s = 0.0
        self.first_token_s = 0.0
        self.canceled = False

    @property
    def total_len(self) -> int:
        return len(self.tokens) + len(self.generated)


class InferenceEngine:
    """Single-replica continuous-batching decode loop (thread-safe
    submit, single-threaded :meth:`step`)."""

    def __init__(self, model: Transformer, params, *,
                 pool: Optional[KVCachePool] = None,
                 max_batch: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 admit_per_step: int = 1,
                 rank: Optional[int] = None):
        cfg = model.cfg
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.rank = rank
        self.eos_id = eos_id
        self.admit_per_step = max(1, int(admit_per_step))
        self.max_batch = int(max_batch if max_batch is not None
                             else envs.parse_int_env(envs.SERVE_MAX_BATCH,
                                                     DEFAULT_MAX_BATCH))
        self.max_seq = int(max_seq or cfg.max_seq)
        self.pool = pool if pool is not None else KVCachePool(
            PageSpec.for_model(cfg, page_tokens=page_tokens))
        if self.pool.spec.torch_dtype != cfg.compute_dtype:
            raise ValueError(f"pool pages hold {self.pool.spec.dtype}, the "
                             f"model computes in {cfg.dtype}")
        self._page_tokens = self.pool.spec.page_tokens
        self._width = self.max_batch
        self._lock = threading.Lock()
        self._pending: "deque[_Req]" = deque()
        self._active: Dict[int, _Req] = {}       # slot -> request
        self._free_slots = list(range(self.max_batch - 1, -1, -1))
        # device KV slab: [L, B, H, S, D] in compute dtype
        shape = (cfg.n_layers, self.max_batch, cfg.n_heads, self.max_seq,
                 cfg.head_dim)
        self._k = torch.zeros(shape, dtype=cfg.compute_dtype,
                              device=self.device)
        self._v = torch.zeros_like(self._k)
        self._mfu = costmodel.MFUMeter(
            rank=rank, detect_peak=False,
            peak_flops=costmodel.chip_peak_flops(self.device))

    # -- forward passes --------------------------------------------------
    def _layer_qkv(self, lp, x, positions):
        cfg = self.model.cfg
        dt = cfg.compute_dtype

        def heads(t):
            b, s, _ = t.shape
            return t.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

        q = heads(nn.dense_apply(lp["wq"], x, dtype=dt))
        k = heads(nn.dense_apply(lp["wk"], x, dtype=dt))
        v = heads(nn.dense_apply(lp["wv"], x, dtype=dt))
        if cfg.pos == "rope":
            q, k = _rope(q, k, positions)
        return q, k, v

    @staticmethod
    def _attend(q, keys, values, mask):
        """q [B,H,Q,D] over keys/values [B,H,S,D]; mask [B,1,Q,S] (or
        broadcastable) True = attend.  f32 logits/softmax."""
        d = q.shape[-1]
        logits = (q @ keys.transpose(-1, -2)).float() / math.sqrt(d)
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return probs @ values

    @staticmethod
    def _merge(x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _block_tail(self, lp, h, o):
        dt = self.model.cfg.compute_dtype
        h = h + nn.dense_apply(lp["wo"], self._merge(o), dtype=dt)
        x = nn.layernorm_apply(lp["ln2"], h)
        y = nn.gelu(nn.dense_apply(lp["ffn_in"], x, dtype=dt))
        return h + nn.dense_apply(lp["ffn_out"], y, dtype=dt)

    @torch.no_grad()
    def _prefill(self, params, k_slab, v_slab, ids: torch.Tensor, n: int,
                 start: int, slot: int) -> torch.Tensor:
        """ids [S_pad] (suffix, zero-padded past ``n``); writes K/V at
        positions ``[start, start + S_pad)`` of ``slot`` in place and
        returns the greedy next token after the last REAL row."""
        cfg = self.model.cfg
        dt = cfg.compute_dtype
        s_pad = ids.shape[0]
        s_max = k_slab.shape[3]
        # the fit guard of _try_admit makes this hold; JAX would clamp
        # the write over the cached prefix, torch would fail on shapes
        if not (0 <= start and start + s_pad <= s_max and 0 < n <= s_pad):
            raise ValueError(f"prefill [{start}, {start + s_pad}) of {n} "
                             f"tokens does not fit the slab of {s_max}")
        positions = start + torch.arange(s_pad, device=ids.device)
        h = nn.embedding_apply(params["embed"], ids[None], dtype=dt)
        if cfg.pos == "learned":
            h = h + nn.embedding_apply(params["pos_embed"], positions[None],
                                       dtype=dt)
        key_pos = torch.arange(s_max, device=ids.device)
        mask = (key_pos[None, :] <= positions[:, None])[None, None]
        for li in range(cfg.n_layers):
            lp = params[f"layer_{li}"]
            x = nn.layernorm_apply(lp["ln1"], h)
            q, k, v = self._layer_qkv(lp, x, positions[None])
            k_slab[li, slot, :, start:start + s_pad] = k[0]
            v_slab[li, slot, :, start:start + s_pad] = v[0]
            o = self._attend(q, k_slab[li, slot:slot + 1],
                             v_slab[li, slot:slot + 1], mask)
            h = self._block_tail(lp, h, o)
        h = nn.layernorm_apply(params["ln_f"], h)
        logits = nn.dense_apply(params["head"], h[:, n - 1]).float()
        return torch.argmax(logits[0], dim=-1)

    @torch.no_grad()
    def _decode(self, params, k_slab, v_slab, last_ids: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        """One token for every slot: ``last_ids``/``pos`` are [B] on the
        device; each slot's new K/V lands at its own ``pos`` and attention
        covers ``[0, pos]``.  Inactive slots compute values nobody reads."""
        cfg = self.model.cfg
        dt = cfg.compute_dtype
        B = last_ids.shape[0]
        s_max = k_slab.shape[3]
        positions = pos[:, None]                     # [B, 1]
        h = nn.embedding_apply(params["embed"], last_ids[:, None], dtype=dt)
        if cfg.pos == "learned":
            h = h + nn.embedding_apply(params["pos_embed"], positions,
                                       dtype=dt)
        key_pos = torch.arange(s_max, device=pos.device)
        mask = (key_pos[None, :] <= positions)[:, None, None, :]
        slots = torch.arange(B, device=pos.device)
        for li in range(cfg.n_layers):
            lp = params[f"layer_{li}"]
            x = nn.layernorm_apply(lp["ln1"], h)
            q, k, v = self._layer_qkv(lp, x, positions)   # [B, H, 1, D]
            k_l, v_l = k_slab[li], v_slab[li]            # views [B,H,S,D]
            # per-slot write at each slot's own position (the reference's
            # vmap(dynamic_update_slice)): advanced indices on dims 0 and
            # 2 around a slice select [B, H, D]
            k_l[slots, :, pos] = k[:, :, 0]
            v_l[slots, :, pos] = v[:, :, 0]
            h = self._block_tail(lp, h, self._attend(q, k_l, v_l, mask))
        h = nn.layernorm_apply(params["ln_f"], h)
        logits = nn.dense_apply(params["head"], h[:, 0]).float()
        return torch.argmax(logits, dim=-1)

    def _prefill_bucket(self, n: int) -> int:
        """Prefill length: the smallest power-of-two multiple of the page
        size holding ``n``, capped at ``max_seq``."""
        b = max(self._page_tokens, 1)
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def warmup(self, prompt_lens: Sequence[int] = (8,)) -> None:
        """Run the decode step and EVERY prefill bucket up to the one
        covering ``max(prompt_lens)`` once before serving, on scratch
        slabs (the live slab is untouched).  Eager PyTorch compiles
        nothing, but first calls pay library and allocator set-up; every
        smaller bucket is included because a prefix hit prefills only its
        suffix."""
        top = self._prefill_bucket(max(max(prompt_lens), 1))
        buckets, b = [], max(self._page_tokens, 1)
        while b < top:
            buckets.append(b)
            b *= 2
        buckets.append(top)
        k_scratch, v_scratch = torch.zeros_like(self._k), torch.zeros_like(self._v)
        for s_pad in buckets:
            ids = torch.zeros(s_pad, dtype=torch.long, device=self.device)
            int(self._prefill(self.params, k_scratch, v_scratch, ids, 1, 0, 0))
        zeros = torch.zeros(self.max_batch, dtype=torch.long, device=self.device)
        self._decode(self.params, k_scratch, v_scratch, zeros, zeros).cpu()

    # -- scheduling ------------------------------------------------------
    def set_width(self, w: int) -> int:
        """Admitted decode width (<= max_batch); never the slab shape."""
        with self._lock:
            self._width = max(1, min(int(w), self.max_batch))
            return self._width

    def submit(self, rid: str, tokens: Sequence[int], max_new: int,
               trace: Optional[str] = None) -> None:
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) + max_new > self.max_seq:
            raise ValueError(
                f"request {rid!r}: {len(tokens)} prompt + {max_new} new "
                f"tokens exceeds max_seq {self.max_seq}")
        req = _Req(rid, tokens, max_new, trace=trace)
        with self._lock:
            self._pending.append(req)

    def cancel(self, rid: str) -> bool:
        """Drop a request: pending ones leave now; an active one is only
        flagged and retired by the step thread at the next boundary."""
        with self._lock:
            for i, r in enumerate(self._pending):
                if r.rid == rid:
                    del self._pending[i]
                    return True
            for r in self._active.values():
                if r.rid == rid:
                    r.canceled = True
                    return True
        return False

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    # -- admission (prefill phase) ---------------------------------------
    def _try_admit(self, req: _Req) -> bool:
        T = self._page_tokens
        budget = len(req.tokens) + req.max_new
        n_pages = -(-budget // T)
        cached_pages, n_cached = self.pool.lookup(req.tokens)
        # at least one prompt token must run the forward
        max_reuse = ((len(req.tokens) - 1) // T) * T
        while n_cached > max_reuse:
            self.pool.release([cached_pages.pop()])
            n_cached -= T
        # the padded prefill must FIT the slab past the cached offset:
        # give reuse back until the rounded suffix fits (n_cached = 0
        # always does, since submit() bounds the prompt by max_seq)
        while n_cached > 0 and (
                n_cached + self._prefill_bucket(len(req.tokens) - n_cached)
                > self.max_seq):
            self.pool.release([cached_pages.pop()])
            n_cached -= T
        try:
            fresh = self.pool.alloc(n_pages - len(cached_pages))
        except CacheExhausted:
            self.pool.release(cached_pages)
            return False
        req.pages = cached_pages + fresh
        req.reused = n_cached
        with self._lock:
            slot = self._free_slots.pop()
        req.slot = slot
        req.admitted_s = time.perf_counter()
        if n_cached:
            # cached prefix: host pages -> slab, one upload each for K, V
            ks = torch.stack([self.pool.page_data(p)[0] for p in cached_pages],
                             dim=2)  # [L, H, n_pages, T, D]
            vs = torch.stack([self.pool.page_data(p)[1] for p in cached_pages],
                             dim=2)
            L, H = ks.shape[0], ks.shape[1]
            self._k[:, slot, :, :n_cached] = ks.reshape(L, H, n_cached, -1).to(
                self.device)
            self._v[:, slot, :, :n_cached] = vs.reshape(L, H, n_cached, -1).to(
                self.device)
        suffix = req.tokens[n_cached:]
        s_pad = self._prefill_bucket(len(suffix))
        ids = torch.zeros(s_pad, dtype=torch.long)
        ids[:len(suffix)] = torch.tensor(suffix, dtype=torch.long)
        tc_attrs = timeline.context_attrs(req.trace, req.parent)
        with timeline.span("serve", "prefill", rank=self.rank,
                           tokens=len(suffix), reused=n_cached,
                           rid=req.rid, **tc_attrs):
            tok = int(self._prefill(self.params, self._k, self._v,
                                    ids.to(self.device), len(suffix),
                                    n_cached, slot))
        req.computed = len(suffix)
        self._mfu.add_flops(costmodel.serve_prefill_flops(
            self.model.cfg, len(suffix), n_cached))
        req.first_token_s = time.perf_counter()
        req.generated.append(tok)
        slo.count_prefill(computed=len(suffix), reused=n_cached)
        with self._lock:
            self._active[slot] = req
        return True

    # -- completion ------------------------------------------------------
    def _retire_locked(self, slot: int, req: _Req) -> None:
        if self._active.pop(slot, None) is None:
            return
        self._free_slots.append(slot)
        if req.pages:
            self.pool.release(req.pages)
            req.pages = []

    def _complete(self, slot: int, req: _Req) -> dict:
        T = self._page_tokens
        seq = list(req.tokens) + req.generated
        # K/V exists for positions [0, total_len - 1): the final token
        # was emitted but never ran through the stack
        full = (req.total_len - 1) // T
        first_new = req.reused // T
        if full > first_new and req.pages:
            # slab -> host pages, one download each for K, V
            kb = self._k[:, slot, :, first_new * T:full * T].cpu()
            vb = self._v[:, slot, :, first_new * T:full * T].cpu()
            for p in range(first_new, full):
                lo = (p - first_new) * T
                self.pool.put_page_data(req.pages[p], kb[:, :, lo:lo + T],
                                        vb[:, :, lo:lo + T])
            self.pool.commit_chain(seq[:full * T], req.pages[:full])
        done_s = time.perf_counter()
        stats = {
            "rid": req.rid,
            "tokens": list(req.generated),
            "ttft_s": req.first_token_s - req.submitted_s,
            "queue_s": req.admitted_s - req.submitted_s,
            "engine_s": done_s - req.submitted_s,
            "reused_tokens": req.reused,
            "computed_tokens": req.computed,
        }
        slo.observe_ttft(stats["ttft_s"])
        with self._lock:
            self._retire_locked(slot, req)
        return stats

    def _is_done(self, req: _Req) -> bool:
        if len(req.generated) >= req.max_new:
            return True
        return self.eos_id is not None and req.generated[-1] == self.eos_id

    # -- the step --------------------------------------------------------
    def step(self) -> List[dict]:
        """One continuous-batching iteration: admit (bounded), decode
        every active slot, retire finished requests.  Returns events
        ``{"kind": "admit"|"token"|"done", ...}`` in occurrence order."""
        events: List[dict] = []
        t_step0 = time.perf_counter()
        admitted = 0
        while admitted < self.admit_per_step:
            with self._lock:
                can = (self._pending and self._free_slots
                       and len(self._active) < self._width)
                req = self._pending.popleft() if can else None
            if req is None:
                break
            if not self._try_admit(req):
                with self._lock:
                    self._pending.appendleft(req)  # FCFS: keep its turn
                break
            admitted += 1
            events.append({"kind": "admit", "rid": req.rid,
                           "reused": req.reused, "computed": req.computed})
            events.append({"kind": "token", "rid": req.rid,
                           "tok": req.generated[-1], "n": 1})
            if self._is_done(req):
                events.append({"kind": "done", **self._complete(req.slot, req)})
        with self._lock:
            doomed = [(s, r) for s, r in self._active.items() if r.canceled]
            for s, r in doomed:
                self._retire_locked(s, r)
        with self._lock:
            active = dict(self._active)
        if active:
            B = self.max_batch
            last = np.zeros(B, np.int64)
            pos = np.zeros(B, np.int64)
            for slot, r in active.items():
                last[slot] = r.generated[-1]
                pos[slot] = r.total_len - 1
            if pos.max() >= self.max_seq:
                raise ValueError(f"decode position {int(pos.max())} is past "
                                 f"the slab's {self.max_seq}")
            t0 = time.perf_counter()
            with timeline.span("serve", "decode", rank=self.rank,
                               batch=len(active)):
                nxt = self._decode(
                    self.params, self._k, self._v,
                    torch.from_numpy(last).to(self.device),
                    torch.from_numpy(pos).to(self.device)).cpu().numpy()
            slo.observe_token(time.perf_counter() - t0)
            cfg = self.model.cfg
            self._mfu.add_flops(sum(
                costmodel.serve_decode_flops(cfg, int(pos[slot]) + 1)
                for slot in active))
            for slot, r in active.items():
                r.generated.append(int(nxt[slot]))
                events.append({"kind": "token", "rid": r.rid,
                               "tok": int(nxt[slot]), "n": len(r.generated)})
                if self._is_done(r):
                    events.append({"kind": "done", **self._complete(slot, r)})
        self._mfu.step(wall_s=time.perf_counter() - t_step0)
        slo.note_active(self.active_count)
        return events

    def drain(self, max_steps: int = 10_000) -> List[dict]:
        """Run steps until idle; bounded so a non-terminating request
        cannot wedge the caller."""
        out: List[dict] = []
        for _ in range(max_steps):
            if not (self.pending_count or self.active_count):
                break
            out.extend(self.step())
        return out
