"""Paged KV-cache block manager: fixed-size pages, free-list allocation,
prefix-hash reuse, LRU eviction.

Port of ``kungfu_tpu/serve/kvcache.py``.  The engine holds the device
slab; this pool owns the host-side pages — capacity accounting,
prefix-reuse bookkeeping and the page data a prefix hit uploads.  A page
holds ``page_tokens`` consecutive tokens' K and V for every layer
(``[n_layers, n_heads, page_tokens, head_dim]`` each), as CPU tensors in
the compute dtype: bf16 pages stay bf16 (numpy has no bfloat16 without
jax's ``ml_dtypes``, so sizes come from torch dtypes and data never
passes through numpy).  The pool's durable snapshot/restore
(``snapshot_committed``) comes with the persistence slice.

Invariants (tests/test_kvcache.py on the reference): a recycled page is
never referenced by a live request; refcounts balance; eviction only
takes zero-reference committed pages; the ``kf_kv_cache_bytes`` gauge
equals ``(capacity - free) * page_bytes``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils import envs

#: default tokens per page (KF_SERVE_PAGE_TOKENS overrides)
DEFAULT_PAGE_TOKENS = 16
#: default pool capacity in pages (KF_SERVE_KV_PAGES overrides)
DEFAULT_CAPACITY_PAGES = 512

GAUGE = "kf_kv_cache_bytes"


class CacheExhausted(RuntimeError):
    """Allocation failed: free list empty and nothing evictable."""


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclass(frozen=True)
class PageSpec:
    """Geometry of one page: K+V for every layer of a model."""

    n_layers: int
    n_heads: int
    head_dim: int
    page_tokens: int
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def page_bytes(self) -> int:
        return (2 * self.n_layers * self.n_heads * self.page_tokens
                * self.head_dim * self.torch_dtype.itemsize)

    @classmethod
    def for_model(cls, cfg, page_tokens: Optional[int] = None,
                  dtype: Optional[str] = None) -> "PageSpec":
        if page_tokens is None:
            page_tokens = envs.parse_int_env(envs.SERVE_PAGE_TOKENS,
                                             DEFAULT_PAGE_TOKENS)
        return cls(n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                   head_dim=cfg.head_dim, page_tokens=int(page_tokens),
                   dtype=dtype or cfg.dtype)


def chain_hashes(tokens: Sequence[int], page_tokens: int) -> List[bytes]:
    """One digest per FULL page of ``tokens``: digest *i* covers tokens
    ``[0, (i+1)*page_tokens)`` — the same bytes as the reference's."""
    out: List[bytes] = []
    h = hashlib.blake2b(b"kf-kv-chain", digest_size=16)
    for i in range(len(tokens) // page_tokens):
        page = tokens[i * page_tokens:(i + 1) * page_tokens]
        h = h.copy()
        h.update(np.asarray(page, np.int64).tobytes())
        out.append(h.digest())
    return out


class _Page:
    __slots__ = ("k", "v", "key", "refs")

    def __init__(self):
        self.k: Optional[torch.Tensor] = None   # [L, H, T, D] on the CPU
        self.v: Optional[torch.Tensor] = None
        self.key: Optional[bytes] = None      # chain hash when committed
        self.refs = 0


class KVCachePool:
    """Thread-safe page pool."""

    def __init__(self, spec: PageSpec,
                 capacity_pages: Optional[int] = None):
        if capacity_pages is None:
            capacity_pages = envs.parse_int_env(envs.SERVE_KV_PAGES,
                                                DEFAULT_CAPACITY_PAGES)
        self.spec = spec
        self.capacity = int(capacity_pages)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._pages: Dict[int, _Page] = {}
        self._by_key: Dict[bytes, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._evictions = 0
        self._update_gauge()

    # -- accounting ------------------------------------------------------
    def _update_gauge(self) -> None:
        REGISTRY.gauge(GAUGE).set(
            (self.capacity - len(self._free)) * self.spec.page_bytes)

    @property
    def footprint_bytes(self) -> int:
        with self._lock:
            return (self.capacity - len(self._free)) * self.spec.page_bytes

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    # -- allocation ------------------------------------------------------
    def _take_one_locked(self) -> int:
        if self._free:
            pid = self._free.pop()
        elif self._lru:
            pid, _ = self._lru.popitem(last=False)
            page = self._pages.pop(pid)
            assert page.refs == 0, "evicting a referenced page"
            if page.key is not None:
                self._by_key.pop(page.key, None)
            self._evictions += 1
        else:
            raise CacheExhausted(
                f"kv cache exhausted: {self.capacity} pages all referenced "
                f"by live requests (page={self.spec.page_tokens} tokens)")
        self._pages[pid] = _Page()
        self._pages[pid].refs = 1
        return pid

    def alloc(self, n: int) -> List[int]:
        """Reserve ``n`` fresh pages (all-or-nothing)."""
        with self._lock:
            if n > len(self._free) + len(self._lru):
                raise CacheExhausted(
                    f"need {n} pages, {len(self._free)} free + "
                    f"{len(self._lru)} evictable of {self.capacity}")
            out = [self._take_one_locked() for _ in range(n)]
            self._update_gauge()
            return out

    def release(self, page_ids: Sequence[int]) -> None:
        """Drop one reference per page; zero-ref committed pages park in
        the LRU, zero-ref uncommitted ones return to the free list."""
        with self._lock:
            for pid in page_ids:
                page = self._pages.get(pid)
                if page is None or page.refs <= 0:
                    raise ValueError(f"release of non-live page {pid}")
                page.refs -= 1
                if page.refs == 0:
                    if page.key is not None:
                        self._lru[pid] = None
                        self._lru.move_to_end(pid)
                    else:
                        del self._pages[pid]
                        self._free.append(pid)
            self._update_gauge()

    # -- page data -------------------------------------------------------
    def put_page_data(self, pid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Fill a reserved page's host copy (``[L, H, T, D]`` CPU tensors
        in the spec's dtype — never silently converted)."""
        want = (self.spec.n_layers, self.spec.n_heads,
                self.spec.page_tokens, self.spec.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(f"page data shape {tuple(k.shape)} != {want}")
        for t in (k, v):
            if t.dtype != self.spec.torch_dtype or t.device.type != "cpu":
                raise ValueError(
                    f"page data must be {self.spec.dtype} on the CPU, got "
                    f"{t.dtype} on {t.device}")
        with self._lock:
            page = self._pages.get(pid)
            if page is None or page.refs <= 0:
                raise ValueError(f"put_page_data on non-live page {pid}")
            page.k = k.contiguous()
            page.v = v.contiguous()

    def page_data(self, pid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            page = self._pages.get(pid)
            if page is None or page.refs <= 0:
                raise ValueError(f"page_data on non-live page {pid}")
            if page.k is None or page.v is None:
                raise ValueError(f"page {pid} holds no data")
            return page.k, page.v

    # -- prefix reuse ----------------------------------------------------
    def commit_chain(self, tokens: Sequence[int],
                     page_ids: Sequence[int]) -> int:
        """Register filled pages under the prefix chain of ``tokens``
        (first writer wins).  Returns the committed count."""
        digests = chain_hashes(tokens, self.spec.page_tokens)
        committed = 0
        with self._lock:
            for digest, pid in zip(digests, page_ids):
                page = self._pages.get(pid)
                if page is None or page.refs <= 0:
                    raise ValueError(f"commit of non-live page {pid}")
                if page.k is None:
                    break  # pages are filled in order; stop at the gap
                if digest in self._by_key:
                    continue
                page.key = digest
                self._by_key[digest] = pid
                committed += 1
        return committed

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest committed prefix: ``(page_ids, n_cached_tokens)``; the
        pages are retained for the caller (refcount +1)."""
        digests = chain_hashes(tokens, self.spec.page_tokens)
        out: List[int] = []
        with self._lock:
            for digest in digests:
                pid = self._by_key.get(digest)
                if pid is None:
                    break
                page = self._pages[pid]
                page.refs += 1
                if page.refs == 1:
                    self._lru.pop(pid, None)
                out.append(pid)
            return out, len(out) * self.spec.page_tokens

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "free": len(self._free),
                "cached": len(self._lru),
                "live": sum(1 for p in self._pages.values() if p.refs > 0),
                "evictions": self._evictions,
                "bytes": (self.capacity - len(self._free))
                * self.spec.page_bytes,
            }
