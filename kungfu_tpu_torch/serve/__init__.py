"""The serving plane of the port (``kungfu_tpu/serve/__init__.py``'s
exports): the paged KV pool, the SLO metrics, the continuous-batching
engine, and the router and serve workers that make a
:class:`~kungfu_tpu_torch.peer.Peer` world an inference deployment with
admission, dispatch, slice-grain exclusion and replay from committed
decode positions.  Importing it builds nothing and touches no GPU; the
engine and the router load lazily.
"""

from kungfu_tpu_torch.serve.kvcache import (CacheExhausted, KVCachePool,
                                            PageSpec, chain_hashes)
from kungfu_tpu_torch.serve.slo import SLOTargets, slo_snapshot

__all__ = [
    "CacheExhausted",
    "KVCachePool",
    "PageSpec",
    "chain_hashes",
    "SLOTargets",
    "slo_snapshot",
    "InferenceEngine",
    "ServeRouter",
    "ServeWorker",
    "RequestHandle",
]


def __getattr__(name):
    if name == "InferenceEngine":
        from kungfu_tpu_torch.serve.engine import InferenceEngine

        return InferenceEngine
    if name in ("ServeRouter", "ServeWorker", "RequestHandle"):
        from kungfu_tpu_torch.serve import router as _router

        return getattr(_router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
