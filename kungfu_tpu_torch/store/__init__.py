"""Named blob stores and the p2p blob exchange (port of
``kungfu_tpu/store/``): a process-local store of named byte blobs, a
versioned store keeping a sliding window of versions, and the
request/response protocol over the host channel by which a peer pulls a
blob from another peer's store.
"""

from kungfu_tpu_torch.store.p2p import (install_p2p_handler, remote_request,
                                        remote_request_into)
from kungfu_tpu_torch.store.store import (Store, VersionedStore,
                                          get_local_store, reset_local_store)

__all__ = [
    "Store",
    "VersionedStore",
    "get_local_store",
    "reset_local_store",
    "install_p2p_handler",
    "remote_request",
    "remote_request_into",
]
