"""Process-local blob stores (copy of ``kungfu_tpu/store/store.py``)."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

DEFAULT_VERSION_COUNT = 3  # reference handler/p2p.go:11


def _nbytes(blob) -> int:
    """Byte length of any buffer-protocol value (len() of a numpy array
    counts elements, not bytes)."""
    return memoryview(blob).nbytes


class Store:
    """Named blob KV store with size-checked get-or-create
    (reference ``store.go:14-59``)."""

    def __init__(self):
        # values are bytes unless saved with copy=False, in which case
        # any buffer-protocol object the caller handed over
        self._blobs: Dict[str, object] = {}
        self._lock = threading.RLock()

    def save(self, name: str, blob, copy: bool = True) -> None:
        """``copy=False`` stores the caller's buffer object as-is (any
        buffer-protocol value) — the gossip hot path hands over ~100 MiB
        fused-model views it promises never to mutate; the default
        snapshots, so a caller reusing its buffer can't corrupt the
        store."""
        with self._lock:
            existing = self._blobs.get(name)
            if existing is not None and _nbytes(existing) != _nbytes(blob):
                raise ValueError(
                    f"blob {name!r} size changed: "
                    f"{_nbytes(existing)} -> {_nbytes(blob)}"
                )
            self._blobs[name] = blob if not copy else bytes(blob)

    def get(self, name: str):
        """The stored value: bytes, or the caller's buffer object for
        copy=False saves."""
        with self._lock:
            return self._blobs.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._blobs)


class VersionedStore:
    """Sliding window of named blob sets keyed by version string
    (reference ``versionedstore.go`` — keeps the last ``window`` versions)."""

    def __init__(self, window: int = DEFAULT_VERSION_COUNT):
        self._window = window
        self._versions: "OrderedDict[str, Store]" = OrderedDict()
        self._lock = threading.RLock()

    def save(self, name: str, blob, version: Optional[str] = None,
             copy: bool = True) -> None:
        version = version or ""
        with self._lock:
            st = self._versions.get(version)
            if st is None:
                st = Store()
                self._versions[version] = st
                while len(self._versions) > self._window:
                    self._versions.popitem(last=False)
            st.save(name, blob, copy=copy)

    def get(self, name: str, version: Optional[str] = None):
        with self._lock:
            if version is not None and version != "":
                st = self._versions.get(version)
                return st.get(name) if st else None
            # latest version containing the name
            for st in reversed(self._versions.values()):
                blob = st.get(name)
                if blob is not None:
                    return blob
            return None

    def versions(self) -> List[str]:
        with self._lock:
            return list(self._versions)


_local: Optional[VersionedStore] = None
_local_lock = threading.Lock()


def get_local_store() -> VersionedStore:
    global _local
    with _local_lock:
        if _local is None:
            _local = VersionedStore()
        return _local


def reset_local_store() -> None:
    global _local
    with _local_lock:
        _local = None
