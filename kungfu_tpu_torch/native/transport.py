"""ctypes wrapper for the native C++ host transport (:file:`transport.cpp`);
port of ``kungfu_tpu/native/transport.py``.

Gives :mod:`kungfu_tpu_torch.comm.host` a drop-in native backend for its message
channel: the accept loop, framed decode, rendezvous queues, token fencing,
and the pooled sender all run in C++ threads, with Python entering only
for control/p2p handler callbacks.  Falls back cleanly (``available()``
False) when the toolchain is absent.  One addition to the reference: a
transport made on port 0 binds a port the kernel assigns and reports it
as :attr:`NativeTransport.port` (``kf_host_port``).  Not wrapped yet,
for want of a caller in the port: the ingress/egress byte snapshots
(``NetMonitor``, ROADMAP A9).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, List, Optional

from kungfu_tpu_torch import native as _native

# int cb(name, payload, len, src): return 0 if consumed, 1 to enqueue
MSG_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_ubyte),
    ctypes.c_uint32,
    ctypes.c_char_p,
)

_proto_done = False


def _lib():
    global _proto_done
    lib = _native.load()
    if lib is None:
        return None
    if not hasattr(lib, "kf_host_create"):  # stale prebuilt .so without transport
        return None
    if not _proto_done:
        lib.kf_host_create.restype = ctypes.c_void_p
        lib.kf_host_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int,
        ]
        lib.kf_host_close.argtypes = [ctypes.c_void_p]
        lib.kf_host_shutdown.argtypes = [ctypes.c_void_p]
        lib.kf_host_port.restype = ctypes.c_uint32
        lib.kf_host_port.argtypes = [ctypes.c_void_p]
        lib.kf_host_set_token.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.kf_host_token.restype = ctypes.c_uint32
        lib.kf_host_token.argtypes = [ctypes.c_void_p]
        lib.kf_host_send.restype = ctypes.c_int
        lib.kf_host_send.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ]
        lib.kf_host_recv.restype = ctypes.c_int
        lib.kf_host_recv.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kf_host_buf_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.kf_host_recv_into.restype = ctypes.c_int
        lib.kf_host_recv_into.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kf_host_recv_begin.restype = ctypes.c_void_p
        lib.kf_host_recv_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int),
        ]
        lib.kf_host_recv_finish.restype = ctypes.c_int
        lib.kf_host_recv_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kf_host_recv_abort.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.kf_host_ping.restype = ctypes.c_int
        lib.kf_host_ping.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
        lib.kf_host_reset_connections.argtypes = [ctypes.c_void_p]
        lib.kf_host_set_control_cb.argtypes = [ctypes.c_void_p, MSG_CB]
        lib.kf_host_set_p2p_cb.argtypes = [ctypes.c_void_p, MSG_CB]
        lib.kf_engine_all_reduce.restype = ctypes.c_int
        lib.kf_engine_all_reduce.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
        ]
        _proto_done = True
    return lib


def available() -> bool:
    return _lib() is not None


class NativeTransport:
    """One C++ channel endpoint.  Raises OSError if the port can't bind;
    port 0 binds a port the kernel assigns (:attr:`port`)."""

    def __init__(self, self_spec: str, port: int, bind_host: str = "",
                 token: int = 0, use_unix: bool = True):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native transport unavailable")
        self._libref = lib  # keep alive through interpreter teardown
        if bind_host:
            # the C++ bind path takes a dotted-quad only (inet_pton);
            # resolve hostnames here, and fall back to the wildcard rather
            # than failing channel creation on an unresolvable name
            import socket as _socket

            try:
                bind_host = _socket.gethostbyname(bind_host)
            except OSError:
                bind_host = ""
        self._h = lib.kf_host_create(
            self_spec.encode(), (bind_host or "").encode(), port, token,
            1 if use_unix else 0,
        )
        if not self._h:
            raise OSError(f"cannot bind native channel on port {port}")
        # CFUNCTYPE objects must outlive the channel
        self._cbs: List[object] = []
        #: calls inside the C library; close() frees the channel only
        #: once they have all left
        self._guard = threading.Condition()
        self._inflight = 0

    @contextlib.contextmanager
    def _live(self):
        """The channel handle for one call into the library; a closed
        channel raises ``ConnectionError``.  The reference's wrapper
        reads the handle bare, so a call racing ``close()`` (a dying
        peer closing its channel while its engine's pool threads still
        receive) passes a freed or NULL handle and faults the process."""
        with self._guard:
            h = self._h
            if not h:
                raise ConnectionError("channel closed")
            self._inflight += 1
        try:
            yield h
        finally:
            with self._guard:
                self._inflight -= 1
                if not self._inflight:
                    self._guard.notify_all()

    def close(self) -> None:
        """Stop the channel (every blocked call wakes with the closed
        status), wait until every call has left the library, then free
        it."""
        with self._guard:
            h, self._h = self._h, None
        if not h:
            return
        self._libref.kf_host_shutdown(h)
        with self._guard:
            while self._inflight:
                self._guard.wait()
        self._libref.kf_host_close(h)

    @property
    def port(self) -> int:
        """The port the TCP listener is bound to."""
        with self._live() as h:
            return int(self._libref.kf_host_port(h))

    def set_token(self, token: int) -> None:
        with self._live() as h:
            self._libref.kf_host_set_token(h, token)

    @property
    def token(self) -> int:
        with self._live() as h:
            return int(self._libref.kf_host_token(h))

    def send(self, peer_spec: str, name: str, payload, conn_type: int,
             retries: int) -> None:
        """``payload``: any contiguous buffer (bytes, numpy array,
        memoryview) — passed by POINTER to the C++ writev (which sends
        from the caller's memory synchronously), so a ~100 MiB gossip
        blob crosses Python→wire with zero copies."""
        if isinstance(payload, bytes):
            # bytes → borrowed char* (no copy); the object outlives the
            # synchronous call
            ptr = ctypes.cast(ctypes.c_char_p(payload), ctypes.c_void_p)
            nbytes = len(payload)
        else:
            mv = memoryview(payload)
            if not mv.contiguous:
                raise ValueError("send needs a contiguous buffer")
            import numpy as _np

            arr = _np.frombuffer(mv.cast("B"), _np.uint8)  # view, ro-safe
            ptr = ctypes.c_void_p(arr.ctypes.data)
            nbytes = arr.nbytes
        with self._live() as h:
            rc = self._libref.kf_host_send(
                h, peer_spec.encode(), name.encode(), ptr, nbytes,
                conn_type, retries,
            )
        if rc == -3:
            raise ValueError(
                f"payload of {nbytes} bytes exceeds the 3 GiB frame "
                "limit — split the blob (the engine chunks at 1 MiB; this "
                "can only come from an oversized p2p/control message)"
            )
        if rc != 0:
            raise ConnectionError(
                f"cannot reach {peer_spec} after {retries} retries")

    def recv(self, src_spec: str, name: str, conn_type: int,
             timeout: Optional[float]) -> bytes:
        out = ctypes.POINTER(ctypes.c_ubyte)()
        out_len = ctypes.c_uint32()
        with self._live() as h:
            rc = self._libref.kf_host_recv(
                h, src_spec.encode(), name.encode(), conn_type,
                -1.0 if timeout is None else float(timeout),
                ctypes.byref(out), ctypes.byref(out_len),
            )
        if rc == 1:
            raise TimeoutError(
                f"recv {name!r} from {src_spec} timed out after {timeout}s")
        if rc != 0:
            raise ConnectionError("channel closed")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._libref.kf_host_buf_free(out)

    def recv_into(self, src_spec: str, name: str, conn_type: int,
                  timeout: Optional[float], buf) -> bool:
        """Receive directly into ``buf`` (a writable contiguous buffer,
        e.g. a numpy array) — the registered-buffer zero-copy path
        (reference RecvInto/WaitRecvBuf): the payload goes socket→buffer
        with no allocation, queue hop, or ctypes copy.  Returns False on
        size mismatch (payload stays queued; fall back to :meth:`recv`)."""
        mv = memoryview(buf)
        if mv.readonly or not mv.contiguous:
            raise ValueError("recv_into needs a writable contiguous buffer")
        cap = mv.nbytes
        got = ctypes.c_uint32()
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        with self._live() as h:
            rc = self._libref.kf_host_recv_into(
                h, src_spec.encode(), name.encode(), conn_type,
                -1.0 if timeout is None else float(timeout),
                addr, cap, ctypes.byref(got),
            )
        if rc == 0:
            return True
        if rc == -2:
            return False
        if rc == 1:
            raise TimeoutError(
                f"recv_into {name!r} from {src_spec} timed out after {timeout}s")
        raise ConnectionError("channel closed")

    def recv_begin(self, src_spec: str, name: str, conn_type: int, buf):
        """Register ``buf`` for a receive before the request leaves
        (``kf_host_recv_begin``): an opaque handle for
        :meth:`recv_finish`/:meth:`recv_abort`, or None when nothing was
        registered (a queued payload of another size: :meth:`recv`)."""
        mv = memoryview(buf)
        if mv.readonly or not mv.contiguous:
            raise ValueError("recv_begin needs a writable contiguous buffer")
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        rc = ctypes.c_int()
        with self._live() as h:
            h = self._libref.kf_host_recv_begin(
                h, src_spec.encode(), name.encode(), conn_type,
                addr, mv.nbytes, ctypes.byref(rc))
        if h is None:
            if rc.value == 2:
                raise ConnectionError("channel closed")
            return None
        return h

    def recv_finish(self, src_spec: str, name: str, conn_type: int,
                    timeout: Optional[float], handle) -> bool:
        """Resolve a :meth:`recv_begin` registration: True when ``buf``
        is filled, False on a queued payload of another size.  Consumes
        the handle on every outcome."""
        got = ctypes.c_uint32()
        with self._live() as h:
            rc = self._libref.kf_host_recv_finish(
                h, src_spec.encode(), name.encode(), conn_type,
                -1.0 if timeout is None else float(timeout),
                handle, ctypes.byref(got))
        if rc == 0:
            return True
        if rc == -2:
            return False
        if rc == 1:
            raise TimeoutError(
                f"recv_finish {name!r} from {src_spec} timed out after "
                f"{timeout}s")
        raise ConnectionError("channel closed")

    def recv_abort(self, src_spec: str, name: str, conn_type: int,
                   handle) -> None:
        with self._live() as h:
            self._libref.kf_host_recv_abort(
                h, src_spec.encode(), name.encode(), conn_type, handle)

    def ping(self, peer_spec: str, timeout: float) -> bool:
        with self._live() as h:
            return self._libref.kf_host_ping(h, peer_spec.encode(), timeout) == 0

    def reset_connections(self) -> None:
        with self._live() as h:
            self._libref.kf_host_reset_connections(h)

    def set_control_handler(self, fn: Callable[[str, bytes, str], bool]) -> None:
        """``fn(name, payload, src) -> consumed``; not-consumed falls
        through to the rendezvous queue."""
        self._set_cb(self._libref.kf_host_set_control_cb, fn)

    def set_p2p_handler(self, fn: Callable[[str, bytes, str], bool]) -> None:
        """``fn(name, payload, src) -> consumed`` for ``req.*``
        PEER_TO_PEER frames."""
        self._set_cb(self._libref.kf_host_set_p2p_cb, fn)

    def _set_cb(self, setter, fn) -> None:
        @MSG_CB
        def trampoline(name, payload, length, src):
            try:
                data = ctypes.string_at(payload, length) if length else b""
                return 0 if fn(name.decode(), data, src.decode()) else 1
            except Exception:  # noqa: BLE001 - never unwind into C++
                return 1

        self._cbs.append(trampoline)
        with self._live() as h:
            setter(h, trampoline)

    def engine_all_reduce(self, peers_csv: str, buf, elem_size: int,
                          dtype_code: int, op_code: int, graph_data,
                          pair_offsets, n_pairs: int, tag: str,
                          hash_mode: int, chunk_size: int, timeout: float,
                          max_threads: int, stats) -> int:
        """Fully-native chunked graph allreduce; ``buf`` (writable
        contiguous, e.g. numpy) is reduced in place.  ``graph_data`` /
        ``pair_offsets`` / ``stats`` are int32/int32/float64 numpy arrays.
        Returns the raw C return code (0 ok / 1 timeout / 2 closed ...)."""
        mv = memoryview(buf)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        with self._live() as h:
            return self._libref.kf_engine_all_reduce(
                h, peers_csv.encode(), addr, mv.nbytes, elem_size,
                dtype_code, op_code,
                graph_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pair_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                n_pairs, tag.encode(), hash_mode, chunk_size, timeout,
                max_threads,
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
