"""Host-side message channel between workers (trimmed copy of
``kungfu_tpu/comm/host.py``).

Typed, named messages between peers, rendezvous-by-name receive queues,
connect retries while peers come up, and version-token fencing: every
COLLECTIVE message is queued under the cluster-version token it was sent
with and only read under the receiver's current token, so a stale
payload never aliases a later epoch's collective.  The channel carries
control traffic, the host-plane moves of sharded state (the re-carve
segments of :mod:`kungfu_tpu_torch.elastic.reshard`) and the host
collective engine's chunks (:mod:`kungfu_tpu_torch.comm.engine`).

Wire format (little-endian), the reference's byte for byte, so a port
endpoint and a reference endpoint exchange messages:

    magic u32 | token u32 | conn_type u8 | src_len u16 | src utf8
    | name_len u16 | name utf8 | payload_len u32 | payload

Two interoperable backends implement the wire and the API:

* :class:`NativeHostChannel` -- the accept loop, framed decode,
  rendezvous queues, fencing and pooled sender run in C++ threads
  (:file:`kungfu_tpu_torch/native/transport.cpp`, a copy of the
  reference's), and the host engine's whole allreduce can run there;
* :class:`PyHostChannel` -- pure-Python sockets, always available.

:func:`HostChannel` is the factory, chosen as the reference's
``_backend()`` chooses: ``KF_TPU_HOST_TRANSPORT`` ``native`` | ``python``
| ``auto`` (the default: native whenever the native library loads).

Differences from the reference: the Python backend is TCP only (no Unix
socket listener for colocated peers: a sender falls back to TCP when it
finds no socket file); it reads a payload with ``recv_into`` into one
``bytearray`` and queues that buffer, with no copy per chunk.  Either
backend made with port 0 binds a port the OS assigns and reports it in
``self_id``.  ``monitor=`` takes a
:class:`~kungfu_tpu_torch.monitor.metrics.NetMonitor`: both backends
count payload bytes per remote peer into it where the reference's do,
the Python one on each send and each dispatched frame, the native one
from the C++ counters, polled every 0.5 s.
"""

from __future__ import annotations

import enum
import os
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.native import np_view
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.retry import jittered

_log = get_logger("host-chan")

MAGIC = 0x4B465450  # "KFTP"
#: the wire is unauthenticated, so lengths from a stray connection are
#: bounded, and senders enforce the same bound
MAX_FRAME = 3 << 30
MAX_META_LEN = 4096
CONNECT_RETRIES = 500
CONNECT_RETRY_PERIOD_S = 0.2  # reference: 500 x 200ms (config.go:16-18)
#: per-attempt TCP connect timeout
CONNECT_TIMEOUT_S = 10.0
#: how often an accept loop checks for close (the bound on close's wait)
POLL_INTERVAL_S = 0.05

USE_UNIXSOCK = envs.USE_UNIXSOCK

#: default ceiling on the load-scaled pools (``KF_CONFIG_HOST_POOL_MAX``)
HOST_POOL_CAP_DEFAULT = 16
#: PEER_TO_PEER names reserved for the serving plane's frames: the blob
#: store's p2p handler skips them (store/p2p.py)
SERVE_NAME_PREFIX = "req.srv"


def host_pool_size(n_peers: int, floor: int = 2,
                   pool: str = "host") -> int:
    """Pool size scaled with the peer count (reference
    ``comm/host.py:88``): one slot per peer, floored at ``floor`` and
    capped by ``KF_CONFIG_HOST_POOL_MAX`` (default 16; the cap wins over
    the floor).  Exported as the ``kf_host_pool_size{pool=...}`` gauge."""
    cap = max(1, envs.parse_int_env(envs.HOST_POOL_MAX,
                                    HOST_POOL_CAP_DEFAULT))
    size = max(1, min(cap, max(int(floor), int(n_peers))))
    REGISTRY.gauge("kf_host_pool_size", pool=pool).set(size)
    return size


def unixsock_enabled() -> bool:
    """Colocated native channels also listen on a unix domain socket
    (reference ``UseUnixSock=true``); opt out with
    ``KF_TPU_USE_UNIXSOCK=0``."""
    return os.environ.get(USE_UNIXSOCK, "1").lower() not in ("0", "false",
                                                             "no")


def unix_sock_path(host: str, port: int) -> str:
    """The sockfile of the peer at ``host:port``; must match the C++
    transport's scheme (``native/transport.cpp unix_sock_path``).  It
    lives in a per-uid mode-0700 directory, ``KF_SOCK_DIR`` or
    ``/tmp/kf-tpu-<uid>``; a directory that is not private and ours
    raises ``OSError``."""
    base = os.environ.get("KF_SOCK_DIR") or f"/tmp/kf-tpu-{os.getuid()}"
    os.makedirs(base, mode=0o700, exist_ok=True)
    st = os.lstat(base)
    import stat as _stat

    if (not _stat.S_ISDIR(st.st_mode) or st.st_uid != os.getuid()
            or (st.st_mode & 0o077) != 0):
        raise OSError(f"unsafe socket dir {base}: not a private dir owned "
                      f"by uid {os.getuid()}")
    return f"{base}/{host}-{port}.sock"


class ConnType(enum.IntEnum):
    """Reference ``message.go:12-17``."""

    PING = 1
    CONTROL = 2
    COLLECTIVE = 3
    PEER_TO_PEER = 4


class _Msg:
    __slots__ = ("token", "conn_type", "src", "name", "payload")

    def __init__(self, token, conn_type, src, name, payload):
        self.token = token
        self.conn_type = conn_type
        self.src = src
        self.name = name
        self.payload = payload


class HeaderCodec:
    """The one place that packs and unpacks the fixed header fields:
    ``magic u32 | token u32 | conn_type u8 | src_len u16``, then the
    ``name_len u16`` and ``payload_len u32`` length prefixes."""

    HEAD_FMT = "<IIBH"
    HEAD_SIZE = struct.calcsize(HEAD_FMT)  # 11
    NAME_LEN_FMT = "<H"
    NAME_LEN_SIZE = struct.calcsize(NAME_LEN_FMT)
    PAYLOAD_LEN_FMT = "<I"
    PAYLOAD_LEN_SIZE = struct.calcsize(PAYLOAD_LEN_FMT)

    @staticmethod
    def pack_head(token: int, conn_type: int, src: bytes, name: bytes,
                  payload_len: int) -> bytes:
        return (
            struct.pack(HeaderCodec.HEAD_FMT, MAGIC, token, conn_type, len(src))
            + src
            + struct.pack(HeaderCodec.NAME_LEN_FMT, len(name))
            + name
            + struct.pack(HeaderCodec.PAYLOAD_LEN_FMT, payload_len)
        )

    @staticmethod
    def unpack_head(head) -> Tuple[int, int, int, int]:
        """``(magic, token, conn_type, src_len)`` from the fixed prefix."""
        return struct.unpack(HeaderCodec.HEAD_FMT, head)

    @staticmethod
    def unpack_name_len(raw) -> int:
        (name_len,) = struct.unpack(HeaderCodec.NAME_LEN_FMT, raw)
        return name_len

    @staticmethod
    def unpack_payload_len(raw) -> int:
        (payload_len,) = struct.unpack(HeaderCodec.PAYLOAD_LEN_FMT, raw)
        return payload_len


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes read into one buffer.  Each stream thread blocks here
    for as long as its peer keeps the connection; ``close`` shuts the
    socket down, which ends the read with ``ConnectionError``."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("peer closed mid-message")
        got += k
    return buf


def _payload_nbytes(payload) -> int:
    return memoryview(payload).nbytes


def _encode_head(token: int, conn_type: int, src: str, name: str,
                 nbytes: int) -> bytes:
    if nbytes > MAX_FRAME:
        raise ValueError(f"payload of {nbytes} bytes exceeds the 3 GiB "
                         "frame limit")
    return HeaderCodec.pack_head(token, conn_type, src.encode(),
                                 name.encode(), nbytes)


def _encode(token: int, conn_type: int, src: str, name: str,
            payload: bytes) -> bytes:
    return _encode_head(token, conn_type, src, name, len(payload)) + payload


def _decode(sock: socket.socket) -> _Msg:
    magic, token, conn_type, src_len = HeaderCodec.unpack_head(
        _read_exact(sock, HeaderCodec.HEAD_SIZE))
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if src_len > MAX_META_LEN:
        raise ValueError(f"src field of {src_len} bytes over limit")
    src = _read_exact(sock, src_len).decode()
    name_len = HeaderCodec.unpack_name_len(
        _read_exact(sock, HeaderCodec.NAME_LEN_SIZE))
    if name_len > MAX_META_LEN:
        raise ValueError(f"name field of {name_len} bytes over limit")
    name = _read_exact(sock, name_len).decode()
    payload_len = HeaderCodec.unpack_payload_len(
        _read_exact(sock, HeaderCodec.PAYLOAD_LEN_SIZE))
    if payload_len > MAX_FRAME:
        raise ValueError(f"payload of {payload_len} bytes over the frame limit")
    return _Msg(token, conn_type, src, name, _read_exact(sock, payload_len))


class _ChannelOps:
    """Control-plane collectives over ``send``/``recv``, star-rooted at
    rank 0 (small payloads, infrequent)."""

    def wait(self, peer: PeerID, timeout: float = 120.0) -> None:
        """Poll-ping until the peer is up (reference ``client.go:47-59``)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.ping(peer):
                return
            time.sleep(CONNECT_RETRY_PERIOD_S)
        raise TimeoutError(f"peer {peer} not up after {timeout}s")

    def _rank(self, peers: PeerList) -> int:
        r = peers.rank(self.self_id)
        if r is None:
            raise RuntimeError(f"{self.self_id} not in {peers}")
        return r

    def gather_bytes(self, data: bytes, peers: PeerList, name: str,
                     send_retries: int = CONNECT_RETRIES) -> Optional[List[bytes]]:
        """Root (rank 0) returns all peers' payloads in rank order; the
        others return ``None``.  ``send_retries`` bounds the connect
        ladder toward the root."""
        rank = self._rank(peers)
        if rank == 0:
            out = [data]
            for p in list(peers)[1:]:
                out.append(self.recv(p, name))
            return out
        self.send(peers[0], name, data, retries=send_retries)
        return None

    def broadcast_bytes(self, data: Optional[bytes], peers: PeerList,
                        name: str,
                        send_retries: int = CONNECT_RETRIES) -> bytes:
        rank = self._rank(peers)
        if rank == 0:
            if data is None:
                raise ValueError("broadcast_bytes: rank 0 must supply data")
            for p in list(peers)[1:]:
                self.send(p, name, data, retries=send_retries)
            return data
        return self.recv(peers[0], name)

    def allgather_bytes(self, data: bytes, peers: PeerList,
                        name: str) -> List[bytes]:
        gathered = self.gather_bytes(data, peers, name + ".g")
        blob = _pack_list(gathered) if self._rank(peers) == 0 else None
        return _unpack_list(self.broadcast_bytes(blob, peers, name + ".b"))

    def barrier(self, peers: PeerList, name: str = "barrier") -> None:
        self.gather_bytes(b"", peers, name + ".in")
        self.broadcast_bytes(b"" if self._rank(peers) == 0 else None, peers,
                             name + ".out")

    def consensus_bytes(self, data: bytes, peers: PeerList,
                        name: str = "consensus",
                        send_retries: int = CONNECT_RETRIES) -> bool:
        """True iff all peers supplied identical bytes (reference
        ``session.go:124-155``)."""
        gathered = self.gather_bytes(data, peers, name + ".g",
                                     send_retries=send_retries)
        if self._rank(peers) == 0:
            ok = all(g == gathered[0] for g in gathered)
            self.broadcast_bytes(b"\x01" if ok else b"\x00", peers,
                                 name + ".b", send_retries=send_retries)
            return ok
        return self.broadcast_bytes(None, peers, name + ".b") == b"\x01"


class PyHostChannel(_ChannelOps):
    """The pure-Python backend.

    ``token`` is the cluster version; :meth:`set_token` moves to a new
    epoch, purging the COLLECTIVE queues of older epochs and discarding
    any late stale-epoch arrival (fencing).  ``self_id.port == 0`` binds
    a port the OS assigns; :attr:`self_id` then carries it.
    """

    def __init__(self, self_id: PeerID, token: int = 0, bind_host: str = "",
                 monitor=None):
        self.monitor = monitor
        self._token = token
        self._queues: Dict[Tuple[int, str, str, int], queue.Queue] = {}
        self._qlock = threading.Lock()
        self._control_handlers = []
        self._p2p_handlers = []
        self._pool: Dict[PeerID, list] = {}
        self._pool_lock = threading.Lock()
        #: accepted sockets, shut down on close so their readers end
        self._streams = set()
        self._streams_lock = threading.Lock()

        chan = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # stream loop: a pooled client sends many messages on
                # one connection (reference Stream(), handler.go:30-41)
                with chan._streams_lock:
                    chan._streams.add(self.request)
                try:
                    while True:
                        try:
                            msg = _decode(self.request)
                        except (ConnectionError, ValueError, OSError) as e:
                            _log.debug("connection done: %s", e)
                            return
                        chan._dispatch(msg, self.request)
                finally:
                    with chan._streams_lock:
                        chan._streams.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((bind_host or "0.0.0.0", self_id.port), Handler)
        self.self_id = PeerID(self_id.host, self._server.server_address[1])
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(POLL_INTERVAL_S,), daemon=True)
        self._thread.start()

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self.reset_connections()
        self._server.shutdown()
        self._server.server_close()
        with self._streams_lock:
            streams = list(self._streams)
        for s in streams:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def set_token(self, token: int) -> None:
        """Move to a new cluster epoch; purge collective queues of older
        epochs (their contents can never legally be read again)."""
        self._token = token
        with self._qlock:
            dead = [k for k in self._queues
                    if k[0] == ConnType.COLLECTIVE and k[3] < token]
            for k in dead:
                del self._queues[k]

    @property
    def token(self) -> int:
        return self._token

    # -- dispatch --------------------------------------------------------
    def _queue(self, conn_type: int, src: str, name: str,
               token: int = 0) -> queue.Queue:
        # COLLECTIVE queues are keyed by epoch token, so a stale queued
        # payload never aliases a same-named collective of a later epoch
        with self._qlock:
            if conn_type == ConnType.COLLECTIVE and token < self._token:
                # late stale-epoch arrival: nothing will read it
                return queue.Queue()
            key = (conn_type, src, name,
                   token if conn_type == ConnType.COLLECTIVE else 0)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = queue.Queue()
            return q

    def _dispatch(self, msg: _Msg, sock: socket.socket) -> None:
        if self.monitor is not None:
            self.monitor.ingress(msg.src, len(msg.payload))
        if msg.conn_type == ConnType.PING:
            try:
                sock.sendall(_encode(self._token, ConnType.PING,
                                     str(self.self_id), msg.name, b""))
            except OSError:
                pass
            return
        # a future-epoch COLLECTIVE arriving before this peer bumps its
        # token is kept under its own token, not dropped: the sender has
        # moved on and will not resend
        if msg.conn_type == ConnType.CONTROL and self._control_handlers:
            for h in list(self._control_handlers):
                h(msg.name, msg.payload, msg.src)
            return
        if (msg.conn_type == ConnType.PEER_TO_PEER
                and msg.name.startswith("req.") and self._p2p_handlers):
            for h in list(self._p2p_handlers):
                h(msg.name, msg.payload, msg.src)
            return
        self._queue(msg.conn_type, msg.src, msg.name, msg.token).put(msg.payload)

    def on_control(self, handler) -> None:
        """Register ``handler(name, payload, src)`` for CONTROL messages."""
        self._control_handlers.append(handler)

    def on_p2p_request(self, handler) -> None:
        """Register ``handler(name, payload, src)`` for PEER_TO_PEER
        messages named ``req.*`` (the blob store's responder)."""
        self._p2p_handlers.append(handler)

    # -- client side -----------------------------------------------------
    def _connect(self, peer: PeerID, retries=CONNECT_RETRIES) -> socket.socket:
        last = None
        for _ in range(retries):
            try:
                return socket.create_connection((peer.host, peer.port),
                                                timeout=CONNECT_TIMEOUT_S)
            except OSError as e:
                last = e
                # jittered, mean-preserving: N workers retrying one cold
                # peer decorrelate instead of colliding every 200 ms
                time.sleep(jittered(CONNECT_RETRY_PERIOD_S))
        raise ConnectionError(f"cannot reach {peer} after {retries} retries: {last}")

    def _pooled(self, peer: PeerID):
        """The persistent send connection slot to ``peer`` and its lock;
        the connect happens in :meth:`send` under that lock, so two
        first sends cannot both connect."""
        with self._pool_lock:
            entry = self._pool.get(peer)
            if entry is None:
                entry = self._pool[peer] = [None, threading.Lock()]
            return entry

    def send(self, peer: PeerID, name: str, payload,
             conn_type: ConnType = ConnType.COLLECTIVE,
             retries: int = CONNECT_RETRIES) -> None:
        """Send ``payload`` (bytes or any contiguous buffer, sent without
        a copy) to ``peer`` under ``name``."""
        nbytes = _payload_nbytes(payload)
        head = _encode_head(self._token, conn_type, str(self.self_id), name,
                            nbytes)
        if timeline.enabled():
            timeline.event("send", name, peer=str(peer), nbytes=nbytes,
                           conn=int(conn_type))
        if self.monitor is not None:
            # payload bytes on both sides (ingress counts the same), so
            # the totals of a symmetric exchange match
            self.monitor.egress(str(peer), nbytes)
        entry = self._pooled(peer)
        with entry[1]:
            if entry[0] is None:
                entry[0] = self._connect(peer, retries)
            try:
                entry[0].sendall(head)
                entry[0].sendall(payload)
            except OSError:
                # stale pooled socket (peer restarted): reconnect once
                self._drop(entry)
                entry[0] = self._connect(peer, retries)
                try:
                    entry[0].sendall(head)
                    entry[0].sendall(payload)
                except OSError:
                    # a half-written frame must never stay pooled: the
                    # receiver would parse payload bytes as a header
                    self._drop(entry)
                    raise

    def chaos_partial_send(self, peer: PeerID, name: str, payload,
                           nbytes: int,
                           conn_type: ConnType = ConnType.COLLECTIVE) -> None:
        """Fault-injection primitive of the ``reset`` chaos clause: a
        frame whose header promises the whole payload, then only its
        first ``nbytes`` bytes, then a closed socket, on a connection of
        its own so the pooled one stays intact for the retry."""
        head = _encode_head(self._token, conn_type, str(self.self_id), name,
                            _payload_nbytes(payload))
        sock = self._connect(peer, retries=5)
        try:
            sock.sendall(head)
            sock.sendall(memoryview(payload).cast("B")[:nbytes])
        finally:
            try:
                sock.close()
            except OSError:
                pass

    @staticmethod
    def _drop(entry) -> None:
        try:
            entry[0].close()
        except OSError:
            pass
        entry[0] = None

    def reset_connections(self) -> None:
        """Drop pooled connections (on membership change; reference
        ``client.go:82``).  Sockets close without taking the per-entry
        locks, so a sender stuck toward a dead peer cannot block this."""
        with self._pool_lock:
            entries = list(self._pool.values())
            self._pool.clear()
        for entry in entries:
            sock = entry[0]
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def recv(self, src: PeerID, name: str,
             conn_type: ConnType = ConnType.COLLECTIVE,
             timeout: Optional[float] = 60.0):
        """The payload of the next message ``name`` from ``src`` (the
        buffer it was read into); ``TimeoutError`` after ``timeout``."""
        try:
            payload = self._queue(conn_type, str(src), name,
                                  self._token).get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"recv {name!r} from {src} timed out after "
                               f"{timeout}s") from None
        if timeline.enabled():
            timeline.event("recv", name, peer=str(src), nbytes=len(payload),
                           conn=int(conn_type))
        return payload

    def recv_into(self, src: PeerID, name: str, buf,
                  conn_type: ConnType = ConnType.COLLECTIVE,
                  timeout: Optional[float] = 60.0) -> bool:
        """Receive into ``buf`` (any writable contiguous buffer): one
        copy from the queued payload.  False on a size mismatch, with the
        payload left queued for :meth:`recv`."""
        q = self._queue(conn_type, str(src), name, self._token)
        try:
            payload = q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"recv_into {name!r} from {src} timed out "
                               f"after {timeout}s") from None
        mv = memoryview(buf).cast("B")
        if len(payload) != mv.nbytes:
            # put it back for recv() (rendezvous names are unique per op)
            q.put(payload)
            return False
        mv[:] = payload
        if timeline.enabled():
            timeline.event("recv", name, peer=str(src), nbytes=mv.nbytes,
                           conn=int(conn_type))
        return True

    def post_recv(self, src: PeerID, name: str, buf,
                  conn_type: ConnType = ConnType.COLLECTIVE):
        """The native channel's registered receive, in its API: this
        backend registers nothing, so ``wait()`` is :meth:`recv_into`."""
        chan = self

        class _Posted:
            def wait(self, timeout: Optional[float] = 60.0) -> bool:
                return chan.recv_into(src, name, buf, conn_type, timeout)

            def abort(self) -> None:
                pass

        return _Posted()

    def ping(self, peer: PeerID, timeout: float = 10.0) -> bool:
        try:
            with socket.create_connection((peer.host, peer.port),
                                          timeout=timeout) as sock:
                sock.sendall(_encode(self._token, ConnType.PING,
                                     str(self.self_id), "ping", b""))
                _decode(sock)
                return True
        except (OSError, ValueError, ConnectionError):
            return False


class NativeHostChannel(_ChannelOps):
    """C++ backend (reference ``comm/host.py:697``): the same API and wire
    format, served by native threads (:file:`native/transport.cpp`).
    ``self_id.port == 0`` binds a port the OS assigns; :attr:`self_id`
    then carries it.  Python is entered only for registered control
    handlers."""

    def __init__(self, self_id: PeerID, token: int = 0, bind_host: str = "",
                 monitor=None):
        from kungfu_tpu_torch.native.transport import NativeTransport

        self.monitor = monitor
        self._t = NativeTransport(
            str(self_id), self_id.port, bind_host=bind_host, token=token,
            use_unix=unixsock_enabled(),
        )
        self.self_id = PeerID(self_id.host, self._t.port)
        self._control_handlers = []
        self._p2p_handlers = []
        self._t.set_control_handler(self._run_handlers(self._control_handlers))
        self._t.set_p2p_handler(self._run_handlers(self._p2p_handlers))
        self._ingress_seen: Dict[str, int] = {}
        self._egress_seen: Dict[str, int] = {}
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        if monitor is not None:
            # the C++ side counts both directions (the native executor
            # sends without crossing this wrapper); a thread feeds the
            # deltas to the monitor
            self._poll_thread = threading.Thread(target=self._counter_poll,
                                                 daemon=True)
            self._poll_thread.start()

    @staticmethod
    def _run_handlers(handlers):
        def run(name: str, payload: bytes, src: str) -> bool:
            if not handlers:
                return False  # fall through to the C++ rendezvous queue
            for h in list(handlers):
                h(name, payload, src)
            return True

        return run

    def poll_counters(self) -> None:
        """Feed the C++ byte counters' growth since the last poll to the
        monitor (the poll thread calls it every 0.5 s; :meth:`close`
        calls it once more)."""
        try:
            ingress = self._t.ingress_totals()
            egress = self._t.egress_totals()
        except ConnectionError:  # closed under the poll
            return
        for seen, totals, kind in ((self._ingress_seen, ingress, "ingress"),
                                   (self._egress_seen, egress, "egress")):
            for addr, total in totals.items():
                delta = total - seen.get(addr, 0)
                if delta > 0:
                    seen[addr] = total
                    getattr(self.monitor, kind)(addr, delta)

    def _counter_poll(self) -> None:
        while not self._poll_stop.wait(0.5):
            self.poll_counters()

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None
            self.poll_counters()
        self._t.close()

    def set_token(self, token: int) -> None:
        self._t.set_token(token)

    @property
    def token(self) -> int:
        return self._t.token

    def on_control(self, handler) -> None:
        """Register ``handler(name, payload, src)`` for CONTROL messages."""
        self._control_handlers.append(handler)

    def on_p2p_request(self, handler) -> None:
        """Register ``handler(name, payload, src)`` for PEER_TO_PEER
        messages named ``req.*`` (the blob store's responder)."""
        self._p2p_handlers.append(handler)

    # -- client side -----------------------------------------------------
    def send(self, peer: PeerID, name: str, payload,
             conn_type: ConnType = ConnType.COLLECTIVE,
             retries: int = CONNECT_RETRIES) -> None:
        """Send ``payload`` (bytes or any contiguous buffer, passed by
        pointer to the C++ writer) to ``peer`` under ``name``.  The
        timeline mark covers frames that cross this wrapper; the engine's
        fully native collectives show as their collective span."""
        if timeline.enabled():
            timeline.event("send", name, peer=str(peer),
                           nbytes=_payload_nbytes(payload),
                           conn=int(conn_type))
        self._t.send(str(peer), name, payload, int(conn_type), retries)

    def recv(self, src: PeerID, name: str,
             conn_type: ConnType = ConnType.COLLECTIVE,
             timeout: Optional[float] = 60.0) -> bytes:
        payload = self._t.recv(str(src), name, int(conn_type), timeout)
        if timeline.enabled():
            timeline.event("recv", name, peer=str(src), nbytes=len(payload),
                           conn=int(conn_type))
        return payload

    def recv_into(self, src: PeerID, name: str, buf,
                  conn_type: ConnType = ConnType.COLLECTIVE,
                  timeout: Optional[float] = 60.0) -> bool:
        """Zero-copy receive into ``buf`` (a writable contiguous buffer):
        socket to buffer in the C++ stream thread.  False on a size
        mismatch, with the payload left queued for :meth:`recv`."""
        return self._t.recv_into(str(src), name, int(conn_type), timeout, buf)

    def post_recv(self, src: PeerID, name: str, buf,
                  conn_type: ConnType = ConnType.COLLECTIVE):
        """Register ``buf`` for a receive before the matching request
        leaves, so the reply streams from the socket into ``buf`` even
        when it arrives first.  ``wait()`` is True when filled, False on
        a queued payload of another size (then :meth:`recv`); ``abort()``
        when the request was never sent.  The handle keeps ``buf`` alive
        until it resolves: the C++ stream thread writes into it."""
        t, s, ct = self._t, str(src), int(conn_type)
        handle = t.recv_begin(s, name, ct, buf)

        class _Posted:
            def __init__(self):
                self._h = handle
                self._buf = buf

            def wait(self, timeout: Optional[float] = 60.0) -> bool:
                if self._h is None:  # a payload of another size is queued
                    return False
                h, self._h = self._h, None
                try:
                    return t.recv_finish(s, name, ct, timeout, h)
                finally:
                    self._buf = None

            def abort(self) -> None:
                if self._h is not None:
                    h, self._h = self._h, None
                    t.recv_abort(s, name, ct, h)
                    self._buf = None

        return _Posted()

    def ping(self, peer: PeerID, timeout: float = 10.0) -> bool:
        return self._t.ping(str(peer), timeout)

    def reset_connections(self) -> None:
        self._t.reset_connections()


def _backend() -> str:
    """Reference ``comm/host.py:880``: ``KF_TPU_HOST_TRANSPORT`` names the
    backend; ``auto`` takes native whenever the library loads."""
    mode = os.environ.get(envs.HOST_TRANSPORT, "auto").lower()
    if mode in ("native", "python"):
        return mode
    from kungfu_tpu_torch.native import transport as _nt

    return "native" if _nt.available() else "python"


def HostChannel(self_id: PeerID, token: int = 0, bind_host: str = "",
                monitor=None):
    """Factory: the native (C++) channel when available, else Python."""
    if _backend() == "native":
        try:
            return NativeHostChannel(self_id, token=token,
                                     bind_host=bind_host, monitor=monitor)
        except RuntimeError:  # toolchain raced away; stay functional
            _log.warning("native transport unavailable, using python "
                         "backend")
    return PyHostChannel(self_id, token=token, bind_host=bind_host,
                         monitor=monitor)


def bind_own_host_channel(self_id: PeerID, token: int = 0, monitor=None):
    """The peer's channel, bound to its own advertised address (local
    clusters of loopback aliases give every alias the same ports), or
    to the wildcard when that address is not bindable here."""
    try:
        return HostChannel(self_id, token=token, bind_host=self_id.host,
                           monitor=monitor)
    except OSError as e:
        _log.warning("cannot bind %s (%s); binding the wildcard instead",
                     self_id.host, e)
        return HostChannel(self_id, token=token, monitor=monitor)


def tensor_buffer(t: torch.Tensor):
    """The bytes of a contiguous host tensor as a writable buffer (a
    numpy view, no copy; bf16 as its 16-bit patterns) for :meth:`send`
    and :meth:`recv_into`."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"a host buffer needs a contiguous CPU tensor, got "
                         f"{t.device} stride {t.stride()}")
    return np_view(t)


def _pack_list(items: List[bytes]) -> bytes:
    out = [struct.pack("<I", len(items))]
    for it in items:
        out.append(struct.pack("<I", len(it)))
        out.append(it)
    return b"".join(out)


def _unpack_list(blob) -> List[bytes]:
    (n,), off = struct.unpack_from("<I", blob), 4
    items = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", blob, off)
        off += 4
        items.append(bytes(blob[off:off + ln]))
        off += ln
    return items
