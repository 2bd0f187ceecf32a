"""P2P blob request/response over the host channel (copy of
``kungfu_tpu/store/p2p.py``): the requester names a blob (and a
version), the responder streams it back or flags a miss.  Two reply
framings, as the reference's: a status byte then the body
(:func:`remote_request`), or the raw body straight into the
requester's buffer, an empty payload for a miss
(:func:`remote_request_into`).
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
from typing import Optional

from kungfu_tpu_torch.comm.host import (SERVE_NAME_PREFIX, ConnType,
                                        host_pool_size)
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.plan.peer import PeerID, parse_peer_id
from kungfu_tpu_torch.store.store import get_local_store
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("p2p-store")
_req_counter = itertools.count()
_OK = b"\x01"
_FAIL = b"\x00"


def install_p2p_handler(channel, store=None, control_store=None,
                        n_peers: Optional[int] = None):
    """Make ``channel`` answer blob requests from ``store`` (default: the
    process-wide store); names under the reserved ``kf.`` prefix are
    served from ``control_store``, whose eviction window the per-step
    blobs of gossip cannot push a control record out of.

    Requests are answered on a responder pool, never on the channel's
    receive path: a large reply blocks on TCP backpressure, and a stream
    thread writing it would stop draining its own socket.  The pool
    scales with the peer count (``host_pool_size``), or
    ``KF_CONFIG_P2P_RESPONDERS`` pins it.  Returns ``stop()``."""
    serve_q: "queue.Queue" = queue.Queue()

    def serve(name: str, payload: bytes, src: str):
        # name = "req.<id>"; payload = json {"name", "version", "raw",
        # "tc": an optional trace context}
        req_id = name[len("req."):]
        raw = False
        try:
            req = json.loads(bytes(payload).decode())
            blob_name = req["name"]
            if timeline.enabled():
                tr, parent = timeline.parse_trace_context(req.get("tc"))
                timeline.event("mark", "p2p.serve", req=req_id,
                               blob=str(blob_name),
                               **timeline.context_attrs(tr, parent))
            raw = bool(req.get("raw"))
            st = (control_store
                  if control_store is not None and blob_name.startswith("kf.")
                  else (store or get_local_store()))
            blob = st.get(blob_name, req.get("version") or None)
        except (ValueError, KeyError) as e:
            _log.warning("bad p2p request from %s: %s", src, e)
            blob = None
        if raw:
            # the blob itself is the payload; a miss is the empty one
            body = blob if blob is not None else b""
        else:
            body = (_OK + bytes(blob)) if blob is not None else _FAIL
        try:
            channel.send(parse_peer_id(src), f"rsp.{req_id}", body,
                         ConnType.PEER_TO_PEER, retries=5)
        except ConnectionError as e:
            _log.warning("cannot answer %s: %s", src, e)

    def responder():
        while True:
            item = serve_q.get()  # stop() enqueues one None a thread
            if item is None:
                return
            try:
                serve(*item)
            except Exception as e:  # noqa: BLE001 - keep serving
                _log.warning("p2p serve failed: %s", e)

    override = os.environ.get(envs.P2P_RESPONDERS, "").strip()
    if override:
        n_threads = max(1, int(override))
        from kungfu_tpu_torch.monitor.registry import REGISTRY

        REGISTRY.gauge("kf_host_pool_size", pool="p2p").set(n_threads)
    else:
        n_threads = host_pool_size(n_peers if n_peers is not None else 2,
                                   pool="p2p")
    threads = [threading.Thread(target=responder,
                                name=f"kf-p2p-responder-{i}", daemon=True)
               for i in range(n_threads)]
    for t in threads:
        t.start()

    def handle(name: str, payload: bytes, src: str):
        # on the channel's receive path: hand off and return.  Names
        # under the serving plane's prefix are its own responder's
        if name.startswith(SERVE_NAME_PREFIX):
            return
        serve_q.put((name, payload, src))

    channel.on_p2p_request(handle)

    def stop(join_timeout: float = 5.0):
        for _ in threads:
            serve_q.put(None)
        for t in threads:
            t.join(join_timeout)

    return stop


def _req_meta(name: str, version: Optional[str], **extra) -> dict:
    """The request frame's JSON; an ambient trace context rides along as
    ``tc``."""
    meta = {"name": name, "version": version or "", **extra}
    tc = timeline.format_trace_context(*timeline.current_trace())
    if tc is not None:
        meta["tc"] = tc
    return meta


def _serve_locally(peer, target: PeerID, name: str, version: Optional[str]):
    """``(True, blob)`` for a request that never needs the wire: no
    channel, or a request of this peer's own store."""
    own_store = getattr(peer, "store", None)
    if name.startswith("kf."):
        own_store = getattr(peer, "_ctrl_store", None) or own_store
    if peer.channel is None or target == peer.config.self_id:
        st = own_store if own_store is not None else get_local_store()
        return True, st.get(name, version)
    return False, None


def remote_request(peer, target: PeerID, name: str,
                   version: Optional[str] = None,
                   timeout: float = 60.0) -> Optional[bytes]:
    """Blob ``name`` from ``target``'s store; None when it has none."""
    channel = peer.channel
    local, blob = _serve_locally(peer, target, name, version)
    if local:
        return blob if blob is None or isinstance(blob, bytes) else bytes(blob)
    req_id = f"{peer.config.self_id.port}-{next(_req_counter)}"
    body = json.dumps(_req_meta(name, version)).encode()
    channel.send(target, f"req.{req_id}", body, ConnType.PEER_TO_PEER)
    rsp = channel.recv(target, f"rsp.{req_id}", ConnType.PEER_TO_PEER,
                       timeout=timeout)
    if bytes(rsp[:1]) != _OK:
        return None
    return bytes(rsp[1:])


def remote_request_into(peer, target: PeerID, name: str, buf,
                        version: Optional[str] = None,
                        timeout: float = 60.0,
                        send_retries: Optional[int] = None):
    """Blob ``name`` from ``target`` into ``buf`` (a writable contiguous
    buffer of the expected size).  The destination is registered before
    the request leaves, so on the native channel the reply streams from
    the socket into ``buf``.  Returns ``buf`` when filled, the raw bytes
    when the blob's size differs from ``buf``'s, None on a miss.
    ``send_retries`` bounds the request's connect ladder."""
    channel = peer.channel
    local, blob = _serve_locally(peer, target, name, version)
    if local:
        if blob is None:
            return None
        src = memoryview(blob)
        dst = memoryview(buf)
        if src.nbytes == dst.nbytes:
            dst.cast("B")[:] = src.cast("B")
            return buf
        return bytes(src)
    req_id = f"{peer.config.self_id.port}-{next(_req_counter)}"
    body = json.dumps(_req_meta(name, version, raw=1)).encode()
    posted = channel.post_recv(target, f"rsp.{req_id}", buf,
                               ConnType.PEER_TO_PEER)
    kw = {} if send_retries is None else {"retries": send_retries}
    try:
        channel.send(target, f"req.{req_id}", body, ConnType.PEER_TO_PEER,
                     **kw)
    except BaseException:
        posted.abort()
        raise
    if posted.wait(timeout=timeout):
        return buf
    # a size mismatch left the payload queued: the miss marker (empty)
    # or a blob of another size
    rsp = channel.recv(target, f"rsp.{req_id}", ConnType.PEER_TO_PEER,
                       timeout=timeout)
    return bytes(rsp) if rsp else None
