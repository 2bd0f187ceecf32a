"""Peer identity (copy of ``kungfu_tpu/plan/peer.py``).

A peer is identified by ``(host, port)``, as in the reference's
``srcs/go/plan/{id,addr}.go``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_PEER_RE = re.compile(r"^(?P<host>[^:]+):(?P<port>\d+)$")


@dataclass(frozen=True, order=True)
class PeerID:
    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"

    def sock_file(self) -> str:
        """The reference's Unix-socket path for colocated peers
        (``plan/addr.go:24``); the port's host channel is TCP only."""
        return f"/tmp/kungfu-tpu-{self.port}.sock"

    def named_addr(self, name: str) -> str:
        return f"{self}#{name}"


def parse_peer_id(s: str) -> PeerID:
    m = _PEER_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid peer id {s!r}; want host:port")
    return PeerID(m.group("host"), int(m.group("port")))
