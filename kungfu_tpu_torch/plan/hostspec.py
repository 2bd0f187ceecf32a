"""Host specifications and host lists (copy of
``kungfu_tpu/plan/hostspec.py``; reference ``srcs/go/plan/hostspec.go``).

A host spec is ``ip:slots[:public_addr]``; a host list generates runner
lists and peer lists capped at a total ``np``.  The default worker port
range 10000-11000 and runner port 38080 are the reference's
(``hostspec.go:121-126``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.plan.peerlist import PeerList

DEFAULT_RUNNER_PORT = 38080
DEFAULT_PORT_RANGE = (10000, 11000)


@dataclass(frozen=True)
class HostSpec:
    ip: str
    slots: int
    public_addr: str = ""

    def __post_init__(self):
        if self.slots < 0:
            raise ValueError(f"negative slots on host {self.ip}")
        if not self.public_addr:
            object.__setattr__(self, "public_addr", self.ip)

    def __str__(self) -> str:
        return f"{self.ip}:{self.slots}:{self.public_addr}"

    @classmethod
    def parse(cls, s: str) -> "HostSpec":
        parts = s.strip().split(":")
        if len(parts) == 1:
            return cls(parts[0], 1)
        if len(parts) == 2:
            return cls(parts[0], int(parts[1]))
        if len(parts) == 3:
            return cls(parts[0], int(parts[1]), parts[2])
        raise ValueError(f"invalid host spec {s!r}; want ip[:slots[:public_addr]]")


class HostList:
    def __init__(self, hosts: List[HostSpec]):
        ips = [h.ip for h in hosts]
        if len(set(ips)) != len(ips):
            raise ValueError("duplicate host ip in host list")
        self.hosts: Tuple[HostSpec, ...] = tuple(hosts)

    @classmethod
    def parse(cls, spec: str) -> "HostList":
        """Parse ``ip:slots[,ip:slots]...``."""
        if not spec:
            return cls([])
        return cls([HostSpec.parse(h) for h in spec.split(",")])

    def __str__(self) -> str:
        return ",".join(str(h) for h in self.hosts)

    def __len__(self) -> int:
        return len(self.hosts)

    def cap(self) -> int:
        return sum(h.slots for h in self.hosts)

    def gen_runner_list(self, port: int = DEFAULT_RUNNER_PORT) -> PeerList:
        return PeerList(tuple(PeerID(h.ip, port) for h in self.hosts))

    def gen_peer_list(self, np: int, port_range: Tuple[int, int] = DEFAULT_PORT_RANGE) -> PeerList:
        """First ``np`` slots filled host-major; worker ``j`` on a host
        gets port ``port_range[0] + j`` (``hostspec.go:194-210``)."""
        if np > self.cap():
            raise ValueError(f"np={np} exceeds host list capacity {self.cap()}")
        lo, hi = port_range
        peers: List[PeerID] = []
        for h in self.hosts:
            for j in range(h.slots):
                if len(peers) >= np:
                    return PeerList(tuple(peers))
                port = lo + j
                if port >= hi:
                    raise ValueError(f"slot {j} on {h.ip} exceeds port range {port_range}")
                peers.append(PeerID(h.ip, port))
        return PeerList(tuple(peers))

    def lookup(self, ip: str) -> HostSpec:
        for h in self.hosts:
            if h.ip == ip:
                return h
        raise KeyError(ip)


def parse_host_list(spec: str) -> HostList:
    return HostList.parse(spec)
