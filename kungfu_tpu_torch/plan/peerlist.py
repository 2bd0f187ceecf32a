"""Ordered peer lists with rank, local rank and host partitioning (copy
of ``kungfu_tpu/plan/peerlist.py``; reference
``srcs/go/plan/peerlist.go:39-178``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from kungfu_tpu_torch.plan.peer import PeerID, parse_peer_id


@dataclass(frozen=True)
class PeerList:
    peers: Tuple[PeerID, ...]

    # -- construction ----------------------------------------------------
    @classmethod
    def of(cls, *peers: PeerID) -> "PeerList":
        return cls(tuple(peers))

    @classmethod
    def parse(cls, spec: str) -> "PeerList":
        """Parse ``host:port,host:port,...``."""
        if not spec:
            return cls(())
        return cls(tuple(parse_peer_id(p) for p in spec.split(",")))

    def __str__(self) -> str:
        return ",".join(str(p) for p in self.peers)

    # -- container protocol ----------------------------------------------
    def __len__(self) -> int:
        return len(self.peers)

    def __iter__(self) -> Iterator[PeerID]:
        return iter(self.peers)

    def __getitem__(self, i: int) -> PeerID:
        return self.peers[i]

    def __contains__(self, p: PeerID) -> bool:
        return p in self.peers

    # -- rank queries ----------------------------------------------------
    def rank(self, p: PeerID) -> Optional[int]:
        try:
            return self.peers.index(p)
        except ValueError:
            return None

    def local_rank(self, p: PeerID) -> Optional[int]:
        """Index among peers on the same host (ordered by global rank)."""
        r = 0
        for q in self.peers:
            if q == p:
                return r
            if q.host == p.host:
                r += 1
        return None

    def local_size(self, p: PeerID) -> int:
        return sum(1 for q in self.peers if q.host == p.host)

    def hosts(self) -> List[str]:
        """Distinct hosts in first-appearance order."""
        seen: List[str] = []
        for p in self.peers:
            if p.host not in seen:
                seen.append(p.host)
        return seen

    def partition_by_host(self) -> Dict[str, List[int]]:
        """host -> ordered global ranks on that host (reference
        ``peerlist.go:166`` PartitionByHost)."""
        out: Dict[str, List[int]] = {}
        for i, p in enumerate(self.peers):
            out.setdefault(p.host, []).append(i)
        return out

    def local_masters(self) -> List[int]:
        """Global rank of the first peer on each host."""
        seen: Dict[str, int] = {}
        for i, p in enumerate(self.peers):
            seen.setdefault(p.host, i)
        return [seen[h] for h in self.hosts()]

    # -- set ops (for elastic diffing) -----------------------------------
    def diff(self, other: "PeerList") -> Tuple[List[PeerID], List[PeerID]]:
        """Returns (added, removed) going from ``self`` to ``other``."""
        a, b = set(self.peers), set(other.peers)
        added = [p for p in other.peers if p not in a]
        removed = [p for p in self.peers if p not in b]
        return added, removed

    def on_host(self, host: str) -> "PeerList":
        return PeerList(tuple(p for p in self.peers if p.host == host))

    def select(self, ranks: Sequence[int]) -> "PeerList":
        return PeerList(tuple(self.peers[r] for r in ranks))
