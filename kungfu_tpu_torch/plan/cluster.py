"""Cluster = runners + workers, with validation and resize (copy of
``kungfu_tpu/plan/cluster.py``; reference ``srcs/go/plan/cluster.go``).

A JSON document validated on every update, and the resize rule: a shrink
drops the tail of the worker list, a grow appends workers onto the
least-loaded runner hosts (``cluster.go:75-106`` growOne).  ``to_json``
and :meth:`Cluster.digest` are byte for byte the reference's, so a port
worker and a reference worker agree on a membership.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Optional

from kungfu_tpu_torch.plan.hostspec import DEFAULT_PORT_RANGE, DEFAULT_RUNNER_PORT
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.plan.peerlist import PeerList


@dataclass(frozen=True)
class Cluster:
    runners: PeerList
    workers: PeerList

    # -- codec -----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "runners": [str(p) for p in self.runners],
                "workers": [str(p) for p in self.workers],
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "Cluster":
        d = json.loads(s)
        c = cls(
            runners=PeerList.parse(",".join(d.get("runners", []))),
            workers=PeerList.parse(",".join(d.get("workers", []))),
        )
        c.validate()
        return c

    def digest(self) -> bytes:
        """Canonical bytes for the membership consensus."""
        return hashlib.blake2b(self.to_json().encode(), digest_size=16).digest()

    # -- validation ------------------------------------------------------
    def validate(self) -> None:
        runner_hosts = {r.host for r in self.runners}
        for w in self.workers:
            if w.host not in runner_hosts:
                raise ValueError(f"worker {w} has no runner on its host")
        if len(set(self.workers.peers)) != len(self.workers):
            raise ValueError("duplicate workers")

    def size(self) -> int:
        return len(self.workers)

    # -- resize ----------------------------------------------------------
    def resize(self, new_size: int, port_range=DEFAULT_PORT_RANGE) -> "Cluster":
        if new_size < 0:
            raise ValueError("negative cluster size")
        workers = list(self.workers.peers)
        if new_size <= len(workers):
            return Cluster(self.runners, PeerList(tuple(workers[:new_size])))
        while len(workers) < new_size:
            nxt = self._grow_one(workers, port_range)
            if nxt is None:
                raise ValueError(
                    f"cannot grow to {new_size}: all {len(self.runners)} hosts full"
                )
            workers.append(nxt)
        return Cluster(self.runners, PeerList(tuple(workers)))

    def _grow_one(self, workers, port_range) -> Optional[PeerID]:
        """One more worker on the least-loaded runner host with a free
        port (ports are allocated densely from the range start)."""
        lo, hi = port_range
        load = {r.host: 0 for r in self.runners}
        used = {}
        for w in workers:
            load[w.host] = load.get(w.host, 0) + 1
            used.setdefault(w.host, set()).add(w.port)
        for host in sorted(load, key=lambda h: load[h]):
            for port in range(lo, hi):
                if port not in used.get(host, set()):
                    return PeerID(host, port)
        return None

    @classmethod
    def single_process(cls, host: str = "127.0.0.1") -> "Cluster":
        w = PeerList.of(PeerID(host, DEFAULT_PORT_RANGE[0]))
        r = PeerList.of(PeerID(host, DEFAULT_RUNNER_PORT))
        return cls(r, w)
