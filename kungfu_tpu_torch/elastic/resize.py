"""Worker-side resize protocol (trimmed copy of
``kungfu_tpu/elastic/resize.py``): :func:`fetch_cluster` reads the
versioned cluster document from the config server.  The consensus loop
over it (``fetch_cluster_with_consensus``, reference
``peer/peer.go:236-276``) needs the peer's ``consensus_bytes`` and comes
with the port of ``peer.py``."""

from __future__ import annotations

import json
import urllib.request
from typing import Tuple

from kungfu_tpu_torch.plan.cluster import Cluster

#: seconds one GET may take
FETCH_TIMEOUT_S = 10


def fetch_cluster(url: str) -> Tuple[Cluster, int]:
    """``(cluster, version)`` from the config server's ``GET /get`` at
    ``url``; the cluster is validated."""
    with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as resp:
        doc = json.loads(resp.read().decode())
    cluster = Cluster.from_json(json.dumps(doc["cluster"]))
    return cluster, int(doc["version"])
