"""Worker-side resize protocol: fetch and consensus (port of
``kungfu_tpu/elastic/resize.py``).

:func:`fetch_cluster_with_consensus` loops: GET the cluster document
from the config server, run a bytes consensus over its digest among the
current workers until every peer saw the same one, and hand the agreed
``(cluster, version)`` to ``Peer._propose`` (reference
``peer/peer.go:236-276``).  Fetch failures back off exponentially
(jittered, capped), so every worker retrying at once does not hit a
recovering config server in lockstep; the consensus retry keeps a short
jittered delay.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Tuple

from kungfu_tpu_torch.chaos import controller_for as _chaos_controller_for
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.retry import jittered, sleep_backoff

_log = get_logger("resize")

#: seconds one GET may take
FETCH_TIMEOUT_S = 10
FETCH_RETRY_PERIOD_S = 0.2
FETCH_RETRY_CAP_S = 2.0
DEFAULT_TIMEOUT_S = 120.0


def slice_aligned_size(peer, new_size: int) -> int:
    """A proposed worker count clamped to whole slices on a multislice
    job (``Peer.propose_new_size`` calls this before its PUT); a
    single-slice job's passes through."""
    topo = peer.slice_topology()
    if topo is None:
        return new_size
    from kungfu_tpu_torch.elastic.slices import align_to_slices

    aligned = align_to_slices(new_size, topo)
    if aligned != new_size:
        _log.warning("proposed size %d is not whole slices (%d ranks/slice)"
                     " — aligning to %d", new_size, topo.ranks_per_slice,
                     aligned)
    return aligned


def fetch_cluster(url: str, chaos=None) -> Tuple[Cluster, int]:
    """``(cluster, version)`` from the config server's ``GET /get`` at
    ``url``; the cluster is validated.  ``chaos`` (a controller) can
    make the fetch fail inside a ``config_down`` window."""
    if chaos is not None and chaos.config_unavailable():
        raise urllib.error.URLError("chaos: config-server unavailability "
                                    "window")
    with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as resp:
        doc = json.loads(resp.read().decode())
    cluster = Cluster.from_json(json.dumps(doc["cluster"]))
    return cluster, int(doc["version"])


def fetch_cluster_with_consensus(peer, timeout: float = DEFAULT_TIMEOUT_S
                                 ) -> Tuple[Cluster, int]:
    """Every current worker converges on one ``(cluster, version)``."""
    url = peer.config.config_server
    # the stable bootstrap identity: a shrink renumbers ranks, and a
    # rank-scoped config_down clause must not re-fire on a survivor
    chaos = _chaos_controller_for(peer.chaos_rank())
    deadline = time.time() + timeout
    attempt = 0
    failures = 0
    while True:
        if time.time() > deadline:
            raise TimeoutError(
                f"no consensus on cluster config after {timeout}s")
        try:
            cluster, version = fetch_cluster(url, chaos)
        except (urllib.error.URLError, OSError, KeyError, ValueError) as e:
            _log.debug("config fetch failed: %s", e)
            sleep_backoff(failures, base=FETCH_RETRY_PERIOD_S,
                          cap=FETCH_RETRY_CAP_S)
            failures += 1
            continue
        failures = 0
        payload = cluster.digest() + version.to_bytes(8, "little")
        # the round index names the rendezvous, so it advances alike on
        # every peer; only the sleep between rounds is jittered
        if peer.consensus_bytes(payload, name=f"resize.{attempt}"):
            return cluster, version
        attempt += 1
        time.sleep(jittered(FETCH_RETRY_PERIOD_S))
