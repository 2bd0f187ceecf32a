"""Cluster membership as data (trimmed copy of ``kungfu_tpu/plan/``):
peer identity, ordered peer lists, host specs, and the cluster document
with its validated resize.  The communication graphs, strategies and
topologies of the reference's ``plan/`` come with the host collective
engine."""

from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.hostspec import (DEFAULT_PORT_RANGE,
                                            DEFAULT_RUNNER_PORT, HostList,
                                            HostSpec, parse_host_list)
from kungfu_tpu_torch.plan.peer import PeerID, parse_peer_id
from kungfu_tpu_torch.plan.peerlist import PeerList

__all__ = ["PeerID", "parse_peer_id", "PeerList", "HostSpec", "HostList",
           "parse_host_list", "Cluster", "DEFAULT_RUNNER_PORT",
           "DEFAULT_PORT_RANGE"]
