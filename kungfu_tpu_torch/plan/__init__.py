"""Topology and plan layer (copy of ``kungfu_tpu/plan/``): peer identity,
ordered peer lists, host specs, the cluster document with its validated
resize, and the communication graphs and strategies the host collective
engine (:mod:`kungfu_tpu_torch.comm.engine`) walks.  Exports what
``kungfu_tpu/plan/__init__.py`` exports."""

from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.graph import Graph, Node
from kungfu_tpu_torch.plan.hostspec import (DEFAULT_PORT_RANGE,
                                            DEFAULT_RUNNER_PORT, HostList,
                                            HostSpec, parse_host_list)
from kungfu_tpu_torch.plan.peer import PeerID, parse_peer_id
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.plan.strategy import (Strategy, auto_select,
                                            parse_strategy)
from kungfu_tpu_torch.plan.topology import (gen_binary_tree,
                                            gen_binary_tree_star,
                                            gen_circular_graph_pair,
                                            gen_default_reduce_graph,
                                            gen_multi_binary_tree_star,
                                            gen_multi_star, gen_star,
                                            gen_tree)

__all__ = [
    "Graph",
    "Node",
    "PeerID",
    "parse_peer_id",
    "PeerList",
    "HostSpec",
    "HostList",
    "parse_host_list",
    "Cluster",
    "Strategy",
    "parse_strategy",
    "auto_select",
    "gen_star",
    "gen_tree",
    "gen_binary_tree",
    "gen_binary_tree_star",
    "gen_multi_binary_tree_star",
    "gen_multi_star",
    "gen_circular_graph_pair",
    "gen_default_reduce_graph",
    "DEFAULT_RUNNER_PORT",
    "DEFAULT_PORT_RANGE",
]
