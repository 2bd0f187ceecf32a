"""Elasticity: changing the worker set without restarting the job
(trimmed port of ``kungfu_tpu/elastic/``).

* :mod:`~kungfu_tpu_torch.elastic.configserver` — the HTTP cluster-config
  store that announces a resize;
* :mod:`~kungfu_tpu_torch.elastic.resize` — ``fetch_cluster``, the
  worker's read of it;
* :mod:`~kungfu_tpu_torch.elastic.schedule` — ``step_based_schedule``;
* :mod:`~kungfu_tpu_torch.elastic.reshard` — ``ZeroBoundary``: the
  committed ZeRO state, re-carved for the new world size, leaderless.

* :mod:`~kungfu_tpu_torch.elastic.resize` also holds
  ``fetch_cluster_with_consensus``, the peers' agreement on it;
* :mod:`~kungfu_tpu_torch.elastic.hooks` — ``elastic_step``, the train
  loop's per-step driver;
* :mod:`~kungfu_tpu_torch.elastic.shrink` — in-flight failure recovery:
  the dead set confirmed by ping, the survivors' exclusion consensus,
  the shrink, the agreed replay point and the ZeRO re-carve;
* :mod:`~kungfu_tpu_torch.elastic.slices` — the rank-to-slice mapping
  that makes failures slice-granular on a multislice job;
* :mod:`~kungfu_tpu_torch.elastic.persist` — durable manifests and the
  cold restore onto any world size.

The parameter replay point is
:class:`kungfu_tpu_torch.checkpoint.StepSnapshot`.
"""

from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.elastic.reshard import (ZeroBoundary, place_stacked,
                                              recarve_after_shrink)
from kungfu_tpu_torch.elastic.resize import fetch_cluster
from kungfu_tpu_torch.elastic.schedule import (parse_schedule,
                                               step_based_schedule,
                                               total_steps)

__all__ = ["ConfigServer", "fetch_cluster", "parse_schedule",
           "step_based_schedule", "total_steps", "ZeroBoundary",
           "place_stacked", "recarve_after_shrink"]
