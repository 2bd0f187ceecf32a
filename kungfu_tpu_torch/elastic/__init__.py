"""Elasticity: changing the worker set without restarting the job
(trimmed port of ``kungfu_tpu/elastic/``).

* :mod:`~kungfu_tpu_torch.elastic.configserver` — the HTTP cluster-config
  store that announces a resize;
* :mod:`~kungfu_tpu_torch.elastic.resize` — ``fetch_cluster``, the
  worker's read of it;
* :mod:`~kungfu_tpu_torch.elastic.schedule` — ``step_based_schedule``;
* :mod:`~kungfu_tpu_torch.elastic.reshard` — ``ZeroBoundary``: the
  committed ZeRO state, re-carved for the new world size, leaderless.

The parameter replay point is
:class:`kungfu_tpu_torch.checkpoint.StepSnapshot`.  The elastic train
loop driver (``hooks.py``), shrink-to-survivors (``shrink.py``), slices
and the durable persist plane come with the peer and the host engine.
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
