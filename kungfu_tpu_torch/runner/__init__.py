"""The launcher (port of ``kungfu_tpu/runner/``, the reference's
``kfrun``):

* :mod:`~kungfu_tpu_torch.runner.proc` — worker processes, their colored
  output and log files, the fail-fast group wait;
* :mod:`~kungfu_tpu_torch.runner.job` — worker processes with the
  ``KF_*`` bootstrap env;
* :mod:`~kungfu_tpu_torch.runner.cli` — the flags and the dispatch to
  SimpleRun, WatchRun (:mod:`.watch`), MonitoredRun (:mod:`.monitored`)
  and PersistRun (:mod:`.supervise`);
* :mod:`~kungfu_tpu_torch.runner.mp` — ``launch_multiprocess``;
* :mod:`~kungfu_tpu_torch.runner.remote` — the SSH tools;
* :mod:`~kungfu_tpu_torch.runner.discovery` — ``-self auto``.

Launch as ``python -m kungfu_tpu_torch -np 4 python3 train.py``.
"""

from kungfu_tpu_torch.runner.job import Job
from kungfu_tpu_torch.runner.proc import Proc, run_all

__all__ = ["Proc", "run_all", "Job"]
