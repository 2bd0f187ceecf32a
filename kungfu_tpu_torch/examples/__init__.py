"""The port's counterparts of the reference's launch examples
(``examples/*.py``), one per dispatch of the launcher, each on synthetic
MNIST with the reference's arguments and printed lines:

* :mod:`.mnist_slp` — SimpleRun: the SLP under S-SGD;
* :mod:`.failure_recovery` — MonitoredRun (``-auto-recover``): a worker
  dies or stalls, the group is relaunched from the epoch checkpoint;
* :mod:`.elastic_mnist` — WatchRun (``-w``): the cluster resized on a
  step schedule;
* :mod:`.preempt_restore` — PersistRun (``-restore-from``): a whole-job
  preemption restored from the durable manifests;
* :mod:`.device_elastic` — WatchRun over a provisioned world
  (``-w -device-world``): one communicator across the active worker
  processes, re-carved on every resize, dropped workers standby.

Run each through the launcher, e.g.
``python -m kungfu_tpu_torch -backend cpu -np 2 python3 -m
kungfu_tpu_torch.examples.mnist_slp``.
"""
