"""The port's counterparts of the reference's examples (``examples/*.py``),
one module each under the reference's file name, each with the
reference's arguments and printed lines and a ``main(argv=None) -> int``
that tests and ``chip_smoke.py`` call in-process.

Under the launcher, one per dispatch, on synthetic MNIST:

* :mod:`.mnist_slp`: SimpleRun, the SLP under S-SGD;
* :mod:`.failure_recovery`: MonitoredRun (``-auto-recover``): a worker
  dies or stalls, the group is relaunched from the epoch checkpoint;
* :mod:`.elastic_mnist`: WatchRun (``-w``): the cluster resized on a
  step schedule;
* :mod:`.preempt_restore`: PersistRun (``-restore-from``): a whole-job
  preemption restored from the durable manifests;
* :mod:`.device_elastic`: WatchRun over a provisioned world (``-w
  -device-world``): one communicator across the active worker
  processes, re-carved on every resize, dropped workers standby.

Under the launcher, the host plane's headline paths:

* :mod:`.torch_simple`: the torch shim's ``SynchronousSGDOptimizer``;
* :mod:`.gns_elastic`: the gradient noise scale drives a grow through
  the config server (``-w``);
* :mod:`.cifar_elastic`: CIFAR-10, ``ElasticDataset``, checkpoints and a
  resize in one job (``-w``);
* :mod:`.gossip_train`: pair averaging, blocking or async, one
  ``KFGOSSIP`` line a worker;
* :mod:`.shrink_survivors`: a worker dies (``-tolerate-failures
  -chaos``), the survivors shrink and replay from memory;
* :mod:`.zero_shrink`: host ZeRO-2 through two staged deaths, the
  momentum re-carved from ring buddies;
* :mod:`.multislice_shrink`: a slice kill on an emulated 2-slice pod
  (``-num-slices 2``), buddies one slice away.

Run one as ``python -m kungfu_tpu_torch -backend cpu -np 2 python3
kungfu_tpu_torch/examples/torch_simple.py`` (``-backend gpu``, the
default, puts each worker on the card).

In this process, no launcher:

* :mod:`.long_context`: ring attention over ``--sp`` ranks;
* :mod:`.shard_train`: ``ShardedTrainer`` over dp x pp x sp x tp (+ MoE);
* :mod:`.strategy_tour`: the autotune, the strategy driver and ZeRO-1;
* :mod:`.serve_demo`: a router through a chaos worker kill, none lost;
* :mod:`.overlap_pipeline`: the host bucket pipeline against the serial
  loop under injected wire delay;
* :mod:`.pp_demo`: 1F1B against sequential, then a 2 -> 1 stage merge;
* :mod:`.adapt_interference`: the host bandit swaps off a throttled
  link.

Run one as ``python -m kungfu_tpu_torch.examples.long_context --sp 4
--cpu-devices 8``: the device examples' ranks share the card, or with
``--cpu-devices N`` are N CPU ranks; ``serve_demo`` puts its engines on
the card unless ``KF_JAX_PLATFORM=cpu``, and ``pp_demo`` runs on the host
as the reference's does.  The demos that the reference configures at
import (``KF_CHAOS_SPEC``, the engine's knobs) set them for ``main``'s
run only (:func:`._local.scoped_env`).
"""
