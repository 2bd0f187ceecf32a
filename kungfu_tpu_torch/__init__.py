"""kungfu_tpu_torch: the PyTorch/CUDA port of kungfu_tpu, for NVIDIA Hopper.

The JAX package ``kungfu_tpu`` is the reference this port is held
against; this package imports nothing from it and never imports jax.
The layout mirrors the reference so a reader finds each counterpart:

* ``models/{nn,transformer}.py`` — the flagship transformer: forward,
  dropout and the next-token loss, differentiable in the parameters;
* ``ops/cuda/attention.py`` + ``ops/cuda/csrc/flash_{fwd,bwd}.cu`` — the
  hand-written flash-attention forward and backward kernels (``sm_90a``)
  and their plain PyTorch versions;
* ``ops/xent.py`` + ``ops/triton/xent.py`` — fused softmax cross-entropy:
  routing, and the Triton forward/backward kernels with their plain
  versions;
* ``parallel/{train,zero}.py``, ``optimizers/``, ``comm/device.py``,
  ``ops/{collective,schedules,fuse,monitor}.py``, ``monitor/pulse.py``,
  ``initializer.py`` — data-parallel S-SGD and ZeRO-1/2/3 over ``n``
  co-resident ranks whose values are stacked on a leading rank axis;
* ``ops/collectives.py`` + ``ops/cuda/csrc/ring.cu`` — the ring
  reduce-scatter and all-gather: routing, autograd pair, plain versions
  and the hand-written kernels that run every rank in one launch;
* ``serve/{kvcache,slo,engine}.py`` — the continuous-batching engine;
* ``plan/``, ``comm/{host,faults}.py``, ``elastic/``, ``checkpoint.py``
  — the host plane of elastic training: the cluster document, the
  Python host channel, the config server, the step-based schedule, the
  ``StepSnapshot`` replay point and ``ZeroBoundary``, which re-carves a
  ZeRO state for a new world size (with ``parallel/zero.py``'s
  ``zero1_reshard``, ``zero_snapshot``/``zero_restore`` and
  ``zero_reshard_p2p``);
* ``peer.py``, ``python/``, ``store/``, ``elastic/{shrink,hooks,slices,
  persist}.py``, ``monitor/{detector,signals}.py`` — the peer runtime
  (``kf.init()``, ``current_rank()``, ``cluster_size()``, ``resize()``,
  ``run_barrier()``) and in-flight failure recovery: a dead rank
  detected by a typed error, the survivors shrunk and replayed, and a
  cold restore from durable manifests;
* ``interop.py`` — weights across from / back to the JAX param tree;
* ``ops/costmodel.py``, ``monitor/``, ``utils/`` — trimmed copies of the
  reference's jax-free helpers.

Importing the package builds nothing and touches no GPU: CUDA kernels
build with ``nvcc`` at first use (``ops/cuda/_build.py``), Triton
kernels at first launch.
"""

from kungfu_tpu_torch.python import (  # noqa: F401
    cluster_size,
    current_communicator,
    current_local_rank,
    current_local_size,
    current_rank,
    detached,
    finalize,
    init,
    propose_new_size,
    resize,
    run_barrier,
    uid,
)


def launch_multiprocess(fn, np_, *args, **kwargs):
    """Single-machine multi-process launch (reference
    ``kungfu.cmd.launch_multiprocess``); see
    :func:`kungfu_tpu_torch.runner.mp.launch_multiprocess`."""
    from kungfu_tpu_torch.runner.mp import launch_multiprocess as _lm

    return _lm(fn, np_, *args, **kwargs)


def __getattr__(name):
    # the reference imports its ops subpackage here; the port's loads on
    # first use, as it imports torch and this package imports nothing
    # heavy (``python -m kungfu_tpu_torch.analysis`` starts without torch)
    if name == "ops":
        import importlib

        return importlib.import_module("kungfu_tpu_torch.ops")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
