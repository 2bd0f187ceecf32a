"""kungfu_tpu_torch: the PyTorch/CUDA port of kungfu_tpu, for NVIDIA Hopper.

The JAX package ``kungfu_tpu`` is the reference this port is held
against; this package imports nothing from it and never imports jax.
The layout mirrors the reference so a reader finds each counterpart:

* ``models/{nn,transformer}.py`` — the flagship transformer forward;
* ``ops/cuda/attention.py`` + ``ops/cuda/csrc/flash_fwd.cu`` — the
  hand-written flash-attention forward kernel (``sm_90a``) and its plain
  PyTorch version;
* ``serve/{kvcache,slo,engine}.py`` — the continuous-batching engine;
* ``interop.py`` — weights across from / back to the JAX param tree;
* ``ops/costmodel.py``, ``monitor/``, ``utils/`` — trimmed copies of the
  reference's jax-free helpers.

Importing the package builds nothing and touches no GPU: kernels build
with ``nvcc`` at first use (``ops/cuda/_build.py``).
"""
