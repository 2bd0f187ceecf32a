"""Cost model and the hand-written CUDA kernels (``ops/cuda``)."""
