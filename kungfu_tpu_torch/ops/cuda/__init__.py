"""Hand-written CUDA kernels for Hopper (``sm_90a``), built with nvcc at
first use from ``csrc/`` and bound with ctypes; each beside its plain
PyTorch version."""
