"""Kernels written in Triton (``triton`` is imported at first launch,
never at import)."""
