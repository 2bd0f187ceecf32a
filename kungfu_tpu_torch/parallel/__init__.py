"""Training steps (``train.py``: the data-parallel step at world size 1)."""
