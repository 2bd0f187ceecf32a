"""Models of the port: the flagship transformer (``transformer.py``) on
the functional layers of ``nn.py``."""
