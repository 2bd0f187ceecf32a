"""Training steps: ``train.py`` (the data-parallel step) and
``zero.py`` (ZeRO stages 1-3 and the re-carve of their state)."""
