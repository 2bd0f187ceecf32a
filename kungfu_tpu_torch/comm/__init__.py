"""Communicators (``device.py``: the world-1 device plane)."""
