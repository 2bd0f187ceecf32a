"""Metrics registry and flight-recorder timeline (trimmed copies)."""
