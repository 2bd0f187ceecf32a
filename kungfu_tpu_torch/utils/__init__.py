"""Trimmed host-side helpers (log, env knobs, trace aggregates, devices)."""
