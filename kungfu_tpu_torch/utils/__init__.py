"""Trimmed host-side helpers (log, env knobs, trace aggregates, devices).
The package exports the reference's ``get_logger``, ``log_event`` and
``stall_detector``."""

_LAZY = {
    "get_logger": "kungfu_tpu_torch.utils.log",
    "log_event": "kungfu_tpu_torch.utils.log",
    "stall_detector": "kungfu_tpu_torch.utils.stall",
}

__all__ = list(_LAZY)


def __getattr__(name):
    # each name of _LAZY loads its module on first use, so no import
    # cycle can close through this package
    src = _LAZY.get(name)
    if src is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(src), name)
    globals()[name] = value
    return value
