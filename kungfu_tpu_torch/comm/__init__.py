"""Communicators: ``device.py`` (the device plane over co-resident
ranks), ``host.py`` (the host channels, Python and native),
``engine.py`` (the host collective engine over them) and ``faults.py``
(the typed failure vocabulary).  The package exports the reference's
``Communicator``, ``HostChannel`` and ``ConnType``."""

_LAZY = {
    "Communicator": "kungfu_tpu_torch.comm.device",
    "HostChannel": "kungfu_tpu_torch.comm.host",
    "ConnType": "kungfu_tpu_torch.comm.host",
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
