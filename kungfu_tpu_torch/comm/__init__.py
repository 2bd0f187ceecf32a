"""Communicators: ``device.py`` (the device plane over co-resident
ranks), ``host.py`` (the host channels, Python and native),
``engine.py`` (the host collective engine over them) and ``faults.py``
(the typed failure vocabulary)."""
