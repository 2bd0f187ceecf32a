"""Communicators: ``device.py`` (the device plane over co-resident
ranks), ``host.py`` (the Python host channel) and ``faults.py`` (the
typed failure vocabulary)."""
