"""The decision ledger's actor hook, a trimmed stand-in for
``kungfu_tpu/monitor/ledger.py`` until ROADMAP A9b ports the ledger.
"""

from __future__ import annotations

from typing import Optional


def record_decision(actor: str, knob: str, old, new,
                    **kwargs) -> Optional[dict]:
    """Does nothing and returns None: the reference's hook returns None
    whenever its ledger plane is off, and the port has no ledger plane
    yet (ROADMAP A9b).  Kept so that the shrink path calls it where the
    reference does."""
    del actor, knob, old, new, kwargs
    return None
