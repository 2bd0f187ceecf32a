"""Policy-layer reads of the kf-sentinel judging plane (port of
``kungfu_tpu/policy/sentinel.py``).

:func:`sentinel_signals` is one read-only, schema-checked extraction over
the ``/cluster`` view or the ``/alerts`` payload, the way
:func:`~kungfu_tpu_torch.policy.serve.serve_signals` reads the serving
section.  Nothing here acts on the cluster.
"""

from __future__ import annotations

from typing import Optional

from kungfu_tpu_torch.monitor.aggregator import field


def sentinel_signals(view: dict) -> Optional[dict]:
    """The sentinel alert state out of a ``/cluster`` view (or an
    ``/alerts`` payload — both carry the same section shape).
    ``None`` when no sentinel is attached, so a policy can distinguish
    "plane off" from "no alerts"."""
    # a /cluster view NESTS the section under "alerts"; an /alerts
    # payload IS the section — but itself carries an "alerts" key (the
    # fired-alert LIST), so the nesting test must check the shape, not
    # just the key
    nested = field(view, "alerts")
    al = nested if isinstance(nested, dict) and "active" in nested else view
    if not al or not isinstance(al, dict) or "active" not in al:
        return None
    active = list(field(al, "active") or [])
    fired = field(al, "alerts") or []
    verdicts = field(al, "verdicts") or {}
    return {
        "active": active,
        "firing": bool(active),
        # the coarse shapes a policy steers by: is the cluster
        # regressing (changepoints), burning SLO budget, or tripping a
        # watermark — without re-parsing rule evidence
        "regressing": sorted(r.split(":", 1)[1] for r in active
                             if r.startswith("regress:")),
        "burning": sorted(r.split(":", 1)[1] for r in active
                          if r.startswith("sloburn:")),
        "watermarks": sorted(r.split(":", 1)[1] for r in active
                             if r.startswith("watermark:")),
        "fired_total": len(fired),
        "verdicts": verdicts,
        # the kf-ledger rollup: how many decisions the adaptive actors
        # made and how their measured effects judged (None on builds
        # whose sentinel predates the ledger)
        "decisions": field(al, "decisions"),
    }
