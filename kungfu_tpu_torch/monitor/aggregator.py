"""The elastic layer's control post to the cluster aggregator, a trimmed
stand-in for ``kungfu_tpu/monitor/aggregator.py`` until ROADMAP A9 ports
the aggregator.
"""

from __future__ import annotations


def post_control_if_enabled(peer, kind: str, **attrs) -> bool:
    """Does nothing and returns False, as the reference's does with
    ``KF_CONFIG_ENABLE_CLUSTER_MONITOR`` unset; a peer started with that
    knob raises ``NotImplementedError`` (``peer.py``), so no post is
    lost silently.  Kept so that the shrink and propose paths call it
    where the reference does."""
    del peer, kind, attrs
    return False
