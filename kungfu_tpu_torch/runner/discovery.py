"""Self-IP inference for multi-host launches (port of
``kungfu_tpu/runner/discovery.py``).

Parity with the reference's NIC-based discovery
(``srcs/go/kungfu/runner/discovery.go``): a runner started with the same
command line on every host must figure out WHICH entry of the host list
it is.  The reference enumerates NICs and matches their addresses
against the host list; portable Python cannot enumerate NICs without
third-party deps, so the same question is answered with a BIND probe
per candidate: binding an ephemeral UDP socket to ``ip:0`` succeeds
exactly when ``ip`` is assigned to this machine (a routing probe would
under-detect — the kernel's source selection answers alias/secondary
addresses with the primary one).
"""

from __future__ import annotations

import socket
from typing import List

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("discovery")


def _is_local_addr(ip: str, family: int = socket.AF_INET) -> bool:
    """True when ``ip`` is assigned to this machine.

    Known limit: with ``net.ipv4.ip_nonlocal_bind=1`` (keepalived/HA
    boxes) EVERY address binds, so all candidates match and the
    ambiguity error tells the operator to pass ``-self`` explicitly —
    wrong-slot guessing is never silent."""
    try:
        with socket.socket(family, socket.SOCK_DGRAM) as s:
            s.bind((ip, 0))
            return True
    except OSError:
        return False


def infer_self_ip(hosts: List[str]) -> str:
    """The entry of ``hosts`` naming THIS machine.

    A candidate is ours when this machine can bind it (loopback and
    alias addresses included — this is exactly how the compose-style
    alias hosts resolve too).  Exactly one match is required: zero means
    the host list does not name this machine, several means the list
    contains multiple local addresses and the runner cannot know which
    slot it fills.
    """
    matches = []
    for h in hosts:
        try:
            family, *_, addr = socket.getaddrinfo(
                h, None, proto=socket.IPPROTO_UDP)[0]
            ip = addr[0]
        except OSError:
            _log.warning("cannot resolve host %r; skipping", h)
            continue
        if _is_local_addr(ip, family):
            matches.append(h)
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise RuntimeError(
            f"-self auto: none of {hosts} is an address of this machine"
        )
    raise RuntimeError(
        f"-self auto: {matches} all resolve to this machine — pass -self "
        "explicitly to pick the slot"
    )
