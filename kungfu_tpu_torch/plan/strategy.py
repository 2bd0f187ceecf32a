"""Collective strategy names.

Copy of ``kungfu_tpu/plan/strategy.py``.

Parity with reference ``srcs/go/kungfu/base/strategy.go:10-22``: eight named
strategies plus AUTO (selection rule: :func:`auto_select` — single host →
RING, the JAX package's divergence from the Go reference; multi-host →
BINARY_TREE_STAR).  The host plane (:mod:`kungfu_tpu_torch.comm.engine`) keeps
the reference's graph semantics — a strategy generates (reduce, bcast)
routing graphs; on the device plane (:mod:`kungfu_tpu_torch.comm.device`) a
strategy instead selects among compiled collective schedules.  Names and
the env/flag surface are preserved either way.
"""

from __future__ import annotations

import enum


class Strategy(enum.Enum):
    STAR = "STAR"
    MULTI_STAR = "MULTI_STAR"
    RING = "RING"
    CLIQUE = "CLIQUE"
    TREE = "TREE"
    BINARY_TREE = "BINARY_TREE"
    BINARY_TREE_STAR = "BINARY_TREE_STAR"
    MULTI_BINARY_TREE_STAR = "MULTI_BINARY_TREE_STAR"
    AUTO = "AUTO"

    def __str__(self) -> str:
        return self.value


DEFAULT_STRATEGY = Strategy.BINARY_TREE_STAR


def parse_strategy(s: str) -> Strategy:
    try:
        return Strategy(s.strip().upper().replace("-", "_"))
    except ValueError:
        names = ", ".join(m.value for m in Strategy)
        raise ValueError(f"unknown strategy {s!r}; one of: {names}") from None


def auto_select(num_hosts: int) -> Strategy:
    """AUTO rule.  The reference picks STAR for one host and
    BINARY_TREE_STAR otherwise (``session/strategy.go:90-99``); this build
    diverges for the single-host case: colocated peers talk over unix
    sockets where RING pipelines chunked transfers ~20% faster than the
    root-bottlenecked STAR (the JAX package's loopback measurement at
    np∈{2,4}; the port keeps the rule and has not measured it)."""
    return Strategy.RING if num_hosts <= 1 else Strategy.BINARY_TREE_STAR
