"""Serving SLO surfaces: latency histograms, load gauges, targets.

Port of ``kungfu_tpu/serve/slo.py`` under the same metric names:
``kf_serve_ttft_seconds`` (admission to first token), ``kf_serve_token_
seconds`` (decode-step wall time), the active-slots gauge and the
prefill-token counter split into computed and reused.  The router-side
metrics (``kf_serve_e2e_seconds`` is observed there, the queue gauge)
come with the router, the sentinel's burn-rate rules (``SLORules``)
with the monitoring slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils import envs

TTFT_HIST = "kf_serve_ttft_seconds"
TOKEN_HIST = "kf_serve_token_seconds"
E2E_HIST = "kf_serve_e2e_seconds"
ACTIVE_GAUGE = "kf_serve_active_requests"
PREFILL_COUNTER = "kf_serve_prefill_tokens_total"

DEFAULT_TTFT_MS = 500.0
DEFAULT_E2E_MS = 5000.0


def observe_ttft(seconds: float) -> None:
    REGISTRY.histogram(TTFT_HIST).observe(seconds)


def observe_token(seconds: float) -> None:
    REGISTRY.histogram(TOKEN_HIST).observe(seconds)


def note_active(n: int) -> None:
    REGISTRY.gauge(ACTIVE_GAUGE).set(n)


def count_prefill(computed: int = 0, reused: int = 0) -> None:
    """``computed`` tokens ran the forward, ``reused`` came out of the
    paged cache's prefix chain."""
    if computed:
        REGISTRY.counter(PREFILL_COUNTER, what="computed").inc(computed)
    if reused:
        REGISTRY.counter(PREFILL_COUNTER, what="reused").inc(reused)


@dataclass(frozen=True)
class SLOTargets:
    """Latency objectives (``KF_SERVE_SLO_TTFT_MS`` / ``_E2E_MS``)."""

    ttft_s: float = DEFAULT_TTFT_MS / 1e3
    e2e_s: float = DEFAULT_E2E_MS / 1e3

    @classmethod
    def from_env(cls) -> "SLOTargets":
        return cls(
            ttft_s=envs.parse_float_env(envs.SERVE_SLO_TTFT_MS,
                                        DEFAULT_TTFT_MS) / 1e3,
            e2e_s=envs.parse_float_env(envs.SERVE_SLO_E2E_MS,
                                       DEFAULT_E2E_MS) / 1e3,
        )


def slo_snapshot() -> Dict[str, Dict[str, float]]:
    return {
        "ttft": REGISTRY.histogram(TTFT_HIST).summary(),
        "token": REGISTRY.histogram(TOKEN_HIST).summary(),
        "e2e": REGISTRY.histogram(E2E_HIST).summary(),
    }


def slo_verdict(targets: Optional[SLOTargets] = None,
                snapshot: Optional[Dict[str, Dict[str, float]]] = None
                ) -> Dict[str, bool]:
    """p99-vs-target booleans (empty histograms pass)."""
    targets = targets or SLOTargets.from_env()
    snap = snapshot if snapshot is not None else slo_snapshot()

    def ok(name: str, budget: float) -> bool:
        s = snap.get(name) or {}
        return s.get("count", 0) == 0 or s.get("p99", 0.0) <= budget

    return {"ttft_ok": ok("ttft", targets.ttft_s),
            "e2e_ok": ok("e2e", targets.e2e_s)}
