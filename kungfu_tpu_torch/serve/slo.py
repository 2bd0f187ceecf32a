"""Serving SLO surfaces: latency histograms, load gauges, targets.

Port of ``kungfu_tpu/serve/slo.py`` under the same metric names:
``kf_serve_ttft_seconds`` (admission to first token, at the worker),
``kf_serve_token_seconds`` (decode-step wall time, at the worker),
``kf_serve_e2e_seconds`` (submit to completion, at the router), the
queue-depth and active-slots gauges and the prefill-token counter split
into computed and reused.  Request accounting rides the timeline's
counted ``request`` kind (``kf_serve_requests_total{what=...}``).
:class:`SLORules` holds the burn-rate budgets that
:class:`~kungfu_tpu_torch.monitor.sentinel.Sentinel` evaluates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils import envs

TTFT_HIST = "kf_serve_ttft_seconds"
TOKEN_HIST = "kf_serve_token_seconds"
E2E_HIST = "kf_serve_e2e_seconds"
QUEUE_GAUGE = "kf_serve_queue_depth"
ACTIVE_GAUGE = "kf_serve_active_requests"
REQUESTS_COUNTER = "kf_serve_requests_total"
PREFILL_COUNTER = "kf_serve_prefill_tokens_total"

DEFAULT_TTFT_MS = 500.0
DEFAULT_E2E_MS = 5000.0


def observe_ttft(seconds: float) -> None:
    REGISTRY.histogram(TTFT_HIST).observe(seconds)


def observe_token(seconds: float) -> None:
    REGISTRY.histogram(TOKEN_HIST).observe(seconds)


def observe_e2e(seconds: float) -> None:
    REGISTRY.histogram(E2E_HIST).observe(seconds)


def note_queue_depth(n: int) -> None:
    REGISTRY.gauge(QUEUE_GAUGE).set(n)


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


@dataclass(frozen=True)
class SLORules:
    """Burn-rate rules for the sentinel: budgets in milliseconds (it
    judges the aggregator's ``ttft_ms``/``e2e_ms`` rollups), and a
    two-window test that alerts only when both the short and the long
    window exceed their violation fractions."""

    ttft_budget_ms: float = DEFAULT_TTFT_MS
    e2e_budget_ms: float = DEFAULT_E2E_MS
    short_window: int = 6
    long_window: int = 24
    short_frac: float = 0.5
    long_frac: float = 0.25

    @classmethod
    def from_env(cls) -> "SLORules":
        return cls(
            ttft_budget_ms=envs.parse_float_env(envs.SERVE_SLO_TTFT_MS,
                                                DEFAULT_TTFT_MS),
            e2e_budget_ms=envs.parse_float_env(envs.SERVE_SLO_E2E_MS,
                                               DEFAULT_E2E_MS),
            short_window=envs.parse_int_env(envs.SENTINEL_SLO_SHORT, 6),
            long_window=envs.parse_int_env(envs.SENTINEL_SLO_LONG, 24),
        )

    def budgets(self) -> Dict[str, float]:
        """Rollup-series name -> ms budget."""
        return {"ttft_ms": self.ttft_budget_ms, "e2e_ms": self.e2e_budget_ms}


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
