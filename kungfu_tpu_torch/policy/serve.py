"""Serving control policies: the batch-width controller and the
autoscaler (port of ``kungfu_tpu/policy/serve.py``).

Both read the aggregator's ``/cluster`` view through
:func:`serve_signals` and steer against the
:class:`~kungfu_tpu_torch.serve.slo.SLOTargets`:

* :class:`BatchWidthController` moves a local knob, the engine's
  admitted decode width (:meth:`~kungfu_tpu_torch.serve.engine.
  InferenceEngine.set_width`): it widens while there is queue pressure
  and the e2e window is inside budget, and narrows when the SLO is
  blown.  Replicas may run different widths, so no consensus is needed.
* :class:`ServeAutoscalePolicy` raises worker-count intents on the
  standard :class:`~kungfu_tpu_torch.policy.base.PolicyContext`: queue
  pressure with the SLO blown asks for one more worker, a drained queue
  with a wide margin releases one.  A cooldown keeps it from flapping.

Their decisions go to :func:`kungfu_tpu_torch.monitor.ledger.
record_decision`, which records them when ``KF_SENTINEL_DIR`` is set.
"""

from __future__ import annotations

from typing import Callable, Optional

from kungfu_tpu_torch.monitor.aggregator import field
from kungfu_tpu_torch.policy.base import BasePolicy, PolicyContext
from kungfu_tpu_torch.serve.slo import SLOTargets
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("serve-policy")


def serve_signals(view: dict) -> Optional[dict]:
    """The serving rollup out of a ``/cluster`` view (schema-checked
    field reads; ``None`` when the deployment serves nothing)."""
    srv = field(view, "serving")
    if not srv:
        return None
    return {
        "active": field(srv, "active") or 0,
        "queued": field(srv, "queued") or 0,
        "completed": field(srv, "completed") or 0,
        "replayed": field(srv, "replayed") or 0,
        "ttft_ms": field(srv, "ttft_ms"),
        "e2e_ms": field(srv, "e2e_ms"),
    }


class BatchWidthController:
    """Hysteresis controller over one engine's admitted decode width.

    ``apply_fn(width) -> int`` installs the width and returns the
    effective value (:meth:`InferenceEngine.set_width` has exactly this
    shape).  Driven by :meth:`observe` with the queue depth and the
    window-mean e2e latency (ms) — either from local registry numbers
    or from :func:`serve_signals` on the aggregator view."""

    def __init__(self, apply_fn: Callable[[int], int], *,
                 lo: int = 1, hi: int = 8,
                 start: Optional[int] = None,
                 targets: Optional[SLOTargets] = None,
                 widen_at_queue: int = 2,
                 cooldown_steps: int = 3):
        self._apply = apply_fn
        self.lo = int(lo)
        self.hi = int(hi)
        self.targets = targets or SLOTargets.from_env()
        self.widen_at_queue = int(widen_at_queue)
        self.cooldown_steps = int(cooldown_steps)
        self._cool = 0
        self.width = self._apply(int(start if start is not None else hi))

    def observe(self, queued: int, e2e_ms: Optional[float]) -> int:
        """One control tick; returns the (possibly new) width."""
        if self._cool > 0:
            self._cool -= 1
            return self.width
        budget_ms = self.targets.e2e_s * 1e3
        over = e2e_ms is not None and e2e_ms > budget_ms
        if over and self.width > self.lo:
            # blowing the SLO: shed decode width — fewer slots per step
            # shortens every active request's per-token latency
            prev, self.width = self.width, self._apply(self.width - 1)
            self._cool = self.cooldown_steps
            self._record(prev, queued, e2e_ms)
            _log.info("batch width -> %d (e2e %.0fms > %.0fms budget)",
                      self.width, e2e_ms, budget_ms)
        elif (not over and queued >= self.widen_at_queue
              and self.width < self.hi):
            prev, self.width = self.width, self._apply(self.width + 1)
            self._cool = self.cooldown_steps
            self._record(prev, queued, e2e_ms)
            _log.info("batch width -> %d (queue %d)", self.width, queued)
        return self.width

    def _record(self, prev: int, queued: int,
                e2e_ms: Optional[float]) -> None:
        from kungfu_tpu_torch.monitor import ledger

        # kf-ledger: width moves answer to serving latency, not step
        # time — the effect series is the e2e window mean
        ledger.record_decision(
            "batch-width", "width", prev, self.width,
            evidence={"queued": int(queued), "e2e_ms": e2e_ms},
            effect_series="e2e_ms")

    def observe_view(self, view: dict) -> int:
        sig = serve_signals(view)
        if sig is None:
            return self.width
        return self.observe(sig["queued"], sig["e2e_ms"])


class ServeAutoscalePolicy(BasePolicy):
    """Worker-count intents from the serving rollup.

    Feed it per-step metrics (``runner.after_step(serve_queued=...,
    serve_e2e_ms=...)``) or call :meth:`observe_view` with the
    aggregator view before the runner tick.  Scale-up: queue pressure
    AND the e2e window over budget.  Scale-down: idle queue, nothing
    active, and a wide latency margin.  ``min_workers`` floors the
    release path — the router's fault ladder, not the autoscaler, is
    who removes the last capacity."""

    def __init__(self, *, targets: Optional[SLOTargets] = None,
                 scale_up_queue: int = 4,
                 min_workers: int = 1,
                 max_workers: int = 64,
                 cooldown_steps: int = 10):
        self.targets = targets or SLOTargets.from_env()
        self.scale_up_queue = int(scale_up_queue)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.cooldown_steps = int(cooldown_steps)
        self._cool = 0
        self._view_sig: Optional[dict] = None

    def observe_view(self, view: dict) -> None:
        self._view_sig = serve_signals(view)

    def after_step(self, ctx: PolicyContext) -> None:
        sig = self._view_sig or {
            "queued": ctx.metrics.get("serve_queued", 0),
            "active": ctx.metrics.get("serve_active", 0),
            "e2e_ms": ctx.metrics.get("serve_e2e_ms"),
        }
        self._view_sig = None
        if self._cool > 0:
            self._cool -= 1
            return
        budget_ms = self.targets.e2e_s * 1e3
        e2e = sig.get("e2e_ms")
        queued = sig.get("queued") or 0
        active = sig.get("active") or 0
        over = e2e is not None and e2e > budget_ms
        if (queued >= self.scale_up_queue and over
                and ctx.cluster_size < self.max_workers):
            _log.info("autoscale: +1 worker (queue %d, e2e %.0fms)",
                      queued, e2e)
            self._record(ctx.cluster_size, ctx.cluster_size + 1,
                         queued, e2e)
            ctx.request_resize(ctx.cluster_size + 1)
            self._cool = self.cooldown_steps
        elif (queued == 0 and active == 0 and not over
              and ctx.cluster_size > self.min_workers
              and (e2e is None or e2e < 0.25 * budget_ms)):
            _log.info("autoscale: -1 worker (idle)")
            self._record(ctx.cluster_size, ctx.cluster_size - 1,
                         queued, e2e)
            ctx.request_resize(ctx.cluster_size - 1)
            self._cool = self.cooldown_steps

    @staticmethod
    def _record(prev: int, new: int, queued: int, e2e) -> None:
        from kungfu_tpu_torch.monitor import ledger

        ledger.record_decision(
            "serve-autoscale", "workers", prev, new,
            evidence={"queued": int(queued), "e2e_ms": e2e},
            effect_series="e2e_ms")
