"""kf-pulse: gradient noise scale and variance, sampled every N steps.

Trimmed copy of ``kungfu_tpu/monitor/pulse.py`` (stdlib only): the
two-batch noise-scale estimator :func:`noise_scale`, the variance
:func:`grad_variance`, and :class:`PulseMonitor` (period gate, EMA,
gauges).  ``dp_train_step`` asks :meth:`PulseMonitor.should_sample`
every step and, on a sample step, hands over the square-norm pair; the
monitor publishes ``kf_gns`` (never at world size 1, where the estimator
is undefined), ``kf_grad_variance`` and ``kf_grad_norm{group=...}`` into
the port's registry.  ``KF_PULSE_EVERY=0`` disables it.
"""

from __future__ import annotations

from typing import Dict, Optional

from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils import envs

#: sample every N steps; 0 disables the plane entirely
DEFAULT_EVERY = 10
#: EMA weight for the published estimates
DEFAULT_EMA_ALPHA = 0.2
#: the epsilon guarding the |G|^2 denominator
GNS_EPS = 1e-30


def noise_scale(g_local_sq: float, g_global_sq: float,
                b_small: float, n: int) -> Optional[float]:
    """The OpenAI two-batch GNS estimate ``S / |G|^2`` from one step;
    ``None`` when ``n <= 1`` — the estimator needs two batch sizes."""
    n = int(n)
    if n <= 1:
        return None
    b_small = float(b_small)
    b_big = b_small * n
    g_local_sq = float(g_local_sq)
    g_global_sq = float(g_global_sq)
    g2 = (b_big * g_global_sq - b_small * g_local_sq) / (b_big - b_small)
    s = (g_local_sq - g_global_sq) / (1.0 / b_small - 1.0 / b_big)
    return s / (abs(g2) + GNS_EPS)


def grad_variance(g_local_sq: float, g_global_sq: float) -> float:
    """Cross-peer gradient variance ``E_i |g_i|^2 - |g_avg|^2``, clamped
    at 0."""
    return max(0.0, float(g_local_sq) - float(g_global_sq))


class PulseMonitor:
    """EMA smoothing, period gating and gauge export for the pulse pair."""

    def __init__(self, every: Optional[int] = None,
                 ema_alpha: Optional[float] = None):
        self.every = max(1, int(every if every is not None else
                                envs.parse_int_env(envs.PULSE_EVERY,
                                                   DEFAULT_EVERY)))
        self.ema_alpha = float(ema_alpha if ema_alpha is not None else
                               envs.parse_float_env(envs.PULSE_EMA,
                                                    DEFAULT_EMA_ALPHA))
        self.gns: Optional[float] = None
        self.variance: Optional[float] = None
        self.samples = 0
        self._count = 0

    @classmethod
    def from_env(cls) -> Optional["PulseMonitor"]:
        """``None`` (no pulse, no cost) when ``KF_PULSE_EVERY`` is 0 or
        negative."""
        every = envs.parse_int_env(envs.PULSE_EVERY, DEFAULT_EVERY)
        if every <= 0:
            return None
        return cls(every=every)

    def should_sample(self, step: Optional[int] = None) -> bool:
        """True on pulse steps: ``step % every == 0`` for an explicit
        step, else every ``every``-th call (the first sample is the
        ``every``-th call, not the first)."""
        if step is not None:
            return int(step) % self.every == 0
        self._count += 1
        return self._count % self.every == 0

    def _ema(self, prev: Optional[float], x: float) -> float:
        if prev is None:
            return x
        a = self.ema_alpha
        return (1.0 - a) * prev + a * x

    def update(self, g_local_sq: float, g_global_sq: float,
               b_small: float, n: int,
               group_norms: Optional[Dict[str, float]] = None,
               step: Optional[int] = None) -> dict:
        """One pulse sample: smooth, publish, return the sample dict.
        ``gns`` stays ``None`` (its gauge untouched) on a single worker;
        the variance publishes regardless."""
        raw = noise_scale(g_local_sq, g_global_sq, b_small, n)
        var = grad_variance(g_local_sq, g_global_sq)
        self.samples += 1
        if raw is not None:
            self.gns = self._ema(self.gns, raw)
            REGISTRY.gauge("kf_gns").set(self.gns)
        self.variance = self._ema(self.variance, var)
        REGISTRY.gauge("kf_grad_variance").set(self.variance)
        for group, norm in (group_norms or {}).items():
            REGISTRY.gauge("kf_grad_norm", group=str(group)).set(float(norm))
        timeline.event("pulse", "sample", gns=raw, var=var,
                       **({} if step is None else {"pulse_step": int(step)}))
        return {"gns": self.gns, "gns_raw": raw,
                "grad_variance": self.variance, "grad_variance_raw": var,
                "n": int(n), "b_small": float(b_small)}
