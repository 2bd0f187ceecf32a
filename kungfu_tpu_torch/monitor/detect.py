"""kf-sentinel detector math: a deterministic changepoint test and burn
rates (port of ``kungfu_tpu/monitor/detect.py``, stdlib only).

One implementation serves the online :class:`~kungfu_tpu_torch.monitor.
sentinel.Sentinel` and the offline ``kfhist --verdict`` replay, so a live
alert and the post-mortem replay of the durable history cannot disagree.
The test is a median shift scored in MAD units: deterministic (sorted
copies, no RNG, no clock), robust to one straggler sample, and scale-free.
A quiet series (MAD 0) has its scale floored at ``rel_floor x |baseline
median|`` and an absolute epsilon, so it needs a real relative move to
alert.  Numbers are the reference's float arithmetic, equal exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

#: samples per comparison window (the "recent" side; the baseline is the
#: ``BASELINE_WINDOWS`` windows before it)
DEFAULT_WINDOW = 8
#: baseline length in windows — changepoint() truncates its input to
#: ``(BASELINE_WINDOWS + 1) * window`` samples so any caller holding AT
#: LEAST that many samples computes the identical verdict (the
#: offline==online equality depends on this normalization)
BASELINE_WINDOWS = 3
#: MAD multiples of median shift before a series is "shifted"
DEFAULT_THRESHOLD = 4.0
#: scale floor as a fraction of the baseline median (quiet-series guard)
DEFAULT_REL_FLOOR = 0.02
#: absolute scale floor (a series sitting at exactly 0 stays quiet)
ABS_FLOOR = 1e-9


def median(values: Sequence[float]) -> float:
    """Median over a copy (lower-middle interpolated for even counts) —
    deterministic, input order irrelevant."""
    xs = sorted(float(v) for v in values)
    n = len(xs)
    if n == 0:
        raise ValueError("median of empty series")
    mid = n // 2
    if n % 2:
        return xs[mid]
    return (xs[mid - 1] + xs[mid]) / 2.0


def mad(values: Sequence[float], center: Optional[float] = None) -> float:
    """Median absolute deviation about ``center`` (default: the
    median) — the robust spread estimate the shift score divides by."""
    c = median(values) if center is None else center
    return median([abs(float(v) - c) for v in values])


def changepoint(values: Sequence[float],
                window: int = DEFAULT_WINDOW,
                threshold: float = DEFAULT_THRESHOLD,
                rel_floor: float = DEFAULT_REL_FLOOR) -> Optional[dict]:
    """The shared offline/online changepoint verdict for one series.

    Splits the (normalized) sample tail into ``baseline`` (older) and
    ``recent`` (last ``window`` samples) and scores the median shift in
    MAD units.  Returns ``None`` until at least two windows of samples
    exist — a detector with no baseline has no standing to alert —
    otherwise a verdict dict whose ``shifted`` bool is the alert signal
    and whose numbers are the evidence the incident bundle carries.
    """
    window = max(2, int(window))
    xs = [float(v) for v in values]
    # normalize to the bounded tail EVERY consumer agrees on: a caller
    # holding a longer history must not compute a different baseline
    xs = xs[-(BASELINE_WINDOWS + 1) * window:]
    if len(xs) < 2 * window:
        return None
    baseline, recent = xs[:-window], xs[-window:]
    base_med = median(baseline)
    base_mad = mad(baseline, base_med)
    recent_med = median(recent)
    shift = recent_med - base_med
    scale = max(base_mad, rel_floor * abs(base_med) / max(threshold, 1.0),
                ABS_FLOOR)
    score = abs(shift) / scale
    shifted = score >= threshold
    return {
        "n": len(xs),
        "window": window,
        "baseline_n": len(baseline),
        "base_median": round(base_med, 9),
        "base_mad": round(base_mad, 9),
        "recent_median": round(recent_med, 9),
        "shift": round(shift, 9),
        "score": round(score, 6),
        "threshold": threshold,
        "shifted": shifted,
        "direction": ("up" if shift > 0 else "down") if shifted else "flat",
    }


def window_verdicts(series: Dict[str, Sequence[float]],
                    window: int = DEFAULT_WINDOW,
                    threshold: float = DEFAULT_THRESHOLD) -> Dict[str, dict]:
    """:func:`changepoint` per named series, sorted keys, Nones dropped —
    the ``verdicts`` object both ``/alerts`` and ``kfhist --verdict``
    publish (one call site shape, so the equality assertion is a plain
    ``==`` over JSON)."""
    out: Dict[str, dict] = {}
    for name in sorted(series):
        v = changepoint(series[name], window=window, threshold=threshold)
        if v is not None:
            out[name] = v
    return out


def burn_fraction(values: Sequence[float], budget: float,
                  window: int) -> Optional[dict]:
    """Fraction of the last ``window`` samples over ``budget`` — one leg
    of a multi-window burn-rate rule.  ``None`` until the window is
    full (a part-filled window would alias a single bad sample into a
    high rate)."""
    window = max(1, int(window))
    xs = [float(v) for v in values]
    if len(xs) < window:
        return None
    tail = xs[-window:]
    over = sum(1 for v in tail if v > budget)
    return {"window": window, "over": over,
            "frac": round(over / window, 6)}


def slo_burn(values: Sequence[float], budget: float,
             short_window: int, long_window: int,
             short_frac: float, long_frac: float) -> Optional[dict]:
    """The classic two-window burn-rate test: alert only when BOTH the
    short window (fast burn — it is happening now) and the long window
    (sustained burn — it is not one blip) exceed their budget-violation
    fractions.  ``None`` until the long window fills."""
    short = burn_fraction(values, budget, short_window)
    long = burn_fraction(values, budget, long_window)
    if short is None or long is None:
        return None
    burning = short["frac"] >= short_frac and long["frac"] >= long_frac
    return {
        "budget": budget,
        "short": short,
        "long": long,
        "short_frac": short_frac,
        "long_frac": long_frac,
        "burning": burning,
    }
