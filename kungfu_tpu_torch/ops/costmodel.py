"""Analytic FLOPs for the flagship transformer and the live MFU meter.

Port of ``kungfu_tpu/ops/costmodel.py`` (the FLOPs model and
:class:`MFUMeter`).  The reference detects the chip peak from the jax
device kind of a TPU; here :func:`chip_peak_flops` keys on
``torch.cuda.get_device_name()`` and the table holds H100 entries only,
``KF_XRAY_PEAK_FLOPS`` still overriding.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY

#: launch env pinning the per-card peak FLOP/s (overrides detection)
PEAK_ENV = "KF_XRAY_PEAK_FLOPS"

#: NVIDIA H100 datasheet figures (dense, without sparsity), keyed by a
#: substring of ``torch.cuda.get_device_name()``; SXM and PCIe kept
#: apart.  Datasheet peaks at the full power limit, not measurements.
CARD_SPECS = {
    # SXM5 part: reports itself as "NVIDIA H100 80GB HBM3"
    "H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                       "hbm_bytes_s": 3.35e12},
    "H100 SXM": {"bf16_flops": 989e12, "f32_flops": 67e12,
                 "hbm_bytes_s": 3.35e12},
    "H100 PCIe": {"bf16_flops": 756e12, "f32_flops": 51e12,
                  "hbm_bytes_s": 2.0e12},
}


#: per-card bf16 dense peak FLOP/s by device-name substring, the
#: reference's table (there per TPU chip) over ``CARD_SPECS``: the
#: H100's 989 TFLOP/s
CHIP_PEAK_FLOPS = {key: spec["bf16_flops"] for key, spec in CARD_SPECS.items()}


def card_spec(name: str) -> Optional[Dict[str, float]]:
    """Datasheet peaks for a device name, or ``None`` when unknown."""
    for key, spec in CARD_SPECS.items():
        if key in name:
            return spec
    return None


# -- parameter / bytes accounting ------------------------------------------
def transformer_param_count(cfg) -> int:
    """Exact parameter count of the flagship transformer under ``cfg``."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    per_layer = (4 * (d * d + d) + (d * f + f) + (f * d + d) + 2 * 2 * d)
    total = v * d + cfg.n_layers * per_layer + 2 * d
    if cfg.pos == "learned":
        total += cfg.max_seq * d
    return total + d * v  # untied head, no bias


def matmul_param_count(cfg) -> int:
    """Parameters that participate in matmuls (the ``2 * P * tokens``
    denominator of the classic FLOPs estimate): everything except the
    embedding lookup table, positions, layernorms, and biases."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    return cfg.n_layers * (4 * d * d + 2 * d * f) + d * v


def param_bytes(cfg, dtype_bytes: int = 4) -> int:
    """Model parameter footprint (f32 master params by default)."""
    return transformer_param_count(cfg) * dtype_bytes


def kv_bytes_per_token(cfg, dtype_bytes: int = 2) -> int:
    """KV-cache bytes one token pins: K+V per layer in compute dtype."""
    return 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * dtype_bytes


# -- FLOPs model ------------------------------------------------------------
def forward_flops(cfg, batch: int, seq: int, lm_head: bool = True) -> int:
    """Forward FLOPs for ``[batch, seq]`` tokens: matmuls, the quadratic
    attention term (``4 * d * S`` per token per layer), the LM head."""
    d = cfg.d_model
    tokens = batch * seq
    matmul = 2 * tokens * cfg.n_layers * (4 * d * d + 2 * d * cfg.d_ff)
    attn = 4 * tokens * seq * d * cfg.n_layers
    head = 2 * tokens * d * cfg.vocab_size if lm_head else 0
    return matmul + attn + head


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """Fwd + bwd for one step: the standard 3x-forward accounting (the
    backward pass computes both operands' gradients of every matmul)."""
    return 3 * forward_flops(cfg, batch, seq)


def serve_prefill_flops(cfg, tokens: int, start: int = 0) -> int:
    """Prefill of ``tokens`` new positions on top of ``start`` cached ones,
    plus ONE logits row."""
    if tokens <= 0:
        return 0
    d = cfg.d_model
    matmul = 2 * tokens * cfg.n_layers * (4 * d * d + 2 * d * cfg.d_ff)
    attended = tokens * start + tokens * (tokens + 1) // 2
    attn = 4 * d * cfg.n_layers * attended
    return matmul + attn + 2 * d * cfg.vocab_size


def serve_decode_flops(cfg, context: int) -> int:
    """One decode position attending over ``context`` keys."""
    d = cfg.d_model
    matmul = 2 * cfg.n_layers * (4 * d * d + 2 * d * cfg.d_ff)
    attn = 4 * d * cfg.n_layers * max(1, context)
    return matmul + attn + 2 * d * cfg.vocab_size


# -- card peak --------------------------------------------------------------
def chip_peak_flops(device=None) -> Optional[float]:
    """Per-card bf16 peak FLOP/s: ``KF_XRAY_PEAK_FLOPS`` wins, else the
    datasheet entry for the CUDA device's name; ``None`` on the CPU or an
    unknown card (no honest peak to divide by)."""
    pinned = os.environ.get(PEAK_ENV, "").strip()
    if pinned:
        try:
            v = float(pinned)
            return v if v > 0 else None
        except ValueError:
            pass
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    spec = card_spec(torch.cuda.get_device_name(device))
    return spec["bf16_flops"] if spec else None


# -- live meter -------------------------------------------------------------
def record_phases(phases: Dict[str, float]) -> None:
    """Export a per-step phase split as the
    ``kf_step_phase_seconds{phase=...}`` gauges (the continuous
    decomposition kftop's XRAY section renders cluster-wide)."""
    for phase, seconds in phases.items():
        REGISTRY.gauge("kf_step_phase_seconds", phase=phase).set(
            float(seconds))


class MFUMeter:
    """Continuous MFU / model-FLOPs-rate accounting for one loop: each
    :meth:`step` turns the FLOPs added since the last one and the wall
    time into the ``kf_model_flops_s`` gauge, and ``kf_mfu`` when a card
    peak is known."""

    def __init__(self, step_flops: int = 0,
                 peak_flops: Optional[float] = None,
                 detect_peak: bool = True,
                 ema_alpha: float = 0.2,
                 rank: Optional[int] = None):
        self.step_flops = int(step_flops)
        self.peak_flops = (peak_flops if peak_flops is not None
                           else (chip_peak_flops() if detect_peak else None))
        self._alpha = float(ema_alpha)
        self._pending_flops = 0
        self._last = None
        self._rate_ema: Optional[float] = None
        self.rank = rank
        self.mfu: Optional[float] = None

    def add_flops(self, flops: int) -> None:
        self._pending_flops += int(flops)

    def step(self, wall_s: Optional[float] = None) -> Optional[float]:
        now = time.perf_counter()
        if wall_s is None:
            wall_s = (now - self._last) if self._last is not None else None
        self._last = now
        flops = self.step_flops + self._pending_flops
        self._pending_flops = 0
        if wall_s is None or wall_s <= 0 or flops <= 0:
            return self._rate_ema
        rate = flops / wall_s
        self._rate_ema = (rate if self._rate_ema is None
                          else (1 - self._alpha) * self._rate_ema
                          + self._alpha * rate)
        REGISTRY.gauge("kf_model_flops_s").set(self._rate_ema)
        if self.peak_flops:
            self.mfu = self._rate_ema / self.peak_flops
            REGISTRY.gauge("kf_mfu").set(self.mfu)
        if timeline.enabled():
            timeline.event(
                "xray", "mfu-sample", rank=self.rank,
                flops=flops, wall_s=round(wall_s, 6),
                flops_s=round(self._rate_ema, 3),
                mfu=(round(self.mfu, 5) if self.mfu is not None else None))
        return self._rate_ema
