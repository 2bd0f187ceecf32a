"""The ``KF_*`` knobs the port reads (trimmed copy of
``kungfu_tpu/utils/envs.py``: same names, same defaults).

=============================  ================================================
``KF_TPU_ATTN``                attention impl: "auto"|"xla"|"flash"; ``auto``
                               and ``flash`` take the hand-written kernel on a
                               CUDA tensor and its plain version on a CPU one,
                               ``xla`` the plain softmax attention
                               (models/transformer.py)
``KF_SERVE_PAGE_TOKENS``       tokens per KV-cache page, default 16
                               (serve/kvcache.py)
``KF_SERVE_KV_PAGES``          KV-cache pool capacity in pages, default 512
                               (serve/kvcache.py)
``KF_SERVE_MAX_BATCH``         decode batch width per engine, default 8
                               (serve/engine.py)
``KF_SERVE_SLO_TTFT_MS``       time-to-first-token SLO target ms, default 500
                               (serve/slo.py)
``KF_SERVE_SLO_E2E_MS``        end-to-end request SLO target ms, default 5000
                               (serve/slo.py)
``KF_XRAY_PEAK_FLOPS``         per-card peak FLOP/s pinned for the kf_mfu
                               gauge, overriding device-name detection
                               (ops/costmodel.py)
``KF_TPU_XENT``                cross-entropy impl: "auto"|"fused"|"plain"|
                               "xla" (alias of plain); ``fused`` takes the
                               Triton kernels, ``auto`` is ``plain`` until an
                               H100 sweep sets a crossover; read at import
                               and on ``XENT_ENV.reload()`` (ops/xent.py)
``KF_XENT_XLA_BUDGET_MB``      logits-bytes budget of the reference's training
                               routing rule, default 2048 (ops/xent.py)
``KF_XENT_FWD_MIN_ELEMENTS``   min logits elements of the reference's
                               forward-only routing rule, default 4194304
                               (ops/xent.py)
``KF_TPU_LM_HEAD``             lm-head impl: "auto"|"fused"|"plain"; ``auto``
                               is ``plain`` off a TPU, ``fused`` raises until
                               the fused LM-head kernels are ported
                               (models/transformer.py)
``KF_PULSE_EVERY``             sample the gradient-noise-scale / variance pair
                               every N steps, default 10; 0 disables
                               (monitor/pulse.py, parallel/train.py)
``KF_PULSE_EMA``               EMA weight of the published pulse estimates,
                               default 0.2 (monitor/pulse.py)
=============================  ================================================
"""

from __future__ import annotations

import os

ATTN = "KF_TPU_ATTN"
SERVE_PAGE_TOKENS = "KF_SERVE_PAGE_TOKENS"
SERVE_KV_PAGES = "KF_SERVE_KV_PAGES"
SERVE_MAX_BATCH = "KF_SERVE_MAX_BATCH"
SERVE_SLO_TTFT_MS = "KF_SERVE_SLO_TTFT_MS"
SERVE_SLO_E2E_MS = "KF_SERVE_SLO_E2E_MS"
XRAY_PEAK_FLOPS = "KF_XRAY_PEAK_FLOPS"
XENT = "KF_TPU_XENT"
XENT_XLA_BUDGET_MB = "KF_XENT_XLA_BUDGET_MB"
XENT_FWD_MIN_ELEMENTS = "KF_XENT_FWD_MIN_ELEMENTS"
LM_HEAD = "KF_TPU_LM_HEAD"
PULSE_EVERY = "KF_PULSE_EVERY"
PULSE_EMA = "KF_PULSE_EMA"


def parse_int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def parse_float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default
