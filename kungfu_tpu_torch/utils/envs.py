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
``KF_PALLAS_COLLECTIVES``      ring collective impl: "auto"|"pallas"|"lax";
                               ``auto`` takes the hand-written ring kernels on
                               CUDA tensors and their plain versions on CPU
                               ones, ``pallas`` the kernels (a CPU tensor
                               raises: the port has no interpreter), ``lax``
                               the plain versions; read at import and on
                               ``COLLECTIVES_ENV.reload()``
                               (ops/collectives.py)
``KF_TPU_HOST_TRANSPORT``      host channel backend: "auto"|"python"|"native";
                               ``auto`` gives the native C++ channel when the
                               native library loads, else the Python one
                               (comm/host.py)
``KF_TPU_USE_UNIXSOCK``        "0"/"false"/"no": colocated native channels
                               open no unix socket (comm/host.py)
``KF_TPU_NO_NATIVE``           "1": no native library; numpy reductions and
                               the Python channel (native/__init__.py)
``KF_NATIVE_MARCH``            ``-march=`` of the native build, default
                               ``-mtune=generic`` (native/__init__.py)
``KF_NATIVE_ENGINE``           "0"/"false"/"no": the host engine's Python
                               path even on a native channel (comm/engine.py)
``KF_CONFIG_CHUNK_SIZE``       host-engine chunk bytes, default 256 KiB for
                               one host, 1 MiB across hosts (comm/engine.py)
``KF_CONFIG_ENGINE_THREADS``   C++ executor threads, default
                               min(8, cpu count) (comm/engine.py)
``KF_CONFIG_ENGINE_TIMEOUT``   C++ executor per-collective timeout s, default
                               60 (comm/engine.py)
``KF_CONFIG_PEER_DEADLINE``    per-peer send/recv deadline s, default the
                               engine timeout (comm/engine.py)
``KF_CONFIG_OVERLAP_DEPTH``    async handles in flight per engine, default 2
                               (comm/engine.py)
``KF_CONFIG_STRATEGY_HASH_METHOD``  "NAME": chunks hash onto graph pairs by
                               tensor name, not index (comm/engine.py)
``KF_CONFIG_HOST_POOL_MAX``    ceiling of the engine's chunk pool, default 16
                               (comm/host.py)
``KF_CHAOS_SPEC``              fault clauses (chaos/spec.py); unset: no
                               injection
``KF_CHAOS_SEED``              seed of the delay jitter, default 0
                               (chaos/inject.py)
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
PALLAS_COLLECTIVES = "KF_PALLAS_COLLECTIVES"
HOST_TRANSPORT = "KF_TPU_HOST_TRANSPORT"
USE_UNIXSOCK = "KF_TPU_USE_UNIXSOCK"
STRATEGY_HASH_METHOD = "KF_CONFIG_STRATEGY_HASH_METHOD"
CHUNK_SIZE = "KF_CONFIG_CHUNK_SIZE"
ENGINE_THREADS = "KF_CONFIG_ENGINE_THREADS"
ENGINE_TIMEOUT = "KF_CONFIG_ENGINE_TIMEOUT"
PEER_DEADLINE = "KF_CONFIG_PEER_DEADLINE"
HOST_POOL_MAX = "KF_CONFIG_HOST_POOL_MAX"
OVERLAP_DEPTH = "KF_CONFIG_OVERLAP_DEPTH"
CHAOS_SPEC = "KF_CHAOS_SPEC"
CHAOS_SEED = "KF_CHAOS_SEED"

#: the values of ``KF_PALLAS_COLLECTIVES``, as the reference names them
COLLECTIVE_IMPLS = ("auto", "pallas", "lax")


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


class LaunchKnobs:
    """Knobs read when their module is imported and on :meth:`reload`,
    never per call, as the reference's launch-set knobs are: a mid-run
    change of the environment changes nothing until ``reload()``.
    Subclasses read their variables in ``_read``."""

    def __init__(self):
        self._read()

    def reload(self):
        self._read()
        return self

    def _read(self) -> None:
        raise NotImplementedError


class _CollectiveKnobs(LaunchKnobs):
    """``KF_PALLAS_COLLECTIVES``: the default ``impl`` of every ring
    collective call that does not pass one; a value outside
    :data:`COLLECTIVE_IMPLS` raises."""

    def _read(self) -> None:
        impl = os.environ.get(PALLAS_COLLECTIVES, "auto").lower()
        if impl not in COLLECTIVE_IMPLS:
            raise ValueError(
                f"{PALLAS_COLLECTIVES}={impl!r}: one of {COLLECTIVE_IMPLS}")
        self.impl = impl


COLLECTIVES_ENV = _CollectiveKnobs()
