"""The ``KF_*`` knobs the port reads (trimmed copy of
``kungfu_tpu/utils/envs.py``: same names, same defaults).

=============================  ================================================
``KF_TPU_ATTN``                attention impl: "auto"|"xla"|"flash"; ``auto``
                               and ``flash`` take the hand-written kernel on a
                               CUDA tensor and its plain version on a CPU one,
                               ``xla`` the plain softmax attention
                               (models/transformer.py)
``KF_SERVE_QUEUE_DEPTH``       router admission bound: accepted-but-unfinished
                               requests past it are rejected with the typed
                               ``ServeOverloadError``; default 64
                               (serve/router.py)
``KF_SERVE_PAGE_TOKENS``       tokens per KV-cache page, default 16
                               (serve/kvcache.py)
``KF_SERVE_KV_PAGES``          KV-cache pool capacity in pages, default 512
                               (serve/kvcache.py)
``KF_SERVE_MAX_BATCH``         decode batch width per engine, default 8
                               (serve/engine.py)
``KF_SERVE_MAX_TOKENS``        per-request new-token cap, default 256
                               (serve/router.py)
``KF_SERVE_COMMIT_EVERY``      decode positions between progress commits to
                               the router (the replay boundary after a worker
                               death), default 8 (serve/router.py)
``KF_SERVE_REQUEST_DEADLINE``  router per-request progress deadline seconds
                               (no progress within it = a strike against the
                               worker), default 60 (serve/router.py)
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
``KF_SOCK_DIR``                unix sockfile directory override; default
                               /tmp/kf-tpu-<uid> (comm/host.py AND
                               native/transport.cpp — keep in lockstep)
``KF_NATIVE_SANITIZE``         "tsan"|"asan": load the sanitizer-instrumented
                               native build variant (libkfnative-<v>.so) for
                               race/memory debugging (native/__init__.py)
``KF_DATA_DIR``                dataset cache root, default ~/.cache/kungfu_tpu
                               (datasets/cache.py)
``KF_TPU_CKPT_BACKEND``        checkpoint backend: "auto"|"orbax"|"npz"; the
                               port writes npz only and ``orbax`` raises
                               ``NotImplementedError`` (checkpoint.py)
``KF_TPU_BN_COMPUTE``          "f32" restores legacy f32 batch-norm compute
                               (models/nn.py)
=============================  ================================================

Protocol-verifier envs (the kf-verify static SPMD checker,
:mod:`kungfu_tpu_torch.analysis.protoverify`):

=============================  ================================================
``KF_VERIFY_MAX_RANKS``        largest world size the geometry sweep
                               enumerates ParallelPlans for, default 16
``KF_VERIFY_GEOMETRY_CAP``     hard cap on geometries simulated per family
                               (0 = unlimited), default 0
``KF_VERIFY_TIMEOUT_S``        wall-clock budget for the whole geometry
                               sweep in seconds, default 60.0; on expiry
                               the sweep reports how many geometries it
                               covered instead of silently truncating
=============================  ================================================

Not an env var (registered so the ``KF_*`` contract scan covers C++):
``KF_SIMD_CLONES`` is a compile-time macro in native/reduce.cpp selecting
per-ISA function cloning.

The worker bootstrap contract (written by a launcher, read once by
:func:`parse_config_from_env`; unset ``KF_SELF_SPEC`` means one process
alone), and the runtime knobs the peer and failure recovery read:

=================================  ============================================
``KF_SELF_SPEC``                   this worker's ``host:port``
``KF_INIT_PEERS``                  comma-separated worker list
``KF_INIT_RUNNERS``                comma-separated runner list
``KF_PARENT_ID``                   runner that spawned the worker
``KF_INIT_CLUSTER_VERSION``        cluster version at spawn time
``KF_ALLREDUCE_STRATEGY``          host-engine strategy name (plan/strategy.py)
``KF_DEVICE_STRATEGY``             device allreduce schedule (ops/schedules.py)
``KF_CONFIG_SERVER``               URL of the elastic config server
``KF_JOB_START_TIMESTAMP``         unix seconds the job started
``KF_PROC_START_TIMESTAMP``        unix seconds this process started
``KF_NUM_DEVICES``                 ranks each worker process of a device
                                   world holds on its card (default 1;
                                   peer.py)
``KF_COORDINATOR``                 multi-process coordinator address: with
                                   ``KF_NUM_PROCESSES`` > 1 the workers form
                                   one fixed process world on the card
                                   (peer.py, comm/world.py)
``KF_NUM_PROCESSES``               process count of that world
``KF_PROCESS_ID``                  this process's index in it
``KF_WORLD_PEERS``                 provisioned worker-slot list: every slot
                                   boots into one process world, inactive
                                   slots go standby (peer.py)
``KF_CONFIG_ENABLE_MONITORING``    truthy: the peer runs a NetMonitor over its
                                   channel and serves ``/metrics`` at its
                                   port + 10000 (monitor/metrics.py)
``KF_CONFIG_MONITORING_PERIOD``    NetMonitor's rate sampling period, seconds,
                                   default 1
``KF_CONFIG_LOG_LEVEL``            DEBUG/INFO/WARN/ERROR (utils/log.py)
``KF_CONFIG_ENABLE_TRACE``         truthy: log scope entry depth +
                                   duration (utils/trace.py) AND record
                                   flight-recorder timeline events
                                   (monitor/timeline.py)
``KF_CONFIG_TRACE_DUMP``           timeline JSONL dump target: a
                                   directory (one trace-*.jsonl per
                                   process) or an exact *.jsonl path;
                                   written on Peer.close/exit and merged
                                   by kftrace (monitor/timeline.py)
``KF_CONFIG_TIMELINE_CAP``         flight-recorder ring capacity in
                                   events, default 65536; evictions are
                                   counted in kf_timeline_dropped_total
                                   (monitor/timeline.py)
``KF_CONFIG_WATCH_GRACE``          runner natural-end grace window s,
                                   default 10 (runner/watch.py)
``KF_JAX_PLATFORM``                ``cpu``: the launcher's ``-backend cpu``;
                                   the peer's device plane is then the host
                                   (``devices=["cpu"]``), as the reference
                                   reads it; unset, the card
``KF_CONFIG_ENABLE_CLUSTER_MONITOR``  truthy: with a config server, the peer
                                   pushes snapshots to the cluster aggregator
                                   mounted there (monitor/aggregator.py)
``KF_CONFIG_MONITOR_PUSH_PERIOD``  snapshot push interval seconds, default 1
                                   (monitor/aggregator.py)
``KF_CONFIG_MONITOR_STALE_AFTER``  seconds without a snapshot before the
                                   aggregator flags a rank stale; default 3x
                                   the push period (monitor/aggregator.py)
``KF_XRAY_WINDOW_STEPS``           steps in the online attribution window of
                                   ``/cluster``'s xray section, default 32
                                   (monitor/xray.py)
``KF_SENTINEL_DIR``                durable metrics-history root; unset, the
                                   sentinel plane is off and the aggregator's
                                   views are unchanged (the launcher's
                                   ``-sentinel`` sets it; monitor/sentinel.py)
``KF_SENTINEL_KEEP_BYTES``         per-stream history ring byte budget,
                                   default 8 MiB (monitor/history.py)
``KF_SENTINEL_PERIOD``             seconds between sentinel samples, default
                                   1.0; <= 0 samples on every ingest
``KF_SENTINEL_WINDOW``             changepoint window in samples, default 8
                                   (monitor/detect.py)
``KF_SENTINEL_THRESHOLD``          median-shift score (MAD multiples) before
                                   a series alerts, default 4.0
``KF_SENTINEL_MFU_FLOOR``          MFU watermark, default 0 = off
``KF_SENTINEL_STEP_CEILING_S``     step-time watermark seconds, default 0 = off
``KF_SENTINEL_WARMUP_STEPS``       steps considered warmup, default 32; a
                                   compile (a CUDA-graph capture) after it
                                   raises the recompile-steady alert
``KF_SENTINEL_INCIDENT_WINDOW``    history records in an incident bundle,
                                   default 64
``KF_SENTINEL_SLO_SHORT``          SLO burn-rate short window in samples,
                                   default 6 (serve/slo.py SLORules)
``KF_SENTINEL_SLO_LONG``           SLO burn-rate long window in samples,
                                   default 24 (serve/slo.py SLORules)
``KF_CONFIG_ENABLE_STALL_DETECTION``  truthy: blocking peer operations log
                                   every 3 s they stall (utils/stall.py)
``KF_CONFIG_USE_AFFINITY``         truthy: pin the process to its local
                                   rank's share of the CPUs (utils/affinity.py)
``KF_CONFIG_WAIT_RUNNER_TIMEOUT``  s to wait for a runner before a resize
                                   notification is dropped, default 10
``KF_CONFIG_P2P_RESPONDERS``       blob-store responder threads; default
                                   scales with the peer count (store/p2p.py)
``KF_MONITOR_ADDR``                failure-detector ``host[:port]`` the
                                   worker signals (monitor/signals.py)
``MEGASCALE_NUM_SLICES``           slice count; > 1 makes failures and
                                   resizes slice-granular (elastic/slices.py)
``MEGASCALE_SLICE_ID``             this worker's slice (chaos ``die_slice``)
``MEGASCALE_COORDINATOR_ADDRESS``  multislice coordinator (slice 0 host 0;
                                   platforms/tpu_pod.py)
``KF_SLICE_RANKS``                 worker ranks per slice, pinned by the
                                   launcher (elastic/slices.py)
``KF_PERSIST_DIR``                 manifest root of durable checkpoints
``KF_PERSIST_PERIOD``              s between issued persists, default 30; 0
                                   persists at every commit
``KF_PERSIST_ASYNC_DEPTH``         in-flight persist writes before an issue
                                   blocks on the oldest, default 2
``KF_PERSIST_KEEP``                complete manifests kept by rank 0's GC,
                                   default 3 (min 1)
``KF_PERSIST_RESTORE``             truthy: the worker agrees on and restores
                                   the newest complete manifest before
                                   training (elastic/persist.py)
``KF_PP_STAGES``                   pipeline stages, default 1
                                   (``ParallelPlan.from_env``)
``KF_PP_MICROBATCHES``             pipeline microbatches; 0 or unset: one a
                                   stage (``ParallelPlan.from_env``)
``KF_PP_SCHEDULE``                 ``1f1b`` | ``interleaved`` |
                                   ``sequential``, default 1f1b
                                   (``ParallelPlan.from_env``, parallel/pp.py)
=================================  ============================================
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.peer import PeerID, parse_peer_id
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.plan.strategy import Strategy, parse_strategy

ATTN = "KF_TPU_ATTN"
SERVE_QUEUE_DEPTH = "KF_SERVE_QUEUE_DEPTH"
SERVE_PAGE_TOKENS = "KF_SERVE_PAGE_TOKENS"
SERVE_KV_PAGES = "KF_SERVE_KV_PAGES"
SERVE_MAX_BATCH = "KF_SERVE_MAX_BATCH"
SERVE_MAX_TOKENS = "KF_SERVE_MAX_TOKENS"
SERVE_COMMIT_EVERY = "KF_SERVE_COMMIT_EVERY"
SERVE_REQUEST_DEADLINE = "KF_SERVE_REQUEST_DEADLINE"
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

# bootstrap
SELF_SPEC = "KF_SELF_SPEC"
INIT_PEERS = "KF_INIT_PEERS"
INIT_RUNNERS = "KF_INIT_RUNNERS"
PARENT_ID = "KF_PARENT_ID"
INIT_CLUSTER_VERSION = "KF_INIT_CLUSTER_VERSION"
ALLREDUCE_STRATEGY = "KF_ALLREDUCE_STRATEGY"
DEVICE_STRATEGY = "KF_DEVICE_STRATEGY"
CONFIG_SERVER = "KF_CONFIG_SERVER"
JOB_START_TIMESTAMP = "KF_JOB_START_TIMESTAMP"
PROC_START_TIMESTAMP = "KF_PROC_START_TIMESTAMP"
NUM_DEVICES = "KF_NUM_DEVICES"
COORDINATOR = "KF_COORDINATOR"
NUM_PROCESSES = "KF_NUM_PROCESSES"
PROCESS_ID = "KF_PROCESS_ID"
WORLD_PEERS = "KF_WORLD_PEERS"

# the peer runtime and failure recovery
ENABLE_MONITORING = "KF_CONFIG_ENABLE_MONITORING"
MONITORING_PERIOD = "KF_CONFIG_MONITORING_PERIOD"
#: the worker platform the launcher stamps (``-backend cpu``: ``cpu``)
JAX_PLATFORM = "KF_JAX_PLATFORM"
ENABLE_CLUSTER_MONITOR = "KF_CONFIG_ENABLE_CLUSTER_MONITOR"
MONITOR_PUSH_PERIOD = "KF_CONFIG_MONITOR_PUSH_PERIOD"
MONITOR_STALE_AFTER = "KF_CONFIG_MONITOR_STALE_AFTER"
XRAY_WINDOW_STEPS = "KF_XRAY_WINDOW_STEPS"
# the sentinel plane (monitor/sentinel.py and monitor/history.py read the
# same tokens through mirror constants; sentinel_knobs() pins the defaults)
SENTINEL_DIR = "KF_SENTINEL_DIR"
SENTINEL_KEEP_BYTES = "KF_SENTINEL_KEEP_BYTES"
SENTINEL_PERIOD = "KF_SENTINEL_PERIOD"
SENTINEL_WINDOW = "KF_SENTINEL_WINDOW"
SENTINEL_THRESHOLD = "KF_SENTINEL_THRESHOLD"
SENTINEL_MFU_FLOOR = "KF_SENTINEL_MFU_FLOOR"
SENTINEL_STEP_CEILING_S = "KF_SENTINEL_STEP_CEILING_S"
SENTINEL_WARMUP_STEPS = "KF_SENTINEL_WARMUP_STEPS"
SENTINEL_INCIDENT_WINDOW = "KF_SENTINEL_INCIDENT_WINDOW"
SENTINEL_SLO_SHORT = "KF_SENTINEL_SLO_SHORT"
SENTINEL_SLO_LONG = "KF_SENTINEL_SLO_LONG"
ENABLE_STALL_DETECTION = "KF_CONFIG_ENABLE_STALL_DETECTION"
USE_AFFINITY = "KF_CONFIG_USE_AFFINITY"
WAIT_RUNNER_TIMEOUT = "KF_CONFIG_WAIT_RUNNER_TIMEOUT"
P2P_RESPONDERS = "KF_CONFIG_P2P_RESPONDERS"
MONITOR_ADDR = "KF_MONITOR_ADDR"
MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"
SLICE_RANKS = "KF_SLICE_RANKS"
PERSIST_DIR = "KF_PERSIST_DIR"
PERSIST_PERIOD = "KF_PERSIST_PERIOD"
PERSIST_ASYNC_DEPTH = "KF_PERSIST_ASYNC_DEPTH"
PERSIST_KEEP = "KF_PERSIST_KEEP"
PERSIST_RESTORE = "KF_PERSIST_RESTORE"

# the pipeline axis of the parallel plan (ParallelPlan.from_env)
PP_STAGES = "KF_PP_STAGES"
PP_MICROBATCHES = "KF_PP_MICROBATCHES"
PP_SCHEDULE = "KF_PP_SCHEDULE"

# protocol-verifier envs (read by kungfu_tpu_torch/analysis/protoverify.py
# via os.environ directly — the analysis package is stdlib-only and must
# not import this module; registered here so the env-contract scan
# anchors the kf-verify knobs to the same registry, and verify_knobs()
# below pins the defaults both sides must agree on)
VERIFY_MAX_RANKS = "KF_VERIFY_MAX_RANKS"
VERIFY_GEOMETRY_CAP = "KF_VERIFY_GEOMETRY_CAP"
VERIFY_TIMEOUT_S = "KF_VERIFY_TIMEOUT_S"

# observability envs (read by utils/log.py and monitor/timeline.py,
# which name the same tokens beside their readers)
LOG_LEVEL = "KF_CONFIG_LOG_LEVEL"
TRACE_DUMP = "KF_CONFIG_TRACE_DUMP"
TIMELINE_CAP = "KF_CONFIG_TIMELINE_CAP"

#: the bootstrap envs a launcher sets for every worker, the reference's
#: list
ALL_BOOTSTRAP_ENVS = [
    SELF_SPEC, INIT_PEERS, INIT_RUNNERS, PARENT_ID, INIT_CLUSTER_VERSION,
    ALLREDUCE_STRATEGY, CONFIG_SERVER, JOB_START_TIMESTAMP,
    PROC_START_TIMESTAMP, NUM_DEVICES, COORDINATOR, NUM_PROCESSES,
    PROCESS_ID, WORLD_PEERS,
]

#: the values of ``KF_PALLAS_COLLECTIVES``, as the reference names them
COLLECTIVE_IMPLS = ("auto", "pallas", "lax")


def parse_bool_env(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


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


#: every :class:`LaunchKnobs` instance, so that tooling which changes
#: the environment (tests above all) can re-read them all
LAUNCH_KNOBS: list = []


def register_launch_knobs(knobs):
    """Track a reload()-able launch-knob object; returns it."""
    LAUNCH_KNOBS.append(knobs)
    return knobs


class LaunchKnobs:
    """Knobs read when their module is imported and on :meth:`reload`,
    never per call, as the reference's launch-set knobs are: a mid-run
    change of the environment changes nothing until ``reload()``.
    Subclasses read their variables in ``_read``; every instance
    registers for :func:`reload_launch_knobs`."""

    def __init__(self):
        self._read()
        register_launch_knobs(self)

    def reload(self):
        self._read()
        return self

    def _read(self) -> None:
        raise NotImplementedError


def reload_launch_knobs() -> None:
    """Re-read every registered launch-set knob from the current
    environment."""
    for k in LAUNCH_KNOBS:
        k.reload()


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


def verify_knobs() -> dict:
    """The kf-verify geometry-sweep knobs, parsed with their defaults.

    protoverify._knobs() reads the same tokens from ``os.environ``
    directly (it cannot import this module); tests pin that both sides
    use these exact defaults so the documented contract cannot drift.
    """
    return {
        "max_ranks": parse_int_env(VERIFY_MAX_RANKS, 16),
        "geometry_cap": parse_int_env(VERIFY_GEOMETRY_CAP, 0),
        "timeout_s": parse_float_env(VERIFY_TIMEOUT_S, 60.0),
    }


def persist_knobs() -> dict:
    """The persist plane's knobs with their defaults
    (:class:`~kungfu_tpu_torch.elastic.persist.PersistPlane` reads them
    when it is made)."""
    return {
        "dir": os.environ.get(PERSIST_DIR, ""),
        "period_s": parse_float_env(PERSIST_PERIOD, 30.0),
        "depth": parse_int_env(PERSIST_ASYNC_DEPTH, 2),
        "keep": parse_int_env(PERSIST_KEEP, 3),
        "restore": parse_bool_env(PERSIST_RESTORE, False),
    }


def pulse_knobs() -> dict:
    """The kf-pulse plane's knobs with their defaults (reference
    ``utils/envs.py:604``), as ``monitor/pulse.py`` reads them."""
    return {
        "every": parse_int_env(PULSE_EVERY, 10),
        "ema": parse_float_env(PULSE_EMA, 0.2),
    }


def sentinel_knobs() -> dict:
    """The kf-sentinel plane's knobs with their defaults (reference
    ``utils/envs.py:581``), as ``Sentinel.from_env``, the decision ledger
    and kfhist read them."""
    return {
        "dir": os.environ.get(SENTINEL_DIR, ""),
        "keep_bytes": parse_int_env(SENTINEL_KEEP_BYTES, 8 << 20),
        "period_s": parse_float_env(SENTINEL_PERIOD, 1.0),
        "window": parse_int_env(SENTINEL_WINDOW, 8),
        "threshold": parse_float_env(SENTINEL_THRESHOLD, 4.0),
        "mfu_floor": parse_float_env(SENTINEL_MFU_FLOOR, 0.0),
        "step_ceiling_s": parse_float_env(SENTINEL_STEP_CEILING_S, 0.0),
        "warmup_steps": parse_int_env(SENTINEL_WARMUP_STEPS, 32),
        "incident_window": parse_int_env(SENTINEL_INCIDENT_WINDOW, 64),
        "slo_short": parse_int_env(SENTINEL_SLO_SHORT, 6),
        "slo_long": parse_int_env(SENTINEL_SLO_LONG, 24),
    }


@dataclass
class Config:
    """Parsed bootstrap configuration of one worker (reference
    ``utils/envs.py:619``)."""

    self_id: PeerID
    cluster: Cluster
    parent: Optional[PeerID] = None
    strategy: Strategy = Strategy.AUTO
    #: initial device allreduce schedule ("" = psum)
    device_strategy: str = ""
    init_version: int = 0
    config_server: str = ""
    single_process: bool = False
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    #: provisioned worker-slot list; None = the world is the worker list
    world_peers: Optional[PeerList] = None
    job_start: float = field(default_factory=time.time)
    proc_start: float = field(default_factory=time.time)

    @property
    def detached(self) -> bool:
        """True when self is not a member of the current worker list."""
        return self.cluster.workers.rank(self.self_id) is None

    @property
    def rank(self) -> int:
        r = self.cluster.workers.rank(self.self_id)
        if r is None:
            raise RuntimeError(
                f"peer {self.self_id} is not in the worker list "
                f"{self.cluster.workers}")
        return r

    @property
    def size(self) -> int:
        return self.cluster.size()


def parse_config_from_env(env=None) -> Config:
    """Parse the bootstrap contract from ``env`` (default
    ``os.environ``); one process alone when ``KF_SELF_SPEC`` is unset."""
    env = env if env is not None else os.environ
    self_spec = env.get(SELF_SPEC)
    if not self_spec:
        c = Cluster.single_process()
        return Config(self_id=c.workers[0], cluster=c, single_process=True,
                      device_strategy=env.get(DEVICE_STRATEGY, ""))
    self_id = parse_peer_id(self_spec)
    workers = PeerList.parse(env.get(INIT_PEERS, self_spec))
    runners_spec = env.get(INIT_RUNNERS, "")
    if runners_spec:
        runners = PeerList.parse(runners_spec)
    else:
        # no runner daemon: one synthesized runner per host
        from kungfu_tpu_torch.plan.hostspec import DEFAULT_RUNNER_PORT

        runners = PeerList(tuple(PeerID(h, DEFAULT_RUNNER_PORT)
                                 for h in workers.hosts()))
    cluster = Cluster(runners, workers)
    cluster.validate()
    parent = parse_peer_id(env[PARENT_ID]) if env.get(PARENT_ID) else None
    world_spec = env.get(WORLD_PEERS, "")
    world = PeerList.parse(world_spec) if world_spec else None
    if world is not None and world.rank(self_id) is None:
        raise ValueError(
            f"{WORLD_PEERS} set but {self_id} is not a slot in {world}")
    num_processes = int(env.get(NUM_PROCESSES,
                                str(len(world)) if world else "1"))
    process_id = int(env.get(PROCESS_ID,
                             str(world.rank(self_id)) if world else "0"))
    return Config(
        self_id=self_id,
        cluster=cluster,
        parent=parent,
        strategy=parse_strategy(env.get(ALLREDUCE_STRATEGY, "AUTO")),
        device_strategy=env.get(DEVICE_STRATEGY, ""),
        init_version=int(env.get(INIT_CLUSTER_VERSION, "0")),
        config_server=env.get(CONFIG_SERVER, ""),
        coordinator=env.get(COORDINATOR, ""),
        num_processes=num_processes,
        process_id=process_id,
        world_peers=world,
        job_start=float(env.get(JOB_START_TIMESTAMP, time.time())),
        proc_start=float(env.get(PROC_START_TIMESTAMP, time.time())),
    )


def single_machine_env(rank: int, size: int, host: str = "127.0.0.1",
                       ports=None) -> dict:
    """Env dict of worker ``rank`` of ``size`` on one machine (reference
    ``utils/envs.py:706``): workers on consecutive ports from the
    default range's start.  ``ports`` (one a rank) replaces those, for
    clusters that must take ports found free."""
    from kungfu_tpu_torch.plan.hostspec import DEFAULT_PORT_RANGE

    if ports is None:
        lo, _ = DEFAULT_PORT_RANGE
        ports = [lo + i for i in range(size)]
    if len(ports) != size:
        raise ValueError(f"{len(ports)} ports for {size} workers")
    peers = ",".join(f"{host}:{p}" for p in ports)
    return {
        SELF_SPEC: f"{host}:{ports[rank]}",
        INIT_PEERS: peers,
        INIT_RUNNERS: f"{host}:38080",
        INIT_CLUSTER_VERSION: "0",
    }
