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
``KF_COORDINATOR``                 multi-process coordinator address: with
                                   ``KF_NUM_PROCESSES`` > 1 the peer raises
                                   until the multi-card slice (peer.py)
``KF_NUM_PROCESSES``               process count of that world
``KF_PROCESS_ID``                  this process's index in it
``KF_WORLD_PEERS``                 provisioned worker-slot list: the peer
                                   raises until the multi-card slice
``KF_CONFIG_ENABLE_MONITORING``    truthy: NetMonitor and /metrics; the peer
                                   raises until ROADMAP A9 (peer.py)
``KF_CONFIG_ENABLE_CLUSTER_MONITOR``  truthy: live snapshot pushes; the peer
                                   raises until ROADMAP A9 (peer.py)
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
COORDINATOR = "KF_COORDINATOR"
NUM_PROCESSES = "KF_NUM_PROCESSES"
PROCESS_ID = "KF_PROCESS_ID"
WORLD_PEERS = "KF_WORLD_PEERS"

# the peer runtime and failure recovery
ENABLE_MONITORING = "KF_CONFIG_ENABLE_MONITORING"
ENABLE_CLUSTER_MONITOR = "KF_CONFIG_ENABLE_CLUSTER_MONITOR"
ENABLE_STALL_DETECTION = "KF_CONFIG_ENABLE_STALL_DETECTION"
USE_AFFINITY = "KF_CONFIG_USE_AFFINITY"
WAIT_RUNNER_TIMEOUT = "KF_CONFIG_WAIT_RUNNER_TIMEOUT"
P2P_RESPONDERS = "KF_CONFIG_P2P_RESPONDERS"
MONITOR_ADDR = "KF_MONITOR_ADDR"
MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
SLICE_RANKS = "KF_SLICE_RANKS"
PERSIST_DIR = "KF_PERSIST_DIR"
PERSIST_PERIOD = "KF_PERSIST_PERIOD"
PERSIST_ASYNC_DEPTH = "KF_PERSIST_ASYNC_DEPTH"
PERSIST_KEEP = "KF_PERSIST_KEEP"
PERSIST_RESTORE = "KF_PERSIST_RESTORE"

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
