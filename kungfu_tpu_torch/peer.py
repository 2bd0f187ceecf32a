"""Worker-side peer runtime: identity, stores, membership and elasticity
(port of ``kungfu_tpu/peer.py``).

A :class:`Peer` is made from the env bootstrap contract
(:func:`~kungfu_tpu_torch.utils.envs.parse_config_from_env`).  It owns
the worker's host channel, its blob stores and their p2p responder, the
host collective engine over the current membership and the device-plane
:class:`~kungfu_tpu_torch.comm.device.Communicator` (one per cluster
version), and it applies a membership change: consensus on the proposed
cluster, runners notified, the version bumped, engine and communicator
rebuilt, or the peer marked detached.  In-flight failure recovery
(:meth:`Peer.recover_from_failure`) shrinks the cluster to the
survivors through the same propose path.

Where the port differs from the reference:

* the device plane is explicit: ``Peer(config, devices=None)`` gives
  :meth:`Peer.communicator` a communicator on the card (``devices``
  names its ranks' devices; the tests pass ``["cpu"]``).  The launcher's
  ``-backend cpu`` stamps ``KF_JAX_PLATFORM=cpu``, which the peer reads
  as ``devices=["cpu"]``, as the reference reads it as its jax platform;
  :meth:`Peer.device` is the worker's device, and raises without a card
  unless the CPU was asked for (ROADMAP C24);
* the counterpart of ``jax.distributed`` is the process world of
  :mod:`kungfu_tpu_torch.comm.world`: with ``KF_WORLD_PEERS`` (a
  provisioned world, booted at :meth:`Peer.start` over every slot) or a
  coordinator and ``KF_NUM_PROCESSES`` > 1 (a fixed world, booted at the
  first communicator that spans processes), :meth:`Peer.communicator`
  carves a communicator over the active workers' processes on the one
  card, each holding ``KF_NUM_DEVICES`` ranks (default 1).  In-world
  peers outside the active set go ``standby`` and come back through
  :meth:`Peer.await_rejoin`; ranks on distinct cards raise (the
  multi-card slice);
* ``KF_CONFIG_ENABLE_MONITORING`` starts a
  :class:`~kungfu_tpu_torch.monitor.metrics.NetMonitor` over the peer's
  channel and a ``/metrics`` server at the worker port + 10000, as the
  reference's does: :meth:`Peer.get_egress_rates` returns its measured
  rates and the rank reporter's snapshots carry its byte totals;
* with ``KF_CONFIG_ENABLE_CLUSTER_MONITOR`` and a config server, the
  peer pushes snapshots to the aggregator mounted there (a
  :class:`~kungfu_tpu_torch.monitor.aggregator.RankReporter` under its
  bootstrap rank and slice, refreshing the device-memory gauges before
  each push) and stops it with a final push at :meth:`Peer.close`.  It
  also installs the compile metrics there, as the reference does: in the
  port a compile is a CUDA-graph capture (ROADMAP C26).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

from kungfu_tpu_torch.comm.device import Communicator
from kungfu_tpu_torch.comm.host import ConnType
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger, log_event
from kungfu_tpu_torch.utils.stall import stall_detector
from kungfu_tpu_torch.utils.trace import trace_scope

_log = get_logger("peer")


class Peer:
    def __init__(self, config: Optional[envs.Config] = None,
                 devices: Optional[Sequence] = None):
        self.config = config or envs.parse_config_from_env()
        self.cluster: Cluster = self.config.cluster
        self.cluster_version: int = self.config.init_version
        self.detached: bool = False
        #: in the provisioned world but not in the active worker list:
        #: alive, holding its world slot, waiting for a resize to bring it
        #: back (:meth:`await_rejoin`)
        self.standby: bool = (
            self.config.world_peers is not None
            and self.cluster.workers.rank(self.config.self_id) is None)
        #: a device world of several processes (provisioned, or fixed by
        #: the coordinator envs); its ProcessWorld once booted
        self._multiprocess = (self.config.world_peers is not None
                              or (bool(self.config.coordinator)
                                  and self.config.num_processes > 1))
        self._pworld = None
        ndev = envs.parse_int_env(envs.NUM_DEVICES, 0)
        if devices is None and os.environ.get(envs.JAX_PLATFORM) == "cpu":
            devices = ["cpu"] * max(ndev, 1)  # the launcher's -backend cpu
        elif devices is None and ndev > 1:
            devices = ["cuda"] * ndev
        #: the devices of this process's ranks (None: one on the card)
        self._devices = list(devices) if devices is not None else None
        self._channel = None
        self._p2p_stop = None
        self._comm: Optional[Communicator] = None
        self._comm_version = -1
        from kungfu_tpu_torch.elastic.slices import bootstrap_topology

        try:
            self._slice_boot = bootstrap_topology(
                len(self.config.cluster.workers))
        except ValueError as e:
            # a worker world that does not tile the inherited slice count
            # trains flat, loudly
            _log.warning("incoherent multislice contract (%s) — running "
                         "single-slice (flat)", e)
            self._slice_boot = None
        #: carried across mesh epochs: a resize retires the communicator,
        #: not the user's strategy decision
        self._comm_strategy = self.config.device_strategy or (
            "two_stage" if self._slice_boot is not None else "psum")
        self._engine = None
        self._engine_version = -1
        #: the live cluster plane's snapshot pusher (cluster monitor on)
        self._reporter = None
        #: the byte counters of this peer's channel and their /metrics
        #: server (KF_CONFIG_ENABLE_MONITORING)
        self.net_monitor = None
        self._metrics_server = None
        self._lock = threading.RLock()
        self._started = False
        from kungfu_tpu_torch.store.store import VersionedStore

        #: this peer's versioned blob store (served to other peers)
        self.store = VersionedStore()
        #: control-plane blobs (reserved ``kf.`` names), in a window of
        #: their own so per-step blob versions cannot evict them
        self._ctrl_store = VersionedStore(window=8)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            monitor = None
            if envs.parse_bool_env(envs.ENABLE_MONITORING):
                from kungfu_tpu_torch.monitor.metrics import (
                    METRICS_PORT_OFFSET, MetricsServer, NetMonitor,
                    monitoring_period_from_env)

                monitor = NetMonitor(monitoring_period_from_env()).start()
                self.net_monitor = monitor
                try:
                    self._metrics_server = MetricsServer(
                        monitor,
                        self.config.self_id.port + METRICS_PORT_OFFSET,
                    ).start()
                    _log.info("/metrics on port %d", self._metrics_server.port)
                except OSError as e:
                    _log.warning("metrics server not started: %s", e)
            if not self.config.single_process:
                from kungfu_tpu_torch.comm.host import bind_own_host_channel
                from kungfu_tpu_torch.store import install_p2p_handler

                self._channel = bind_own_host_channel(
                    self.config.self_id, token=self.cluster_version,
                    monitor=monitor)
                self._p2p_stop = install_p2p_handler(
                    self._channel, self.store, self._ctrl_store,
                    n_peers=self.size())
            if self.config.world_peers is not None:
                # every provisioned slot boots the process world now, as
                # the reference's jax.distributed.initialize does
                self._process_world()
            from kungfu_tpu_torch.utils.affinity import bind_local_rank

            world = self.config.world_peers
            if world is not None:
                # by the stable world slot, which a resize does not move
                # (a standby peer has no active local rank)
                lr = world.local_rank(self.config.self_id)
                bind_local_rank(0 if lr is None else lr,
                                max(world.local_size(self.config.self_id), 1))
            else:
                bind_local_rank(self.local_rank(), self.local_size())
            # a fresh process is about to build its step: the failure
            # detector gives it the compile grace (no-op without
            # KF_MONITOR_ADDR)
            from kungfu_tpu_torch.monitor.signals import monitor_compile_grace

            monitor_compile_grace(self.rank())
            from kungfu_tpu_torch.monitor import timeline

            timeline.set_rank(None if self.detached or self.standby
                              else self.rank())
            # live cluster plane: snapshots to the aggregator co-hosted
            # with the config server, under the stable bootstrap rank
            # (a shrink must not make a survivor alias a dead rank's row)
            if (envs.parse_bool_env(envs.ENABLE_CLUSTER_MONITOR)
                    and self.config.config_server):
                rank = self.chaos_rank()
                if rank is None and not (self.detached or self.standby):
                    rank = self.rank()
                if rank is not None:
                    from kungfu_tpu_torch.monitor.aggregator import \
                        RankReporter
                    from kungfu_tpu_torch.monitor.metrics import (
                        install_compile_metrics, publish_device_memory)

                    # CUDA-graph captures become kf_jit_compiles_total,
                    # the recompile-steady watermark's feed (C26)
                    install_compile_metrics()
                    slice_id = (self._slice_boot.slice_of(rank)
                                if self._slice_boot is not None else None)
                    self._reporter = RankReporter(
                        rank, self.config.config_server,
                        strategy_fn=self._active_strategy,
                        net_totals_fn=(self._net_totals
                                       if monitor is not None else None),
                        slice_id=slice_id,
                        pre_snapshot_fn=publish_device_memory,
                    ).start()
            log_event("peer-started")

    def _active_strategy(self) -> str:
        """The active strategy stamped on live snapshots: the host
        engine's (``tree`` for an installed explicit tree), plus the
        device communicator's per-bucket schedule table when the bandit
        has installed one, e.g. ``STAR dev[small=psum,large=ring]``."""
        engine = self._engine
        s = engine.strategy if engine is not None else self.config.strategy
        name = "tree" if (engine is not None and s is None) \
            else getattr(s, "name", str(s))
        comm = self._comm
        if comm is not None:
            buckets = comm.bucket_summary()
            if buckets:
                name = f"{name} dev[{buckets}]"
        return name

    def _net_totals(self) -> dict:
        """The net monitor's byte totals summed over peers, for the rank
        reporter's snapshots."""
        mon = self.net_monitor
        if mon is None:
            return {}
        totals = mon.totals()
        return {"egress_bytes": sum(totals["egress"].values()),
                "ingress_bytes": sum(totals["ingress"].values())}

    def device(self):
        """The worker's device: the CPU where the caller asked for it
        (``devices=["cpu"]`` or ``KF_JAX_PLATFORM=cpu``), else the card;
        raises without a card rather than carrying on on the host."""
        from kungfu_tpu_torch.utils.device import resolve_device

        return resolve_device(self._devices[0] if self._devices else None)

    def close(self) -> None:
        from kungfu_tpu_torch.monitor import timeline

        timeline.maybe_dump()
        if self._reporter is not None:
            # final push before the channels go: a clean shutdown leaves
            # fresh numbers on the aggregator, not a stale flag
            self._reporter.stop(final_push=True)
            self._reporter = None
        with self._lock:
            # a spanning communicator's release meets its peers on the
            # channel, so it goes first; the strategy survives close/start
            self._retire_comm()
            if self._channel is not None:
                self._notify_done()
                if self._p2p_stop is not None:
                    self._p2p_stop()
                    self._p2p_stop = None
                self._channel.close()
                self._channel = None
            if self._metrics_server is not None:
                self._metrics_server.stop()
                self._metrics_server = None
            if self.net_monitor is not None:
                self.net_monitor.stop()
                self.net_monitor = None
            if self._engine is not None:
                self._engine.close()
            self._engine = None
            self._engine_version = -1
            self._comm_version = -1
            self._started = False

    def _process_world(self):
        """The booted process world: every slot of ``KF_WORLD_PEERS``, or
        the fixed world's initial workers (booted at first use)."""
        if self._pworld is None:
            if self._channel is None:
                raise RuntimeError("the process world needs the peer's host "
                                   "channel: start() the peer first")
            from kungfu_tpu_torch.comm.world import ProcessWorld

            slots = self.config.world_peers or self.config.cluster.workers
            # this process's ranks: KF_NUM_DEVICES, default 1
            self._pworld = ProcessWorld(
                self._channel, slots, self.config.self_id, self.device(),
                rows=len(self._devices) if self._devices else 1)
        return self._pworld.boot()

    def _carve(self):
        """The span and mesh layout of the active workers' processes
        (reference ``peer.py:293 _carve_active_devices``): ``(span,
        local_size)``, or ``(None, None)`` while one process holds every
        rank.  The mesh's local axis spans a host, so it is the workers
        a host holds times the ranks a process holds when every host
        holds one contiguous run of equal length, else the whole mesh
        (flat)."""
        if not self._multiprocess or len(self.cluster.workers) <= 1:
            return None, None
        span = self._process_world().span(self.cluster.workers,
                                          self.cluster_version)
        hosts = [w.host for w in self.cluster.workers]
        counts, seen, contiguous = {}, set(), True
        for i, h in enumerate(hosts):
            counts[h] = counts.get(h, 0) + 1
            if i and h != hosts[i - 1] and h in seen:
                contiguous = False
            seen.add(h)
        if len(set(counts.values())) == 1 and contiguous:
            return span, next(iter(counts.values())) * span.rows
        _log.warning("active workers are unevenly or non-contiguously placed "
                     "across hosts %s: the mesh is flat 1x%d", counts, span.n)
        return span, span.n

    # -- identity --------------------------------------------------------
    def rank(self) -> int:
        if self.detached or self.standby:
            return -1
        r = self.cluster.workers.rank(self.config.self_id)
        if r is None:
            raise RuntimeError(
                f"{self.config.self_id} not in worker list "
                f"{self.cluster.workers}")
        return r

    def size(self) -> int:
        return self.cluster.size()

    def local_rank(self) -> int:
        r = self.cluster.workers.local_rank(self.config.self_id)
        return 0 if r is None else r

    def local_size(self) -> int:
        return self.cluster.workers.local_size(self.config.self_id)

    @property
    def channel(self):
        return self._channel

    # -- slice identity (multislice jobs) ---------------------------------
    def slice_topology(self):
        """The current membership's
        :class:`~kungfu_tpu_torch.elastic.slices.SliceTopology`, or None
        on a single-slice job or once the membership no longer tiles
        whole slices (the rank-granular tail)."""
        if self._slice_boot is None:
            return None
        try:
            return self._slice_boot.for_size(self.size())
        except ValueError:
            return None

    def slice_id(self) -> Optional[int]:
        """This worker's slice in the current membership (None on a
        single-slice job)."""
        topo = self.slice_topology()
        return None if topo is None else topo.slice_of(self.rank())

    def chaos_rank(self) -> Optional[int]:
        """The stable fault-injection identity: this worker's rank in its
        bootstrap worker list, which a shrink does not renumber."""
        return self.config.cluster.workers.rank(self.config.self_id)

    # -- communicator (mesh epoch) ---------------------------------------
    def _retire_comm(self) -> None:
        """Drop the communicator ahead of a new epoch, keeping its
        strategy for the next one; a process-spanning one lets its
        symmetric buffers go before the next epoch maps any.  Callers
        hold the lock."""
        if self._comm is not None:
            self._comm_strategy = self._comm.strategy
            self._comm.close()
        self._comm = None

    def _record_strategy(self, name: str) -> None:
        """``on_strategy_change``: a ``set_strategy`` lands on the peer
        even if its communicator is being retired by a resize."""
        self._comm_strategy = name

    _STRATEGY_BLOB = "kf.device-strategy"

    def _sync_device_strategy(self, version: int) -> None:
        """One device schedule per epoch, rank 0's: rank 0 publishes it
        in its control store under the cluster version, every other rank
        pulls it (retried, with jittered backoff, for 30 s)."""
        if self._channel is None or self.size() <= 1:
            return
        ver = str(version)
        if self.rank() == 0:
            # fixed width: Store.save refuses a same-name size change
            self._ctrl_store.save(self._STRATEGY_BLOB,
                                  self._comm_strategy.ljust(32).encode(),
                                  version=ver)
            return
        deadline = time.monotonic() + 30.0
        attempt = 0
        while time.monotonic() < deadline:
            try:
                blob = self.request(0, self._STRATEGY_BLOB, version=ver,
                                    timeout=5.0)
            except (OSError, ConnectionError, TimeoutError):
                blob = None
            if blob:
                self._comm_strategy = blob.decode().strip()
                return
            from kungfu_tpu_torch.utils.retry import sleep_backoff

            sleep_backoff(attempt, base=0.2, cap=1.0)
            attempt += 1
        _log.warning("no device-strategy from rank 0 for v%d after 30s; "
                     "keeping %r", version, self._comm_strategy)

    def communicator(self) -> Communicator:
        """The communicator of the current cluster version, rebuilt after
        a membership change with rank 0's schedule (reference
        ``peer.py:512``): over this peer's devices, or, in a device world
        of several processes, carved over the active workers' processes
        (:meth:`_carve`)."""
        with self._lock:
            if self.standby:
                raise RuntimeError(
                    "standby peer is not in the active worker list; call "
                    "await_rejoin() before communicator()")
            if self._comm is None or self._comm_version != self.cluster_version:
                self._retire_comm()
                self._sync_device_strategy(self.cluster_version)
                span, local_size = self._carve()
                self._comm = Communicator(
                    devices=self._devices,
                    local_size=local_size,
                    strategy=self._comm_strategy,
                    version=self.cluster_version,
                    on_strategy_change=self._record_strategy,
                    span=span,
                )
                self._comm_version = self.cluster_version
                _log.info("new %r", self._comm)
            return self._comm

    def engine(self):
        """The host collective engine over the current membership (None
        without a channel), rebuilt per cluster version."""
        with self._lock:
            if self._channel is None:
                return None
            if (self._engine is None
                    or self._engine_version != self.cluster_version):
                from kungfu_tpu_torch.comm.engine import CollectiveEngine

                if self._engine is not None:
                    self._engine.close()
                self._engine = CollectiveEngine(
                    self._channel, self.cluster.workers, self.config.strategy,
                    chaos_rank=self.chaos_rank())
                self._engine_version = self.cluster_version
            return self._engine

    # -- sync ------------------------------------------------------------
    def barrier(self) -> None:
        """Host-level barrier across the workers."""
        if self.size() <= 1 or self._channel is None:
            return
        with trace_scope("peer.barrier"), stall_detector("barrier"):
            self._channel.barrier(self.cluster.workers,
                                  name=f"barrier.v{self.cluster_version}")

    def consensus_bytes(self, data: bytes, name: str = "consensus") -> bool:
        if self.size() <= 1 or self._channel is None:
            return True
        return self._channel.consensus_bytes(
            data, self.cluster.workers, name=f"{name}.v{self.cluster_version}")

    # -- elasticity (the protocol is in kungfu_tpu_torch.elastic) ---------
    def propose_new_size(self, new_size: int) -> None:
        """Rank 0 PUTs the resized cluster to the config server."""
        if not self.config.config_server:
            raise RuntimeError("propose_new_size requires KF_CONFIG_SERVER")
        if self.rank() != 0:
            return
        from kungfu_tpu_torch.elastic.resize import slice_aligned_size

        new_size = slice_aligned_size(self, new_size)
        world = self.config.world_peers
        if world is not None and new_size > len(world):
            # a worker with no process would wedge every later collective:
            # clamp, as the reference does
            _log.warning("proposed size %d exceeds the provisioned device "
                         "world (%d slots) — clamping to the world capacity",
                         new_size, len(world))
            new_size = len(world)
        if world is not None:
            # a provisioned world grows into its own free slots, in slot
            # order, whatever the launch's port range (ROADMAP C35)
            workers = list(self.cluster.workers)[:new_size]
            workers += [w for w in world if w not in workers][
                :new_size - len(workers)]
            new_cluster = Cluster(self.cluster.runners,
                                  PeerList(tuple(workers)))
        else:
            new_cluster = self.cluster.resize(new_size)
        req = urllib.request.Request(
            self.config.config_server, data=new_cluster.to_json().encode(),
            method="PUT", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()

    def resize_cluster_from_url(self) -> bool:
        """Fetch the target cluster from the config server, agree on it
        and apply it; True when the membership changed."""
        if not self.config.config_server:
            raise RuntimeError("resize requires KF_CONFIG_SERVER")
        from kungfu_tpu_torch.elastic.resize import fetch_cluster_with_consensus

        new_cluster, version = fetch_cluster_with_consensus(self)
        return self._propose(new_cluster, version)

    def resize_cluster(self, n: int) -> bool:
        """Resize to ``n`` workers (through the config server when there
        is one)."""
        if self.config.config_server:
            self.propose_new_size(n)
            return self.resize_cluster_from_url()
        return self._propose(self.cluster.resize(n), self.cluster_version + 1)

    def _propose(self, new_cluster: Cluster, version: int) -> bool:
        """Apply an agreed membership change: notify the runners, bump
        the version, fence the channel, detach if no longer a worker."""
        # no async engine handle may cross a membership change; settling
        # is deadline-bounded, so a dead peer cannot hang it
        eng = self._engine
        if eng is not None:
            eng.drain_async()
        with self._lock:
            if new_cluster.workers == self.cluster.workers:
                return False
            with trace_scope("peer.propose"), stall_detector("propose"):
                self._notify_runners(new_cluster, version)
                self.cluster = new_cluster
                self.cluster_version = version
                if self._channel is not None:
                    self._channel.set_token(version)
                    self._channel.reset_connections()
                world = self.config.world_peers
                active = new_cluster.workers.rank(self.config.self_id) \
                    is not None
                in_world = (world is not None
                            and world.rank(self.config.self_id) is not None)
                # in-world peers never detach: they go standby and are
                # carved into a later epoch without a relaunch
                self.detached = not active and not in_world
                self.standby = not active and in_world
                self._retire_comm()
                pworld = self._pworld
                if (pworld is not None and pworld.described is not None
                        and active and world is None
                        and len(new_cluster.workers) != len(pworld.slots)):
                    # a fixed world: a grown worker is outside it, so the
                    # next communicator() raises for it
                    _log.warning(
                        "resize to %d worker processes but this process's "
                        "device world has %d — surviving processes keep "
                        "their original device world; the new world takes "
                        "effect in relaunched workers only (set "
                        "KF_WORLD_PEERS to provision a max world for live "
                        "resize)", len(new_cluster.workers),
                        len(pworld.slots))
            log_event(f"cluster-resized-v{version}-n{new_cluster.size()}")
        if new_cluster.workers.rank(self.config.self_id) == 0:
            from kungfu_tpu_torch.monitor.aggregator import \
                post_control_if_enabled

            post_control_if_enabled(self, "resize", version=version,
                                    size=new_cluster.size())
        return True

    def _notify_done(self) -> None:
        """Rank 0 tells every runner the job completed (on close)."""
        if self.config.parent is None or self.detached or self.standby:
            return
        if self.cluster.workers.rank(self.config.self_id) != 0:
            return
        for runner in self.cluster.runners:
            try:
                self._channel.send(runner, "done", b"", ConnType.CONTROL,
                                   retries=2)
            except (TimeoutError, ConnectionError, OSError) as e:
                _log.debug("cannot send done to runner %s: %s", runner, e)

    def _notify_runners(self, new_cluster: Cluster, version: int) -> None:
        """Send the new stage to the runners (rank 0 to every runner,
        every other worker to its parent); skipped when no runner
        spawned this worker."""
        if self._channel is None or self.config.parent is None:
            return
        if self.cluster.workers.rank(self.config.self_id) is None:
            return
        stage = json.dumps({"version": version,
                            "cluster": json.loads(new_cluster.to_json())
                            }).encode()
        targets = (new_cluster.runners
                   if self.cluster.workers.rank(self.config.self_id) == 0
                   else [self.config.parent])
        wait_s = envs.parse_float_env(envs.WAIT_RUNNER_TIMEOUT, 10.0)
        for runner in targets:
            try:
                self._channel.wait(runner, timeout=wait_s)
                self._channel.send(runner, "update", stage, ConnType.CONTROL)
            except (TimeoutError, ConnectionError) as e:
                _log.warning("cannot notify runner %s: %s", runner, e)

    # -- standby / world (the provisioned world's live elasticity) --------
    def world_barrier(self, name: str = "world") -> None:
        """Host-plane barrier over every provisioned slot, active and
        standby (job-wide phases such as start and shutdown); nothing to
        do without a provisioned world."""
        world = self.config.world_peers
        if world is None or len(world) <= 1 or self._channel is None:
            return
        with trace_scope("peer.world_barrier"), stall_detector("world_barrier"):
            self._channel.barrier(world, name=f"wbarrier.{name}")

    def observe_stage(self):
        """The config server's current ``(cluster, version)``, not
        applied: standby peers poll it to decide when to rejoin or shut
        down."""
        if not self.config.config_server:
            raise RuntimeError("observe_stage requires KF_CONFIG_SERVER")
        from kungfu_tpu_torch.elastic.resize import fetch_cluster

        return fetch_cluster(self.config.config_server)

    def await_rejoin(self, timeout: float = 300.0,
                     poll_period: float = 0.2) -> bool:
        """A standby peer waits until the config server publishes a stage
        that includes it, then adopts it (version fence, a new epoch at
        the next :meth:`communicator`); True on rejoin, False when
        ``timeout`` passes first.  The active workers agreed on the stage
        before publishing it, so the server is the source of truth; the
        joiner's first collective of the new epoch meets the survivors'."""
        from kungfu_tpu_torch.utils.retry import sleep_backoff

        deadline = time.time() + timeout
        failures = 0
        while time.time() < deadline:
            try:
                cluster, version = self.observe_stage()
            except (OSError, ValueError, KeyError) as e:
                _log.debug("stage fetch failed: %s", e)
                # every standby polling a server that is down: back off
                sleep_backoff(failures, base=poll_period, cap=2.0)
                failures += 1
                continue
            failures = 0
            if version > self.cluster_version:
                with self._lock:
                    self.cluster = cluster
                    self.cluster_version = version
                    if self._channel is not None:
                        self._channel.set_token(version)
                    if cluster.workers.rank(self.config.self_id) is not None:
                        if self._channel is not None:
                            self._channel.reset_connections()
                        self.standby = False
                        self.detached = False
                        self._retire_comm()
                        rejoined = True
                    else:
                        # a newer stage still without us: track its
                        # version so a later rejoin fences on it
                        rejoined = False
                if rejoined:
                    log_event(f"rejoined-v{version}-n{cluster.size()}")
                    return True
            time.sleep(poll_period)
        return False

    # -- in-flight fault tolerance (elastic.shrink) ------------------------
    def recover_from_failure(self, failure: Optional[BaseException] = None,
                             snapshot=None, zero_boundary=None,
                             stage_boundary=None):
        """Survivor-side recovery after a collective raised
        :class:`~kungfu_tpu_torch.comm.faults.PeerFailureError`: confirm
        the dead set by ping, agree on it, apply the shrunk membership
        and return ``(shrunk, replay)`` (see
        :func:`kungfu_tpu_torch.elastic.shrink.recover_from_peer_failure`).
        ``zero_boundary`` re-carves chunk-mode ZeRO state across the
        survivors, a dead rank's chunk from its ring buddy.
        ``stage_boundary`` (a :class:`kungfu_tpu_torch.parallel.pp.
        StageBoundary`) carries a pipeline stage through it the same
        way: the survivors re-balance layers over the remaining stages,
        a whole dead stage restored from its predecessor's ring-buddy
        mirror (recovery-ladder rung 10)."""
        from kungfu_tpu_torch.elastic.shrink import recover_from_peer_failure

        return recover_from_peer_failure(self, failure, snapshot,
                                         zero_boundary=zero_boundary,
                                         stage_boundary=stage_boundary)

    # -- monitoring / adaptation (reference peer.hpp GetPeerLatencies /
    # CheckInterference / GetEgressRates / SetTree) -----------------------
    def get_peer_latencies(self, samples: int = 1):
        """Ping RTT in seconds to every worker (0.0 for this peer, +inf
        for one that does not answer)."""
        from kungfu_tpu_torch.monitor.adapt import get_peer_latencies

        return get_peer_latencies(self, samples)

    def get_egress_rates(self):
        """Bytes/s sent to each worker over the net monitor's last
        sampling period; ``[0.0] * size()`` without a monitor, as the
        reference's."""
        if self.net_monitor is None:
            return [0.0] * self.size()
        return self.net_monitor.egress_rates(
            [str(w) for w in self.cluster.workers])

    def check_interference(self) -> bool:
        """The cluster's majority vote over each rank's interference
        suspicion (a strategy under 0.8 of its best throughput)."""
        from kungfu_tpu_torch.monitor.adapt import (check_interference,
                                                    majority_vote_interference)

        engine = self.engine()
        suspected = bool(engine and check_interference(engine))
        return majority_vote_interference(self, suspected)

    def set_tree(self, forest) -> None:
        """Install an explicit broadcast tree after cluster-wide
        agreement (reference SetTree: consensus on the tree's digest,
        barrier, swap)."""
        from kungfu_tpu_torch.monitor.adapt import set_tree
        from kungfu_tpu_torch.plan.graph import Graph

        digest = Graph.from_forest_array(forest).digest_bytes()
        if not self.consensus_bytes(digest, name="set-tree"):
            raise RuntimeError("peers disagree on the proposed tree")
        self.barrier()
        engine = self.engine()
        if engine is not None:
            set_tree(engine, forest)

    # -- p2p blob store ----------------------------------------------------
    def save(self, name: str, blob, version: Optional[str] = None,
             copy: bool = True) -> None:
        """Save into this peer's store; ``kf.`` names are reserved for
        the control plane.  ``copy=False`` hands over the caller's
        buffer, which must not change after."""
        self.store.save(name, blob, version, copy=copy)

    def request(self, target_rank: int, name: str,
                version: Optional[str] = None,
                timeout: float = 60.0) -> Optional[bytes]:
        """Blob ``name`` from worker ``target_rank``'s store (its control
        store for ``kf.`` names); None when it has none."""
        from kungfu_tpu_torch.store import remote_request

        return remote_request(self, self.cluster.workers[target_rank], name,
                              version, timeout=timeout)

    def request_into(self, target_rank: int, name: str, buf,
                     version: Optional[str] = None, timeout: float = 60.0,
                     send_retries: Optional[int] = None):
        """Blob ``name`` from worker ``target_rank`` into ``buf`` (see
        :func:`~kungfu_tpu_torch.store.p2p.remote_request_into`)."""
        from kungfu_tpu_torch.store import remote_request_into

        return remote_request_into(self, self.cluster.workers[target_rank],
                                   name, buf, version, timeout=timeout,
                                   send_retries=send_retries)


# How often start_local_cluster probes new ports after one was taken.
_CLUSTER_BIND_ATTEMPTS = 5


def _free_ports(n: int, host: str) -> List[int]:
    """``n`` distinct ports the OS reports free on ``host`` (bound and
    released together, so they are distinct; another process may still
    take one before a peer binds it)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind((host, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def start_local_cluster(n: int, env: Optional[Dict[str, str]] = None,
                        devices: Optional[Sequence] = None,
                        host: str = "127.0.0.1") -> List["Peer"]:
    """``n`` started peers of one machine in this process, worker ``r``
    parsed from its own env dict in
    :func:`~kungfu_tpu_torch.utils.envs.single_machine_env`'s shape (plus
    ``env``) on ports found free.  A peer's port is its identity in the
    cluster document before anything binds, so port 0 cannot stand in:
    when a port is taken before its peer binds it, every started peer
    closes and the whole cluster retries on new ports."""
    last: Optional[BaseException] = None
    for _ in range(_CLUSTER_BIND_ATTEMPTS):
        ports = _free_ports(n, host)
        peers: List[Peer] = []
        try:
            for r in range(n):
                cfg = envs.parse_config_from_env(
                    {**envs.single_machine_env(r, n, host, ports=ports),
                     **(env or {})})
                peers.append(Peer(cfg, devices=devices))
                peers[-1].start()
            return peers
        except OSError as e:  # a port was taken between the probe and bind
            last = e
            for p in peers:
                p.close()
    raise OSError(f"could not bind a {n}-peer cluster in "
                  f"{_CLUSTER_BIND_ATTEMPTS} attempts: {last}")
