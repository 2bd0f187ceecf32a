"""``python -m kungfu_tpu_torch`` — the launcher (port of
``kungfu_tpu/runner/cli.py``, the reference's ``kfrun``).

The reference's flags, and its dispatch:

* default: **SimpleRun** — spawn all local workers, wait, fail fast;
* ``-w``: **WatchRun** — the elastic runner: it diffs worker lists on
  each membership update the workers send and spawns or kills
  (:mod:`~kungfu_tpu_torch.runner.watch`);
* ``-auto-recover``: **MonitoredRun** — the heartbeat failure detector
  and the relaunch from the last epoch checkpoint
  (:mod:`~kungfu_tpu_torch.runner.monitored`);
* ``-restore-from``: **PersistRun** — cold-restart supervision over the
  durable manifests (:mod:`~kungfu_tpu_torch.runner.supervise`).

Where the port differs (ROADMAP C24): ``-backend`` is ``gpu`` (the
default: every worker of a host runs on its one card) or ``cpu`` (a
host-only cluster, ``KF_JAX_PLATFORM=cpu``).  ``-device-world``
provisions every host-list slot as one process world on the card (every
slot spawned, those past ``-np`` booting standby; a resize re-carves the
communicator over the active workers, see
:mod:`kungfu_tpu_torch.comm.world`), as the reference's does.  ``-sentinel DIR`` turns
on ``-monitor``, publishes ``KF_SENTINEL_DIR`` and attaches
``Sentinel.from_env()`` to the builtin server's aggregator, as the
reference's does.  The wire defaults stay the reference's:
the runner at port 38080, the failure detector at 7756, a worker's
``/metrics`` at its port + 10000.

Examples::

    python -m kungfu_tpu_torch -np 4 python3 train.py
    python -m kungfu_tpu_torch -backend cpu -np 2 \\
        python3 -m kungfu_tpu_torch.examples.mnist_slp
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from kungfu_tpu_torch.monitor.detector import DEFAULT_COMPILE_GRACE_S
from kungfu_tpu_torch.plan import Cluster, HostList, parse_strategy
from kungfu_tpu_torch.plan.hostfile import parse_hostfile
from kungfu_tpu_torch.plan.hostspec import DEFAULT_RUNNER_PORT
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.runner.job import Job
from kungfu_tpu_torch.runner.proc import run_all
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("kfrun")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kfrun", description="launch kungfu_tpu workers"
    )
    p.add_argument("-np", type=int, default=None,
                   help="total number of workers (default 1; on a detected "
                        "TPU pod, one per pod host)")
    p.add_argument("-H", dest="hosts", default="", help="host spec list ip:slots,...")
    p.add_argument("-hostfile", default="", help="MPI-style hostfile")
    p.add_argument("-self", dest="self_host", default="127.0.0.1",
                   help="this runner's host ip; 'auto' probes which -H "
                        "entry this machine holds (reference NIC discovery)")
    p.add_argument("-strategy", default="AUTO", help="allreduce strategy name")
    p.add_argument("-w", dest="watch", action="store_true", help="elastic watch mode")
    p.add_argument("-device-world", dest="device_world", action="store_true",
                   help="provision ALL host-list slots as one device world; "
                        "elastic resize re-carves the communicator over the "
                        "active workers (inactive slots go standby)")
    p.add_argument("-config-server", dest="config_server", default="", help="elastic config server URL")
    p.add_argument("-builtin-config-port", dest="builtin_config_port", type=int, default=0,
                   help="start a built-in config server on this port")
    p.add_argument("-auto-recover", dest="auto_recover", default="",
                   help="failure-detection period (e.g. 10s); enables MonitoredRun")
    p.add_argument("-device-strategy", dest="device_strategy", default="",
                   help="initial device allreduce schedule "
                        "(psum/two_stage/ring; empty = psum)")
    p.add_argument("-compile-grace", dest="compile_grace",
                   default=f"{int(DEFAULT_COMPILE_GRACE_S)}s",
                   help="stall allowance while a rank is known to be "
                        "compiling (first batch / post-resize re-jit)")
    p.add_argument("-port-range", dest="port_range", default="10000-11000")
    p.add_argument("-logdir", default="")
    p.add_argument("-q", dest="quiet", action="store_true", help="suppress worker output")
    p.add_argument("-timeout", type=float, default=0.0, help="job timeout seconds (0 = none)")
    p.add_argument("-backend", default=None, choices=["cpu", "gpu"],
                   help="worker device backend (default gpu: every worker "
                        "of a host on its one card; cpu: a host-only test "
                        "cluster)")
    p.add_argument("-platform", default="auto", choices=["auto", "none", "tpu-pod"],
                   help="cloud platform adapter: derive -H/-self/-backend from "
                        "the scheduler's env (TPU_WORKER_HOSTNAMES et al.); "
                        "'auto' uses it only when detected AND no -H given")
    p.add_argument("-n-epochs-flag", dest="n_epochs_flag", default="--n-epochs",
                   help="worker flag patched on auto-recovery restart")
    p.add_argument("-tolerate-failures", dest="tolerate_failures",
                   action="store_true",
                   help="do not kill the worker group when one worker dies; "
                        "survivors are expected to shrink-to-survivors "
                        "in-flight (docs/fault_tolerance.md).  The run "
                        "succeeds iff at least one worker exits 0")
    p.add_argument("-chaos", dest="chaos", default="",
                   help="deterministic fault-injection spec exported to "
                        "workers as KF_CHAOS_SPEC (kungfu_tpu/chaos/spec.py; "
                        "e.g. 'die:step=5,rank=1' kills rank 1 at step 5)")
    p.add_argument("-chaos-seed", dest="chaos_seed", type=int, default=None,
                   help="KF_CHAOS_SEED for the workers (delay jitter)")
    p.add_argument("-num-slices", dest="num_slices", type=int, default=0,
                   help="partition the workers into this many TPU slices "
                        "(slice-major contiguous).  Each worker's env gets "
                        "its MEGASCALE_SLICE_ID (+ NUM_SLICES and "
                        "KF_SLICE_RANKS), switching the peers to the "
                        "hierarchical ICI-within/DCN-across communicator "
                        "and slice-granular elasticity.  This is the CPU "
                        "emulation contract (docs/multislice.md); a real "
                        "pod's hosts already carry their MEGASCALE_* "
                        "identity and must not be re-stamped")
    p.add_argument("-persist-dir", dest="persist_dir", default="",
                   help="durable manifest root exported to workers as "
                        "KF_PERSIST_DIR: training loops that carry a "
                        "PersistPlane stream async per-rank shard "
                        "checkpoints there (docs/persistence.md)")
    p.add_argument("-restore-from", dest="restore_from", default="",
                   help="manifest root to cold-restart from: implies "
                        "-persist-dir DIR, sets KF_PERSIST_RESTORE=1 so "
                        "workers resume from the newest complete manifest "
                        "(onto THIS launch's world size — restore is "
                        "shape-agnostic), and supervises the job: a "
                        "whole-group preemption (every rank exits 43) "
                        "relaunches from the newest complete manifest. "
                        "An empty/fresh directory is a fresh start")
    p.add_argument("-monitor", dest="monitor", action="store_true",
                   help="live cluster observability plane: mount the "
                        "aggregator on the (builtin) config server, make "
                        "every worker push snapshots "
                        "(KF_CONFIG_ENABLE_CLUSTER_MONITOR), and enable "
                        "tracing + the network monitor so snapshots carry "
                        "collective spans and byte rates; starts an "
                        "ephemeral builtin config server when none is "
                        "configured")
    p.add_argument("-sentinel", dest="sentinel", default="",
                   help="kf-sentinel judging plane: durable metrics "
                        "history, changepoint/SLO-burn/watermark alerts "
                        "and incident bundles under DIR, served as "
                        "/alerts and /decisions (implies -monitor; sets "
                        "KF_SENTINEL_DIR for Sentinel.from_env)")
    p.add_argument("-monitor-interval", dest="monitor_interval", type=float,
                   default=0.0,
                   help="snapshot push period seconds "
                        "(KF_CONFIG_MONITOR_PUSH_PERIOD; default 1)")
    p.add_argument("-trace", dest="trace", action="store_true",
                   help="enable scoped tracing + the flight-recorder "
                        "timeline in every worker (KF_CONFIG_ENABLE_TRACE)")
    p.add_argument("-trace-dump", dest="trace_dump", default="",
                   help="directory for per-rank timeline JSONL dumps "
                        "(KF_CONFIG_TRACE_DUMP; implies -trace)")
    p.add_argument("prog", help="worker program")
    p.add_argument("args", nargs=argparse.REMAINDER, help="worker program args")
    return p


def parse_port_range(spec: str):
    lo, hi = spec.split("-")
    return int(lo), int(hi)


def build_hostlist(ns) -> HostList:
    if ns.hostfile:
        return parse_hostfile(ns.hostfile)
    if ns.hosts:
        return HostList.parse(ns.hosts)
    return HostList.parse(f"{ns.self_host}:{max(ns.np or 1, 1)}")


def build_cluster(ns) -> Cluster:
    hl = build_hostlist(ns)
    return Cluster(
        hl.gen_runner_list(DEFAULT_RUNNER_PORT),
        hl.gen_peer_list(ns.np or 1, parse_port_range(ns.port_range)),
    )


def simple_run(ns, cluster: Cluster, job: Job) -> int:
    procs = job.create_procs(cluster, ns.self_host)
    if not procs:
        _log.warning("no workers for host %s", ns.self_host)
        return 0
    _log.info(
        "launching %d/%d workers on %s (strategy=%s)",
        len(procs), cluster.size(), ns.self_host, job.strategy,
    )
    codes = run_all(procs, quiet=ns.quiet, timeout=ns.timeout or None,
                    fail_fast=not ns.tolerate_failures)
    bad = [c for c in codes if c != 0]
    if bad and ns.tolerate_failures and len(bad) < len(codes):
        # dead workers are survivable by design: the survivors shrank
        # around them and finished — that IS the success criterion
        _log.warning(
            "%d worker(s) died (codes %s); survivors completed", len(bad), codes
        )
        return 0
    if bad:
        _log.error("workers failed: exit codes %s", codes)
        return 1
    return 0


def apply_platform(ns) -> None:
    """Fill -H/-self/-backend from a detected cloud platform contract
    (reference ``platforms/modelarts`` analog, TPU-pod flavored).

    ``auto`` applies only when the user gave NO topology (-H/-hostfile)
    and NO explicit -backend — any explicit flag opts out of the magic.
    ``tpu-pod`` (forced) lets the pod contract win outright."""
    if ns.platform == "none":
        return
    from kungfu_tpu_torch.platforms import parse_tpu_pod_env

    if ns.platform == "auto" and (
        ns.hosts or ns.hostfile or ns.backend is not None
    ):
        return  # any explicit choice wins over detection
    info = parse_tpu_pod_env()
    if info is None:
        if ns.platform == "tpu-pod":
            raise SystemExit(
                "kfrun: -platform tpu-pod but TPU_WORKER_HOSTNAMES is not set"
            )
        return
    if ns.np is not None and ns.np > info.num_hosts:
        if ns.platform == "tpu-pod":
            raise SystemExit(
                f"kfrun: -np {ns.np} exceeds the detected TPU pod's "
                f"capacity ({info.num_hosts} hosts, 1 worker slot each)"
            )
        # auto mode: an explicit -np the pod can't host (1 slot/host)
        # means a local multi-process cluster, not the pod topology
        _log.info(
            "platform auto: detected TPU pod (%d hosts) cannot host "
            "-np %d; keeping the default localhost cluster",
            info.num_hosts, ns.np,
        )
        return
    ns.hosts = str(info.hosts)
    ns.hostfile = ""  # the pod contract IS the topology
    ns.self_host = info.self_host
    ns.backend = "gpu"  # the pod's hosts each run on their card
    if ns.np is None:
        # only the DEFAULT np expands to the whole pod; an explicit
        # `-np 1` (distinguishable now that the argparse default is
        # None) keeps its single worker
        ns.np = info.num_hosts
    if info.num_slices > 1:
        # cross-slice (DCN) device coordination is libtpu's, and on a
        # real pod TPU_WORKER_HOSTNAMES lists THIS slice's hosts only —
        # so the launcher must NOT partition them into synthetic slices.
        # Each worker inherits its host's true MEGASCALE_* identity from
        # the environment; `-num-slices` (the explicit flag) exists for
        # the emulation contract, where there is no env to inherit.
        if ns.num_slices > 0:
            raise SystemExit(
                "kfrun: -num-slices on a detected multislice pod would "
                "overwrite the hosts' real MEGASCALE_SLICE_ID — the pod "
                "env already carries slice identity (drop the flag)")
        _log.info(
            "multislice pod (slice %d/%d, coordinator %s): MEGASCALE "
            "envs pass through to workers", info.slice_id,
            info.num_slices, info.coordinator or "?",
        )
    _log.info(
        "platform tpu-pod: -H %s -self %s (np=%d)",
        ns.hosts, ns.self_host, ns.np,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ns = build_parser().parse_args(argv)
    apply_platform(ns)
    if ns.self_host == "auto":
        # the same command line on every host: each runner works out
        # which -H entry it is
        if not (ns.hosts or ns.hostfile):
            raise SystemExit("kfrun: -self auto needs -H or -hostfile")
        from kungfu_tpu_torch.runner.discovery import infer_self_ip

        try:
            ns.self_host = infer_self_ip(
                [h.ip for h in build_hostlist(ns).hosts])
        except RuntimeError as e:
            raise SystemExit(f"kfrun: {e}") from None
        _log.info("self host inferred: %s", ns.self_host)
    if ns.np is None:
        ns.np = 1
    if ns.backend is None:
        ns.backend = "gpu"
    strategy = parse_strategy(ns.strategy)
    if ns.device_strategy:
        from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES

        if ns.device_strategy not in ALLREDUCE_SCHEDULES:
            raise SystemExit(
                f"kfrun: unknown -device-strategy {ns.device_strategy!r}; "
                f"one of {ALLREDUCE_SCHEDULES}"
            )
    cluster = build_cluster(ns)
    if ns.sentinel:
        # the judge needs the aggregator it attaches to
        ns.monitor = True

    config_server_url = ns.config_server
    builtin = None
    if ns.builtin_config_port or (ns.monitor and not config_server_url):
        from kungfu_tpu_torch.elastic.configserver import ConfigServer

        aggregator = None
        if ns.monitor:
            from kungfu_tpu_torch.monitor.aggregator import (
                MIN_PUSH_PERIOD_S, STALE_PERIODS, ClusterAggregator)

            if ns.monitor_interval > 0:
                # the workers' floor: a tighter staleness clock than any
                # worker can meet would flag every healthy rank
                ns.monitor_interval = max(ns.monitor_interval,
                                          MIN_PUSH_PERIOD_S)
            aggregator = ClusterAggregator(
                stale_after=(STALE_PERIODS * ns.monitor_interval
                             if ns.monitor_interval > 0 else None))
            if ns.sentinel:
                from kungfu_tpu_torch.monitor.sentinel import Sentinel
                from kungfu_tpu_torch.utils.envs import SENTINEL_DIR

                root = os.path.abspath(ns.sentinel)
                os.makedirs(root, exist_ok=True)
                # publish the root so Sentinel.from_env reads the whole
                # sentinel knob family from the environment
                os.environ[SENTINEL_DIR] = root
                aggregator.attach_sentinel(Sentinel.from_env())
                _log.info("sentinel history -> %s (replay: python -m "
                          "kungfu_tpu_torch.monitor.kfhist --dir %s "
                          "--verdict)", root, root)
        # -monitor with no config server still needs a push target: an
        # ephemeral builtin server carries the aggregator (port 0)
        builtin = ConfigServer(port=ns.builtin_config_port, cluster=cluster,
                               aggregator=aggregator)
        builtin.start()
        config_server_url = f"http://127.0.0.1:{builtin.port}/get"
        _log.info("builtin config server at %s", config_server_url)
    elif ns.monitor:
        _log.info(
            "-monitor with an external config server: run it with "
            "`python -m kungfu_tpu_torch.elastic.configserver -monitor` so "
            "/push, /cluster and /metrics exist there"
        )

    world = None
    if ns.device_world:
        hl = build_hostlist(ns)
        world = hl.gen_peer_list(hl.cap(), parse_port_range(ns.port_range))

    if ns.num_slices and ns.num_slices > 1:
        spawn_total = len(world) if world is not None else cluster.size()
        if spawn_total % ns.num_slices:
            raise SystemExit(
                f"kfrun: -num-slices {ns.num_slices} does not tile "
                f"{spawn_total} worker slot(s) — slices need identical "
                "worker counts")
        _log.info(
            "multislice: %d slice(s) x %d worker(s) (slice-major)",
            ns.num_slices, spawn_total // ns.num_slices,
        )

    if ns.tolerate_failures and (ns.auto_recover or ns.watch):
        # the monitored and watch runners have their own worker-death
        # policy (relaunch / respawn)
        raise SystemExit(
            "kfrun: -tolerate-failures applies to the simple runner only "
            "(-auto-recover relaunches on worker death, -w respawns via "
            "the config server)"
        )
    if ns.persist_dir and ns.restore_from:
        raise SystemExit(
            "kfrun: -persist-dir and -restore-from are exclusive — "
            "-restore-from already names the manifest root (and keeps "
            "persisting into it)"
        )
    if ns.restore_from and (ns.auto_recover or ns.watch):
        # two supervisors would race over the same dead workers
        raise SystemExit(
            "kfrun: -restore-from is its own supervisor (cold restart "
            "from the durable manifest plane) and cannot combine with "
            "-auto-recover or -w"
        )
    extra_envs = {}
    persist_root = ns.restore_from or ns.persist_dir
    if persist_root:
        from kungfu_tpu_torch.utils.envs import PERSIST_DIR, PERSIST_RESTORE

        persist_root = os.path.abspath(persist_root)
        os.makedirs(persist_root, exist_ok=True)
        extra_envs[PERSIST_DIR] = persist_root
        if ns.restore_from:
            extra_envs[PERSIST_RESTORE] = "1"
        _log.info("durable manifests -> %s", persist_root)
    if ns.monitor:
        from kungfu_tpu_torch.monitor.aggregator import (PUSH_PERIOD_ENV,
                                                         server_base)
        from kungfu_tpu_torch.utils.envs import (ENABLE_CLUSTER_MONITOR,
                                                 ENABLE_MONITORING)

        extra_envs[ENABLE_CLUSTER_MONITOR] = "1"
        # byte rates for the snapshots; the net monitor is cheap
        extra_envs[ENABLE_MONITORING] = "true"
        # online skew feeds on flight-recorder spans
        ns.trace = True
        if ns.monitor_interval > 0:
            extra_envs[PUSH_PERIOD_ENV] = str(ns.monitor_interval)
        _log.info("live cluster view: %s/cluster",
                  server_base(config_server_url))
    if ns.trace or ns.trace_dump:
        from kungfu_tpu_torch.monitor.timeline import DUMP_ENV
        from kungfu_tpu_torch.utils.trace import ENABLE_TRACE

        extra_envs[ENABLE_TRACE] = "1"
        if ns.trace_dump:
            dump_dir = os.path.abspath(ns.trace_dump)
            os.makedirs(dump_dir, exist_ok=True)
            extra_envs[DUMP_ENV] = dump_dir
            _log.info("timeline dumps -> %s", dump_dir)
    if ns.chaos:
        # a typo'd spec dies here, not as a fault-free experiment
        from kungfu_tpu_torch.chaos import SEED_ENV, SPEC_ENV, parse_spec

        try:
            parse_spec(ns.chaos)
        except ValueError as e:
            raise SystemExit(f"kfrun: bad -chaos spec: {e}") from None
        extra_envs[SPEC_ENV] = ns.chaos
        if ns.chaos_seed is not None:
            extra_envs[SEED_ENV] = str(ns.chaos_seed)
        _log.warning("fault injection armed: %s", ns.chaos)

    job = Job(
        prog=ns.prog,
        args=[a for a in ns.args if a != "--"],
        strategy=strategy,
        device_strategy=ns.device_strategy,
        config_server=config_server_url,
        log_dir=ns.logdir,
        parent=PeerID(ns.self_host, DEFAULT_RUNNER_PORT),
        backend=ns.backend,
        world=world,
        slices=max(ns.num_slices, 0),
        extra_envs=extra_envs,
    )
    try:
        if ns.restore_from:
            from kungfu_tpu_torch.runner.supervise import persist_run

            return persist_run(ns, cluster, job)
        if ns.auto_recover:
            from kungfu_tpu_torch.runner.monitored import monitored_run

            return monitored_run(ns, cluster, job)
        if ns.watch:
            from kungfu_tpu_torch.runner.watch import watch_run

            return watch_run(ns, cluster, job)
        return simple_run(ns, cluster, job)
    finally:
        if builtin is not None:
            builtin.stop()


if __name__ == "__main__":
    sys.exit(main())
