"""MonitoredRun — failure detection and automatic restart (port of
``kungfu_tpu/runner/monitored.py``, the fork's ``runner/monitored.go``).

The job runs under the heartbeat detector; when a worker is flagged down
(a batch begun and not ended within the period, or a process exited
non-zero) the runner kills the group, rewrites ``--n-epochs`` to the
remaining count, appends ``--restart 1`` and relaunches.  Workers
checkpoint each epoch and reload on ``--restart 1`` (see
``kungfu_tpu_torch/examples/failure_recovery.py`` and
:mod:`kungfu_tpu_torch.checkpoint`).  A round that exits cleanly having
completed fewer epochs than asked fails the job (the epoch contract).

Two differences from the reference: the detector binds this runner's
own address (``-self``), not the wildcard, so runners on loopback
aliases each hold port 7756; and the killed group's exit is awaited,
with ``SIGKILL`` after a grace, before the relaunch, since a worker on
the card frees its memory only when it has exited.  Each round logs
``monitored-round-N-{spawn,down,exited}`` events with their wall times.
"""

from __future__ import annotations

import re
import time
from typing import List, Optional

from kungfu_tpu_torch.monitor.detector import (DEFAULT_DETECTOR_PORT,
                                               DetectorServer, query_detector)
from kungfu_tpu_torch.monitor.signals import MONITOR_ADDR_ENV
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.runner.job import Job
from kungfu_tpu_torch.runner.proc import kill_group, start_proc, wait_group
from kungfu_tpu_torch.utils.log import get_logger, log_event
from kungfu_tpu_torch.utils.retry import jittered

_log = get_logger("monitored")

MAX_RESTARTS = 16


def parse_period(spec: str) -> float:
    """'10s' / '2m' / plain seconds."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(s|m|ms)?", spec.strip())
    if not m:
        raise ValueError(f"bad period {spec!r}")
    v = float(m.group(1))
    unit = m.group(2) or "s"
    return v * {"s": 1.0, "m": 60.0, "ms": 0.001}[unit]


def patch_args(args: List[str], remaining_epochs: int, flag: str = "--n-epochs") -> List[str]:
    """Rewrite the epochs flag and mark the restart
    (reference ``monitored.go:52-66``)."""
    out = list(args)
    for i, a in enumerate(out):
        if a == flag and i + 1 < len(out):
            out[i + 1] = str(remaining_epochs)
            break
        if a.startswith(flag + "="):
            out[i] = f"{flag}={remaining_epochs}"
            break
    else:
        out += [flag, str(remaining_epochs)]
    # force --restart 1, overriding an explicit --restart 0 from the
    # original command line (a surviving 0 would skip checkpoint restore)
    for i, a in enumerate(out):
        if a == "--restart" and i + 1 < len(out):
            out[i + 1] = "1"
            break
        if a.startswith("--restart="):
            out[i] = "--restart=1"
            break
    else:
        out += ["--restart", "1"]
    return out


def find_epochs(args: List[str], flag: str = "--n-epochs") -> Optional[int]:
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            return int(args[i + 1])
        if a.startswith(flag + "="):
            return int(a.split("=", 1)[1])
    return None


def _resolve_done_epochs(detector, self_host: str, main_host: str) -> int:
    """Completed-epoch count for the restart round.  Only the main host's
    detector receives heartbeats, so it is the authority; non-main hosts
    query it (retrying briefly — its down flag may lag a moment) and only
    fall back to the fan-out epoch if it is unreachable.  Every host must
    compute the SAME number or ranks relaunch with different --n-epochs
    and the job deadlocks in collectives."""
    if self_host == main_host:
        return detector.results.epoch_num or detector.min_epoch()
    deadline = time.time() + 10.0
    while time.time() < deadline:
        try:
            res = query_detector(main_host, detector.port)
            if res.get("down") or res.get("finished"):
                return int(res.get("epoch", 0))
        except OSError:
            pass
        # jittered: every non-main host polls the main detector at once
        # during a restart round
        time.sleep(jittered(0.5))
    _log.warning(
        "could not fetch authoritative epoch from %s; using fan-out value %d",
        main_host, detector.results.epoch_num,
    )
    return detector.results.epoch_num


def monitored_run(ns, cluster: Cluster, job: Job) -> int:
    period = parse_period(ns.auto_recover)
    self_host = ns.self_host
    hosts = cluster.runners.hosts()
    main_host = hosts[0]
    peer_hosts = [h for h in hosts if h != self_host]
    detector = DetectorServer(
        expected_ranks=cluster.size(),
        peer_hosts=peer_hosts,
        stall_timeout=period,
        compile_grace=parse_period(ns.compile_grace),
        host=self_host,
    ).start()
    job.extra_envs[MONITOR_ADDR_ENV] = f"{main_host}:{DEFAULT_DETECTOR_PORT}"

    total_epochs = find_epochs(job.args, ns.n_epochs_flag)
    args0 = list(job.args)
    restarts = 0
    epochs_done_total = 0  # cumulative across restart rounds
    try:
        while True:
            detector.reset(cluster.size())
            procs = job.create_procs(cluster, self_host)
            log_event(f"monitored-round-{restarts}-spawn")
            running = [start_proc(p, i, quiet=ns.quiet) for i, p in enumerate(procs)]
            _log.info(
                "round %d: %d workers (remaining args: %s)",
                restarts, len(running), " ".join(job.args),
            )
            while True:
                time.sleep(0.2)
                codes = [r.popen.poll() for r in running]
                if detector.results.finish_flag or all(c == 0 for c in codes):
                    # acceptance: success means the EPOCH CONTRACT was met,
                    # not merely that processes exited 0 — a restart round
                    # that silently retrained from scratch (restore
                    # failure) finishes "cleanly" having trained the wrong
                    # epochs.  min_epoch is the min cumulative
                    # completed-epoch count across ranks.
                    # Only enforceable where epoch heartbeats actually
                    # arrive: the main host's detector (workers post only
                    # there).  Non-main hosts always see min_epoch()==0 and
                    # must not fail a healthy recovery; likewise a job that
                    # never signals epochs can still finish cleanly.
                    if total_epochs is not None and detector.min_epoch() > 0:
                        completed = max(detector.min_epoch(), epochs_done_total)
                        if completed < total_epochs:
                            _log.error(
                                "workers exited cleanly but completed only "
                                "%d/%d epochs — epoch contract violated",
                                completed, total_epochs,
                            )
                            return 1
                    _log.info("training finished")
                    return 0
                if any(c is not None and c != 0 for c in codes):
                    # local exit-code failure: other hosts' detectors only see
                    # heartbeat stalls, so fan the failure out explicitly to
                    # keep multi-host restart rounds in lockstep
                    detector.report_local_down()
                    break
                if detector.results.down_flag:
                    break
            log_event(f"monitored-round-{restarts}-down")
            for r in running:
                kill_group(r)
            # the relaunch must not start while a worker still holds its
            # card memory
            wait_group(running)
            log_event(f"monitored-round-{restarts}-exited")
            restarts += 1
            if restarts > MAX_RESTARTS:
                _log.error("giving up after %d restarts", MAX_RESTARTS)
                return 1
            # workers report *global* (cumulative) epoch numbers across
            # restarts, so the detector's min-epoch is cumulative too —
            # take the max, never add (adding double-counts on a second
            # failure and under-trains the job)
            done = _resolve_done_epochs(detector, self_host, main_host)
            epochs_done_total = max(epochs_done_total, done)
            if total_epochs is not None:
                remaining = max(total_epochs - epochs_done_total, 1)
                job.args = patch_args(args0, remaining, ns.n_epochs_flag)
            else:
                job.args = patch_args(args0, 1, ns.n_epochs_flag)
            _log.warning(
                "worker failure detected (%d epochs completed); restarting with %s",
                epochs_done_total, " ".join(job.args),
            )
    finally:
        detector.stop()
