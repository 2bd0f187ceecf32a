"""Elastic watch-mode runner (port of ``kungfu_tpu/runner/watch.py``).

Parity with reference ``runner/watch.go:23-135`` + ``runner/handler.go``:
the runner daemon listens for ``"update"`` control messages carrying a
Stage (version + cluster JSON) from workers mid-resize, diffs the old/new
worker lists for *this host*, kills removed workers and spawns added ones
with the new bootstrap env (version-fenced).  The job ends when all local
workers have exited.  The runner's channel binds ``-self`` at the runner
port 38080 (``bind_own_host_channel``, wildcard fallback), and the
workers' ``Peer._notify_runners`` sends it the ``update`` stages.
"""

from __future__ import annotations

import json
import os
import queue
import time
import urllib.request
from typing import Dict, Optional, Set

from kungfu_tpu_torch.comm.host import ConnType, bind_own_host_channel
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.hostspec import DEFAULT_RUNNER_PORT
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.runner.job import Job
from kungfu_tpu_torch.runner.proc import kill_group, start_proc
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("watch")

#: natural-end grace window (seconds, ``KF_CONFIG_WATCH_GRACE``): how
#: long a runner whose local workers all exited cleanly waits for an
#: in-flight resize stage before concluding the job is over
WATCH_GRACE_ENV = "KF_CONFIG_WATCH_GRACE"
DEFAULT_WATCH_GRACE_S = 10.0


def _config_server_version(url: str, timeout: float = 3.0) -> Optional[int]:
    """The config server's current cluster version, or None when it
    cannot be reached (no server configured / transient outage)."""
    if not url:
        return None
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return int(json.loads(resp.read().decode())["version"])
    except (OSError, ValueError, KeyError):
        return None


def world_local_changes(old_local: Set[PeerID], new_local: Set[PeerID],
                        world_local: Optional[Set[PeerID]] = None):
    """The ``(removed, added)`` workers of this host for a stage that
    moves its workers from ``old_local`` to ``new_local``.  In a
    provisioned world (``world_local``: the host's world slots) in-world
    workers move between active and standby themselves, so the runner
    kills or spawns only slots outside the world (normally none)."""
    removed, added = old_local - new_local, new_local - old_local
    if world_local is not None:
        removed, added = removed - world_local, added - world_local
    return removed, added


def watch_run(ns, cluster: Cluster, job: Job) -> int:
    self_host = ns.self_host
    # bind THIS runner's address (wildcard fallback): compose-style local
    # clusters run one runner per loopback alias (127.0.0.<i>) on the
    # same machine, all on the runner port
    chan = bind_own_host_channel(PeerID(self_host, DEFAULT_RUNNER_PORT))
    stages: "queue.Queue[dict]" = queue.Queue()

    def on_control(name: str, payload: bytes, src: str):
        if name == "update":
            try:
                stages.put(json.loads(payload.decode()))
            except ValueError as e:
                _log.warning("bad update from %s: %s", src, e)
        elif name == "exit":
            stages.put({"exit": True})
        elif name == "done":
            # rank 0 finished cleanly: the job is over for every host,
            # including hosts holding no workers right now
            stages.put({"done": True})

    chan.on_control(on_control)

    running: Dict[PeerID, object] = {}
    killed: Set[PeerID] = set()
    version = 0
    seen_versions = {0}
    failures = 0
    idx = 0

    def spawn(worker: PeerID, cl: Cluster, v: int):
        nonlocal idx
        proc = job.new_proc(worker, cl, v)
        _log.info("spawning %s (v%d)", proc.name, v)
        running[worker] = start_proc(proc, idx, quiet=ns.quiet)
        idx += 1

    current = cluster
    device_world = job.world is not None
    initial = job.world if device_world else cluster.workers
    for w in initial.on_host(self_host):
        spawn(w, cluster, version)

    stop = False
    job_done = False
    natural_end_at = None
    try:
        while True:
            # poll exits
            for w, r in list(running.items()):
                code = r.popen.poll()
                if code is None:
                    continue
                del running[w]
                if w in killed:
                    killed.discard(w)
                    _log.info("worker %s terminated after removal", w)
                elif code != 0:
                    _log.error("worker %s exited %d", w, code)
                    failures += 1
                else:
                    _log.info("worker %s finished", w)
            if failures and running:
                for w, r in list(running.items()):
                    kill_group(r)
                    killed.add(w)
            if not running and stages.empty():
                # exit when: local workers failed (all killed above); the
                # job signalled completion; or the CURRENT cluster still
                # assigns this host workers and they all finished (the
                # pre-elastic natural end).  A host the schedule shrank to
                # zero must keep serving — a later stage may grow back.
                if failures or stop or job_done:
                    break
                if current.workers.on_host(self_host):
                    # natural end — but a shrink's detached workers can
                    # exit BEFORE rank 0's "update" for that stage reaches
                    # us (rank 0 may sit in compile/re-sync for a while
                    # before _notify_runners); give an in-flight stage a
                    # grace window, and when the window expires confirm
                    # against the config server: a version ahead of ours
                    # means a stage IS coming — keep serving, or this
                    # host is orphaned for every later re-grow
                    if natural_end_at is None:
                        grace = float(os.environ.get(
                            WATCH_GRACE_ENV, DEFAULT_WATCH_GRACE_S))
                        natural_end_at = time.monotonic() + grace
                    elif time.monotonic() >= natural_end_at:
                        # job.config_server carries the RESOLVED URL in
                        # builtin-config-server mode, where
                        # ns.config_server stays empty
                        cs_ver = _config_server_version(
                            getattr(job, "config_server", "")
                            or getattr(ns, "config_server", ""))
                        if cs_ver is not None and cs_ver != version:
                            _log.info(
                                "config server at v%d, we applied v%d — "
                                "stage in flight, extending grace",
                                cs_ver, version)
                            natural_end_at = None
                        else:
                            break
            else:
                natural_end_at = None
            # poll membership updates
            try:
                stage = stages.get(timeout=0.2)
            except queue.Empty:
                continue
            if stage.get("exit"):
                stop = True
                for w, r in list(running.items()):
                    kill_group(r)
                    killed.add(w)
                continue
            if stage.get("done"):
                job_done = True
                continue
            new_version = int(stage["version"])
            new_cluster = Cluster.from_json(json.dumps(stage["cluster"]))
            if new_version in seen_versions:
                # duplicate update for a known version: verify consistency
                # (reference handler.go:89-106 exits on inconsistency)
                if new_version == version and new_cluster.workers != current.workers:
                    _log.error("inconsistent update for version %d", new_version)
                    return 1
                continue
            seen_versions.add(new_version)
            _log.info(
                "stage v%d: %d -> %d workers", new_version, current.size(), new_cluster.size()
            )
            chan.set_token(new_version)
            old_local = set(current.workers.on_host(self_host))
            new_local = set(new_cluster.workers.on_host(self_host))
            removed, added = world_local_changes(
                old_local, new_local,
                set(job.world.on_host(self_host)) if device_world else None)
            for w in removed:
                r = running.get(w)
                if r is not None:
                    _log.info("killing removed worker %s", w)
                    kill_group(r)
                    killed.add(w)
            for w in sorted(added):
                try:
                    spawn(w, new_cluster, new_version)
                except ValueError as e:
                    # e.g. a grow that does not tile the pinned slices: an
                    # unspawnable worker must not take down the healthy job
                    _log.error("cannot spawn %s: %s", w, e)
            current, version = new_cluster, new_version
    finally:
        for w, r in list(running.items()):
            kill_group(r)
        if failures:
            # a runner idling with zero workers (shrunk-away host) has no
            # other way to learn the job died — rank 0 will never send
            # "done"; best-effort fan-out so peers don't hang
            me = PeerID(self_host, DEFAULT_RUNNER_PORT)
            for runner in current.runners:
                if runner == me:
                    continue
                try:
                    chan.send(runner, "exit", b"", ConnType.CONTROL, retries=1)
                except (ConnectionError, OSError):
                    pass
        chan.close()
    if failures:
        _log.error("%d worker(s) failed", failures)
        return 1
    return 0
