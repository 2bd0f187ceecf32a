#!/usr/bin/env python3
"""Compose-style elastic cluster harness for the PyTorch/CUDA port
(``kungfu_tpu_torch``), the counterpart of ``scripts/cluster.py``.

Each simulated host is a loopback alias (``127.0.0.<i>``) running its own
watch-mode runner (``python -m kungfu_tpu_torch -w``); the config server
is an EXTERNAL process (``python -m kungfu_tpu_torch.elastic.configserver``),
seeded through ``/reset``; the workers train the MNIST SLP
(``kungfu_tpu_torch/examples/elastic_mnist.py``, synthetic data) under an
elastic schedule that must grow the job onto a host that started with no
workers and shrink away from it again.

    python scripts/cluster_torch.py                    # 2 hosts x 2 slots, 2:3,4:3,2:3, on the card
    python scripts/cluster_torch.py --backend cpu      # the workers on the host
    python scripts/cluster_torch.py --hosts 3 --schedule 2:2,6:2,3:2

Where it differs from ``scripts/cluster.py``: ``--config-port`` 0, the
default, lets the server bind a port of its own and reports it in its
log; ``--backend`` (``gpu``, the default, or ``cpu``) is the launcher's
``-backend``; the runners' port range is found free on every alias; every child runs in a session of its own and carries
``CLUSTER_TORCH_TAG`` in its environment, so that cleanup ends every
process of the cluster, the workers (which the runners start in sessions
of their own) included.

Exit 0 = every runner exited clean and every scheduled size was
observed; 1 = a runner failed; 2 = the config server did not come up;
3 = a runner timed out; 4 = a scheduled size was not observed.  The last
line of stdout is a JSON object with ``ok``, ``hosts``, ``schedule``,
``sizes_observed`` and ``logdir``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import uuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
#: the worker program, by path: a ``-m`` after the launcher's positional
#: program can be read as an abbreviation of its ``-monitor`` option
WORKER = os.path.join("kungfu_tpu_torch", "examples", "elastic_mnist.py")
#: every process of one cluster carries this variable, set to the run's
#: tag, so that cleanup can find the workers in their own sessions
TAG_ENV = "CLUSTER_TORCH_TAG"
#: seconds between SIGTERM and SIGKILL, and after SIGKILL, in cleanup
KILL_GRACE_S = 10.0

_LISTEN = re.compile(r"config server listening on [^:\s]+:(\d+)")
_SIZES = re.compile(r"sizes seen \[([\d, ]+)\]")
_START = re.compile(r"watching (\S+): (\d+) local worker\(s\) at v(\d+)")
_STAGE = re.compile(r"stage v(\d+): (\d+) -> (\d+) workers "
                    r"\((\d+) -> (\d+) on (\S+)\)")


def host_spec(hosts: int, slots: int) -> str:
    return ",".join(f"127.0.0.{i + 1}:{slots}" for i in range(hosts))


def initial_cluster_json(spec: str, np_: int,
                         port_range=(10000, 11000)) -> str:
    """The cluster the harness seeds the config server with (``/reset``):
    the runners of ``spec`` and the first ``np_`` workers over
    ``port_range``, as the runners themselves build it."""
    from kungfu_tpu_torch.plan.cluster import Cluster
    from kungfu_tpu_torch.plan.hostspec import HostList

    hl = HostList.parse(spec)
    return Cluster(hl.gen_runner_list(),
                   hl.gen_peer_list(np_, port_range)).to_json()


def free_port_range(hosts, n: int) -> int:
    """A base port whose next ``n`` ports were free on every host of
    ``hosts`` when probed: above the fixed ports the reference's tests
    bind (27760, 28400 and up), below the ephemeral range."""
    for _ in range(200):
        base = random.randrange(30000, 32768 - n)
        socks = []
        try:
            for host in hosts:
                for p in range(base, base + n):
                    s = socket.socket()
                    socks.append(s)
                    s.bind((host, p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise OSError(f"no range of {n} free ports on {list(hosts)}")


def sizes_observed(logdir: str) -> list:
    """Every cluster size a worker reported (``sizes seen [...]``) in the
    ``.log`` files under ``logdir``."""
    seen = set()
    for root, _, files in os.walk(logdir):
        for f in files:
            if f.endswith(".log"):
                with open(os.path.join(root, f), errors="replace") as fh:
                    for m in _SIZES.findall(fh.read()):
                        seen.update(int(x) for x in m.split(","))
    return sorted(seen)


def local_workers(runner_log: str) -> list:
    """``[(version, workers on this host)]`` from one watch runner's log:
    the count it started with, then the count after each stage."""
    out = [(int(v), int(n)) for _, n, v in _START.findall(runner_log)]
    out += [(int(v), int(new)) for v, _, _, _, new, _
            in _STAGE.findall(runner_log)]
    return out


def tagged_pids(tag: str) -> list:
    """The live processes whose environment holds ``TAG_ENV=tag`` (this
    one excepted); an exited process awaiting its parent's wait has an
    empty environment and is not listed."""
    needle = f"\0{TAG_ENV}={tag}\0".encode()
    out = []
    try:
        names = os.listdir("/proc")
    except OSError:
        return out
    for name in names:
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                env = b"\0" + f.read()
        except OSError:
            continue
        if needle in env:
            out.append(int(name))
    return out


def process_groups(pids) -> set:
    """The process groups of those of ``pids`` still alive."""
    out = set()
    for pid in pids:
        try:
            out.add(os.getpgid(pid))
        except ProcessLookupError:
            pass
    return out


def _signal_groups(groups, sig) -> None:
    for g in groups:
        try:
            os.killpg(g, sig)
        except (ProcessLookupError, PermissionError):
            pass


def stop_cluster(procs, tag: str, grace: float = KILL_GRACE_S) -> None:
    """End every process of the cluster: the process groups of ``procs``
    (the harness's children) and of every process tagged ``tag``, by
    SIGTERM, then SIGKILL after ``grace`` seconds; the children reaped.
    Bounded: returns after at most about ``2 * grace`` seconds."""
    groups = {p.pid for p in procs if p.poll() is None}
    groups |= process_groups(tagged_pids(tag))
    _signal_groups(groups, signal.SIGTERM)
    for sig in (signal.SIGKILL, None):
        deadline = time.monotonic() + grace
        while True:
            alive = [p.pid for p in procs if p.poll() is None]
            tagged = tagged_pids(tag)
            if not alive and not tagged:
                return
            if time.monotonic() >= deadline:
                break
            time.sleep(0.1)
        if sig is not None:
            _signal_groups(groups | set(alive) | process_groups(tagged), sig)


def _wait_for_server(proc, log_path: str, timeout: float = 30.0):
    """The config server's bound port, read from its log, once ``/get``
    answers; None if it exits or does not come up in ``timeout`` s."""
    deadline = time.monotonic() + timeout
    port = None
    while time.monotonic() < deadline and proc.poll() is None:
        if port is None:
            with open(log_path, errors="replace") as f:
                m = _LISTEN.search(f.read())
            port = int(m.group(1)) if m else None
        if port is not None:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/get",
                                       timeout=1)
                return port
            except urllib.error.HTTPError:
                return port  # 404 "no cluster" still means the server is up
            except OSError:
                pass
        time.sleep(0.2 * (0.5 + random.random()))  # jittered
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2,
                    help="simulated hosts (loopback aliases 127.0.0.<i>)")
    ap.add_argument("--slots-per-host", type=int, default=2)
    ap.add_argument("--np", type=int, default=2, help="initial worker count")
    ap.add_argument("--schedule", default="2:3,4:3,2:3",
                    help="size:steps stages (examples/elastic_mnist.py)")
    ap.add_argument("--config-port", type=int, default=0,
                    help="0: a port the server binds and reports")
    ap.add_argument("--logdir", default="")
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="the launcher's -backend: the card or the host")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    spec = host_spec(ns.hosts, ns.slots_per_host)
    hosts = [f"127.0.0.{i + 1}" for i in range(ns.hosts)]
    logdir = os.path.abspath(ns.logdir or tempfile.mkdtemp(
        prefix="kf-cluster-"))
    os.makedirs(logdir, exist_ok=True)
    base = free_port_range(hosts, ns.slots_per_host)
    port_range = (base, base + ns.slots_per_host)
    tag = os.environ.get(TAG_ENV) or uuid.uuid4().hex
    env = dict(os.environ, **{TAG_ENV: tag})
    env.pop("JAX_PLATFORMS", None)  # the workers' backend is -backend's
    procs = []

    def start(cmd, log_name):
        with open(os.path.join(logdir, log_name), "w") as log:
            p = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                 stderr=subprocess.STDOUT, env=env,
                                 start_new_session=True)
        procs.append(p)
        return p

    rc = 0
    try:
        # 1. the EXTERNAL config server, on a port of its own
        srv_log = "config-server.log"
        srv = start([sys.executable, "-m",
                     "kungfu_tpu_torch.elastic.configserver", "-host",
                     "127.0.0.1", "-port", str(ns.config_port)], srv_log)
        # built while the server starts (both import the package)
        seed = initial_cluster_json(spec, ns.np, port_range)
        port = _wait_for_server(srv, os.path.join(logdir, srv_log))
        if port is None:
            print("config server did not come up", file=sys.stderr)
            rc = 2
        else:
            url = f"http://127.0.0.1:{port}"
            # 2. seed the initial cluster (compose does this with a reset
            #    job)
            req = urllib.request.Request(url + "/reset", method="POST",
                                         data=seed.encode())
            urllib.request.urlopen(req, timeout=5).read()
            # 3. one watch-mode runner per host, all on the external server
            runners = [(h, start(
                [sys.executable, "-m", "kungfu_tpu_torch", "-w", "-np",
                 str(ns.np), "-H", spec, "-self", h, "-config-server",
                 url + "/get", "-backend", ns.backend, "-logdir",
                 os.path.join(logdir, f"workers-{h}"), "-port-range",
                 f"{port_range[0]}-{port_range[1]}", sys.executable, WORKER,
                 "--schedule", ns.schedule], f"runner-{h}.log"))
                for h in hosts]
            # 4. wait for the runners; rank 0 proposes each stage through
            #    the config server
            deadline = time.monotonic() + ns.timeout
            for h, p in runners:
                try:
                    code = p.wait(max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    print(f"runner {h} timed out", file=sys.stderr)
                    rc = 3
                    break
                if code != 0:
                    print(f"runner {h} exited {code}", file=sys.stderr)
                    rc = 1
            try:
                urllib.request.urlopen(url + "/stop", timeout=5)
            except OSError:
                pass
    finally:
        stop_cluster(procs, tag)

    # 5. every scheduled size must have been reached (worker logs)
    wanted = sorted({int(s.split(":")[0]) for s in ns.schedule.split(",")})
    seen = sizes_observed(logdir)
    if rc == 0 and not set(wanted) <= set(seen):
        print(f"scheduled sizes {wanted} not all observed: {seen}",
              file=sys.stderr)
        rc = 4
    print(json.dumps({
        "ok": rc == 0, "hosts": ns.hosts, "schedule": ns.schedule,
        "sizes_observed": seen, "logdir": logdir,
    }))
    if rc == 0 and not ns.logdir:
        shutil.rmtree(logdir, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
