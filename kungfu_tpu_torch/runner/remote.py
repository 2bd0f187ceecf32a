"""SSH-based multi-host launch tools (port of
``kungfu_tpu/runner/remote.py``).

Parity with the reference's ``kungfu-distribute`` (run one command on
every host of ``-H`` in parallel over SSH,
``cmd/kungfu-distribute/kungfu-distribute.go:76-88``) and ``kungfu-rrun``
(launch a full static job remotely: one runner per host, each told who it
is, ``cmd/kungfu-rrun/rrun.go:18-44`` +
``utils/runner/remote/remote.go:22-60``).  Where the reference opens
go-crypto SSH sessions, we drive the system ``ssh`` binary through the
same prefix-colored process runner the local launcher uses — TPU pods
are reached through plain SSH, and subprocess-based SSH keeps auth
(agents, ProxyCommand, OS config) out of scope.

``--ssh`` swaps the transport binary; tests point it at a local shim
that executes the command in-process, which is how "multi-host" launch
is tested without machines (the reference's docker-compose trick, one
level cheaper).
"""

from __future__ import annotations

import argparse
import shlex
import sys
from typing import List, Optional

from kungfu_tpu_torch.plan.hostspec import HostList, parse_host_list
from kungfu_tpu_torch.runner.proc import Proc, run_all
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("remote")


def ssh_proc(
    host: str,
    command: List[str],
    user: str = "",
    ssh_prog: str = "ssh",
    name: Optional[str] = None,
    log_dir: str = "",
) -> Proc:
    """One remote command as a Proc: ``ssh [user@]host -- <command>``."""
    target = f"{user}@{host}" if user else host
    script = " ".join(shlex.quote(a) for a in command)
    return Proc(
        name=name or host,
        prog=ssh_prog,
        args=[target, script],
        log_dir=log_dir,
    )


def remote_run_all(
    procs: List[Proc], quiet: bool = False, timeout: Optional[float] = None
) -> int:
    """Run all remote procs in parallel, fail-fast; 0 iff all succeeded."""
    codes = run_all(procs, quiet=quiet, timeout=timeout)
    failed = [p.name for p, c in zip(procs, codes) if c != 0]
    if failed:
        _log.error("%d remote tasks failed: %s", len(failed), ", ".join(failed))
        return 1
    return 0


# -- kf-distribute ---------------------------------------------------------

def main_distribute(argv: Optional[List[str]] = None) -> int:
    """Run the same command once on every host of -H (file push, setup,
    cleanup — the reference uses it to distribute binaries)."""
    p = argparse.ArgumentParser(
        prog="kf-distribute",
        description="run a command on every host of -H in parallel over SSH",
    )
    p.add_argument("-H", dest="hosts", required=True,
                   help="host spec list ip:slots[:public_addr],...")
    p.add_argument("-u", dest="user", default="", help="ssh user name")
    p.add_argument("-logdir", default="", help="per-host log files directory")
    p.add_argument("-timeout", type=float, default=0.0)
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("--ssh", dest="ssh_prog", default="ssh",
                   help="ssh-compatible transport binary")
    p.add_argument("prog")
    p.add_argument("args", nargs=argparse.REMAINDER)
    ns = p.parse_args(argv)

    hl = parse_host_list(ns.hosts)
    procs = [
        ssh_proc(
            h.public_addr or h.ip,
            [ns.prog] + ns.args,
            user=ns.user,
            ssh_prog=ns.ssh_prog,
            name=h.ip,
            log_dir=ns.logdir,
        )
        for h in hl.hosts
    ]
    _log.info("distributing %s to %d hosts", ns.prog, len(procs))
    return remote_run_all(procs, quiet=ns.quiet, timeout=ns.timeout or None)


# -- kf-rrun ---------------------------------------------------------------

def _runner_command(
    ns, hl: HostList, self_ip: str, python: str
) -> List[str]:
    cmd = [
        python, "-m", "kungfu_tpu_torch.runner.cli",
        "-np", str(ns.np),
        "-H", str(hl),
        "-self", self_ip,
        "-strategy", ns.strategy,
        "-port-range", ns.port_range,
    ]
    if getattr(ns, "device_strategy", ""):
        cmd += ["-device-strategy", ns.device_strategy]
    if ns.logdir:
        cmd += ["-logdir", ns.logdir]
    if ns.quiet:
        cmd += ["-q"]
    cmd += [ns.prog] + ns.args
    return cmd


def main_rrun(argv: Optional[List[str]] = None) -> int:
    """Launch a full static job: one launcher per host over SSH, each
    pinned to its own -self identity (reference ``kungfu-rrun``)."""
    p = argparse.ArgumentParser(
        prog="kf-rrun",
        description="launch a multi-host job: one kfrun per host over SSH",
    )
    p.add_argument("-np", type=int, required=True, help="total workers")
    p.add_argument("-H", dest="hosts", required=True,
                   help="host spec list ip:slots[:public_addr],...")
    p.add_argument("-strategy", default="AUTO")
    p.add_argument("-device-strategy", dest="device_strategy", default="",
                   help="initial device allreduce schedule for all hosts")
    p.add_argument("-port-range", dest="port_range", default="10000-11000")
    p.add_argument("-u", dest="user", default="", help="ssh user name")
    p.add_argument("-logdir", default="", help="remote per-worker log dir")
    p.add_argument("-timeout", type=float, default=0.0)
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("--ssh", dest="ssh_prog", default="ssh")
    p.add_argument("--python", default="python3",
                   help="python interpreter to invoke on the remote hosts")
    p.add_argument("prog")
    p.add_argument("args", nargs=argparse.REMAINDER)
    ns = p.parse_args(argv)

    hl = parse_host_list(ns.hosts)
    if ns.np > hl.cap():
        _log.error("-np %d exceeds host capacity %d", ns.np, hl.cap())
        return 1
    procs = [
        ssh_proc(
            h.public_addr or h.ip,
            _runner_command(ns, hl, h.ip, ns.python),
            user=ns.user,
            ssh_prog=ns.ssh_prog,
            name=h.ip,
            log_dir="",
        )
        for h in hl.hosts
    ]
    _log.info("launching %d workers across %d hosts", ns.np, len(procs))
    return remote_run_all(procs, quiet=False, timeout=ns.timeout or None)


if __name__ == "__main__":
    # ``python -m kungfu_tpu_torch.runner.remote rrun ...`` launches a
    # job; anything else distributes a command
    if sys.argv[1:2] == ["rrun"]:
        sys.exit(main_rrun(sys.argv[2:]))
    sys.exit(main_distribute())
