"""Worker processes: specs, colored prefix streaming and log files
(port of ``kungfu_tpu/runner/proc.py``).

A :class:`Proc` is a command line with its env on top of the launcher's;
:func:`start_proc` runs it in a process group of its own and streams its
output line by line with a colored ``[name]`` prefix, into
``<log_dir>/<name>.{stdout,stderr}.log`` as well; :func:`run_all` waits
for a group and, fail-fast, kills the rest when one worker fails.

One addition to the reference: :func:`wait_group` waits for a killed
group's exit and escalates to ``SIGKILL`` after a grace, so that a
relaunch never starts while a worker still holds its card memory (and
raises if even ``SIGKILL`` does not end a worker).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

_COLORS = [32, 33, 34, 35, 36, 91, 92, 93, 94, 95]


@dataclass
class Proc:
    name: str
    prog: str
    args: List[str]
    envs: Dict[str, str] = field(default_factory=dict)
    log_dir: str = ""

    def cmdline(self) -> List[str]:
        return [self.prog] + list(self.args)


class _Running:
    def __init__(self, proc: Proc, popen: subprocess.Popen, pumps):
        self.proc = proc
        self.popen = popen
        self.pumps = pumps


def _pump(stream, sink, prefix: str, color: int, logfile):
    for raw in iter(stream.readline, b""):
        line = raw.decode(errors="replace")
        sink.write(f"\x1b[{color}m[{prefix}]\x1b[0m {line}")
        sink.flush()
        if logfile:
            logfile.write(line)
            logfile.flush()
    stream.close()
    if logfile:
        logfile.close()


def start_proc(proc: Proc, index: int = 0, quiet: bool = False) -> _Running:
    env = dict(os.environ)
    env.update(proc.envs)
    stdout_log = stderr_log = None
    if proc.log_dir:
        os.makedirs(proc.log_dir, exist_ok=True)
        stdout_log = open(os.path.join(proc.log_dir, f"{proc.name}.stdout.log"), "w")
        stderr_log = open(os.path.join(proc.log_dir, f"{proc.name}.stderr.log"), "w")
    popen = subprocess.Popen(
        proc.cmdline(),
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        start_new_session=True,
    )
    color = _COLORS[index % len(_COLORS)]
    pumps = []
    if quiet:
        sink_out = open(os.devnull, "w")
        sink_err = sink_out
    else:
        sink_out, sink_err = sys.stdout, sys.stderr
    for stream, sink, logf in (
        (popen.stdout, sink_out, stdout_log),
        (popen.stderr, sink_err, stderr_log),
    ):
        t = threading.Thread(
            target=_pump, args=(stream, sink, proc.name, color, logf), daemon=True
        )
        t.start()
        pumps.append(t)
    return _Running(proc, popen, pumps)


def kill_group(running: _Running, sig: int = signal.SIGTERM) -> None:
    """Signal the worker's whole process group (``SIGTERM`` ends a worker
    blocked inside the native transport too: Python installs no handler
    for it)."""
    try:
        os.killpg(os.getpgid(running.popen.pid), sig)
    except (ProcessLookupError, PermissionError):
        pass


#: seconds a worker has to be reaped after ``SIGKILL``
KILL_REAP_S = 10.0


def wait_group(running: Sequence[_Running], grace: float = 10.0) -> List[int]:
    """Wait for every worker of ``running`` to exit, sending ``SIGKILL``
    to those still alive after ``grace`` seconds; their exit codes.

    A worker still alive :data:`KILL_REAP_S` seconds after ``SIGKILL`` is
    stuck in the kernel (uninterruptible sleep) and may still hold its
    card: that raises ``RuntimeError`` rather than hang the launcher or
    relaunch beside it."""
    deadline = time.monotonic() + grace
    for r in running:
        try:
            r.popen.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            kill_group(r, signal.SIGKILL)
            try:
                r.popen.wait(timeout=KILL_REAP_S)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"worker {r.proc.name} (pid {r.popen.pid}) did not exit "
                    f"{KILL_REAP_S} s after SIGKILL") from None
    return [r.popen.returncode for r in running]


def run_all(procs: Sequence[Proc], quiet: bool = False, timeout: Optional[float] = None,
            fail_fast: bool = True) -> List[int]:
    """Run all procs; on any failure, kill the rest (fail-fast like the
    reference runner).  Returns exit codes in proc order.

    ``fail_fast=False`` (the shrink-to-survivors supervisor policy,
    ``kfrun -tolerate-failures``): a worker's death does NOT take the
    group down — the survivors are expected to exclude the dead peer
    in-flight (elastic/shrink.py) and run to completion."""
    running = [start_proc(p, i, quiet=quiet) for i, p in enumerate(procs)]
    codes: List[Optional[int]] = [None] * len(running)
    try:
        deadline = None if timeout is None else (timeout + time.time())
        pending = set(range(len(running)))
        while pending:
            for i in list(pending):
                r = running[i]
                try:
                    codes[i] = r.popen.wait(timeout=0.2)
                    pending.discard(i)
                    if codes[i] != 0 and fail_fast:
                        for j in pending:
                            kill_group(running[j])
                except subprocess.TimeoutExpired:
                    pass
            if deadline is not None and time.time() > deadline and pending:
                for j in pending:
                    kill_group(running[j])
                raise TimeoutError(f"procs {sorted(pending)} still running after {timeout}s")
    finally:
        for r in running:
            if r.popen.poll() is None:
                kill_group(r)
        for r in running:
            for t in r.pumps:
                t.join(timeout=2)
    return [c if c is not None else -1 for c in codes]
