"""Failure-detection server.

Parity with the fork's monitor server
(``srcs/go/kungfu/runner/monitorserver/monitor.go``, documented in
``docs/monitor_proposal.md``):

* listens on ``<host>:7756`` for worker heartbeat signals
  (``begin``/``end``/``epoch``/``trainend`` per rank);
* a rank is flagged **down** when a batch ``begin`` has no matching
  ``end`` for ``stall_timeout`` seconds (default 10s, ``monitor.go:111``)
  — or when its heartbeats stop entirely;
* on detection, records ``min`` completed epoch across ranks (the restart
  point) and fans ``otherdown:<minEpoch>`` out to the other hosts'
  detectors so every MonitoredRun restarts in lockstep
  (``monitor.go:116-167``);
* ``trainend`` from all ranks → finish flag.

Consumed by the monitored runner's relaunch loop
(:mod:`kungfu_tpu_torch.runner.monitored`) and by
the quorum-loss escalation of :mod:`kungfu_tpu_torch.elastic.shrink`.

Copy of ``kungfu_tpu/monitor/detector.py`` with one addition:
``DetectorServer(port=0)`` binds a port the OS assigns and reports it
as :attr:`DetectorServer.port`, as ``ConfigServer(port=0)`` does.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("detector")

DEFAULT_DETECTOR_PORT = 7756  # reference monitor.go
DEFAULT_STALL_TIMEOUT_S = 10.0
#: allowance while a rank is known to be compiling (first-ever batch, or
#: an explicit ``grace`` signal after a resize re-jit).  SURVEY §7 hard
#: part: a 10 s batch-stall timeout cannot tell a 20-40 s first XLA
#: compile from a dead host — the reference never had to (CUDA kernels
#: launch immediately); on TPU the first step and every post-resize step
#: ARE multi-ten-second stalls on a healthy rank.
DEFAULT_COMPILE_GRACE_S = 120.0
CHECK_PERIOD_S = 1.0


@dataclass
class DetectorResults:
    down_flag: bool = False
    epoch_num: int = 0  # min completed epoch across ranks at detection time
    finish_flag: bool = False


@dataclass
class _RankState:
    last_begin: float = 0.0
    last_end: float = 0.0
    open_begin: bool = False
    epochs_done: int = 0
    finished: bool = False
    seen: bool = False
    first_seen: float = 0.0  # wall time of this incarnation's first signal
    batches_done: int = 0  # completed begin/end pairs
    grace_pending: bool = False  # a grace signal awaits its batch
    in_grace_batch: bool = False  # the current open batch is compile-covered


class DetectorServer:
    """One per runner host.  ``peer_hosts`` are the *other* runner hosts'
    detector addresses for the fan-out."""

    def __init__(
        self,
        expected_ranks: int,
        port: int = DEFAULT_DETECTOR_PORT,
        peer_hosts: Optional[List[str]] = None,
        stall_timeout: float = DEFAULT_STALL_TIMEOUT_S,
        compile_grace: float = DEFAULT_COMPILE_GRACE_S,
        host: str = "0.0.0.0",
        require_all_seen: bool = True,
    ):
        self.expected_ranks = expected_ranks
        self.port = port
        self.peer_hosts = peer_hosts or []
        self.stall_timeout = stall_timeout
        self.compile_grace = max(compile_grace, stall_timeout)
        self.require_all_seen = require_all_seen
        self.results = DetectorResults()
        self._ranks: Dict[int, _RankState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                _log.debug(fmt, *args)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                fanout = None
                try:
                    sig = json.loads(self.rfile.read(n).decode())
                    fanout = srv._on_signal(sig)
                    code = 200
                except (ValueError, KeyError) as e:
                    _log.warning("bad signal: %s", e)
                    code = 400
                self.send_response(code)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")
                if fanout is not None:
                    # after the response, without srv._lock held
                    srv._fanout(fanout)

            def do_GET(self):
                body = json.dumps(
                    {
                        "down": srv.results.down_flag,
                        "epoch": srv.results.epoch_num,
                        "finished": srv.results.finish_flag,
                    }
                ).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        # port 0: the OS assigned one; the fan-out and callers read it here
        self.port = self._server.server_address[1]
        self._threads: List[threading.Thread] = []

    # -- signal intake ---------------------------------------------------
    def _rank(self, r: int) -> _RankState:
        st = self._ranks.get(r)
        if st is None:
            st = self._ranks[r] = _RankState()
        return st

    def _on_signal(self, sig: dict) -> Optional[dict]:
        """Handle one signal; returns a fan-out payload for the caller to
        post AFTER releasing the lock (a blocked peer must never stall
        heartbeat intake)."""
        kind = sig["kind"]
        now = time.time()
        timeline.event("signal", kind, rank=sig.get("rank"),
                       epoch=sig.get("epoch"))
        with self._lock:
            if kind == "otherdown":
                # a failure report; epoch < 0 means the sender had no rank
                # state (non-main host, or a worker-side quorum-loss
                # escalation) — fall back to what this host knows
                already_down = self.results.down_flag
                self.results.down_flag = True
                epoch = int(sig.get("epoch", -1))
                if epoch < 0:
                    epoch = min((s.epochs_done for s in self._ranks.values()), default=0)
                self.results.epoch_num = epoch
                if sig.get("relay") or already_down:
                    # detector-to-detector relays stop here (one hop, no
                    # cascade), and an already-down round was fanned out
                    # when it started
                    return None
                # worker-originated report (monitor_report_down, the
                # quorum-loss escalation): this detector is the only one
                # that heard it, and once down_flag is set _check_once
                # stops scanning — without a relay the other hosts'
                # MonitoredRuns would never join the restart round
                return {"kind": "otherdown", "epoch": epoch, "relay": True}
            if kind == "otherfinish":
                self.results.finish_flag = True
                return None
            st = self._rank(int(sig["rank"]))
            if st.finished and kind in ("begin", "grace"):
                # a fresh incarnation reusing a finished rank id (restart
                # or rejoin): stale state would either skip monitoring
                # forever or judge its cold compile by the batch timeout
                st = self._ranks[int(sig["rank"])] = _RankState(
                    epochs_done=st.epochs_done
                )
            if not st.seen:
                st.first_seen = now
            st.seen = True
            if kind == "begin":
                st.last_begin, st.open_begin = now, True
                # anchor the grace window at the batch it covers — a
                # pending grace consumed here allows compile_grace FROM
                # THIS BEGIN, however long the announcement preceded it
                st.in_grace_batch = st.grace_pending
                st.grace_pending = False
            elif kind == "end":
                st.last_end, st.open_begin = now, False
                st.batches_done += 1
                st.in_grace_batch = False  # grace dies with its batch
            elif kind == "grace":
                # the worker announces an upcoming known-long stall (a
                # resize re-jit, or a fresh process about to cold-compile)
                st.grace_pending = True
            elif kind == "epoch":
                st.epochs_done = max(st.epochs_done, int(sig["epoch"]) + 1)
            elif kind == "trainend":
                st.finished = True
                if all(s.finished for s in self._ranks.values()) and (
                    len(self._ranks) >= self.expected_ranks or not self.require_all_seen
                ):
                    self.results.finish_flag = True
                    return {"kind": "otherfinish"}
            else:
                raise KeyError(f"unknown signal kind {kind!r}")
        return None

    # -- detection loop --------------------------------------------------
    def _check_once(self) -> None:
        now = time.time()
        fanout = None
        with self._lock:
            if self.results.down_flag or self.results.finish_flag:
                return
            for r, st in self._ranks.items():
                if st.finished:
                    continue
                # compile-aware allowance: the first-ever batch (cold
                # XLA compile, 20-40s on TPU) and any batch announced by
                # a grace signal (resize re-jit) get compile_grace
                # instead of the batch-stall timeout — a healthy TPU
                # rank's first step IS a multi-ten-second stall (SURVEY
                # §7 hard part: slow-compile vs dead-host).  The grace is
                # per-batch: it expires at that batch's `end`, so a rank
                # that compiles fast and then dies is caught on the
                # normal clock.
                compiling = st.batches_done == 0 or st.in_grace_batch
                allow = self.compile_grace if compiling else self.stall_timeout
                stalled_in_batch = st.open_begin and now - st.last_begin > allow
                # a rank that goes silent *between* batches (hung data
                # loader, dead host) has open_begin False — give it a
                # longer grace (3x) on total heartbeat silence
                last_seen = max(st.last_begin, st.last_end)
                silent = (
                    not st.open_begin
                    and last_seen > 0
                    and now - last_seen > max(3 * self.stall_timeout, allow)
                )
                # a rank that only ever signalled grace/epoch and then
                # died has last_begin == last_end == 0, so the
                # last_seen > 0 guard above never fires — "seen but never
                # began a batch within the compile allowance" is a stall
                # too (the compile window is exactly how long a healthy
                # rank may legitimately take to reach its first begin)
                never_began = (
                    last_seen == 0
                    and st.first_seen > 0
                    and now - st.first_seen > self.compile_grace
                )
                if stalled_in_batch or silent or never_began:
                    min_epoch = min(
                        (s.epochs_done for s in self._ranks.values()), default=0
                    )
                    why, since = (
                        ("begin without end", st.last_begin) if stalled_in_batch
                        else ("heartbeat silence", last_seen) if silent
                        else ("signalled but never began a batch", st.first_seen)
                    )
                    _log.warning(
                        "rank %d down (%s for %.0fs); restart epoch %d",
                        r, why, now - since, min_epoch,
                    )
                    timeline.event("down", f"rank{r}", rank=r, why=why,
                                   epoch=min_epoch)
                    self.results.down_flag = True
                    self.results.epoch_num = min_epoch
                    fanout = {"kind": "otherdown", "epoch": min_epoch,
                              "relay": True}
                    break
        if fanout is not None:
            self._fanout(fanout)

    def _fanout(self, sig: dict, attempts: int = 3) -> None:
        """Post to every peer host's detector, outside any lock; a few
        retries with backoff — a lost fan-out strands the receiving host in
        the old round forever, so it is worth insisting.

        One thread per host: the hosts most worth telling about a failure
        are exactly the ones most likely to contain it, so a sequential
        loop head-of-line-blocks every healthy host's restart behind the
        dead host's full retry ladder (observed: ~10 s of added restart
        skew per unreachable predecessor in the list)."""
        from kungfu_tpu_torch import chaos

        ctl = chaos.controller_for(None)
        threads = []
        for host in self.peer_hosts:
            if ctl is not None and ctl.drop_fanout(host):
                continue  # injected fan-out loss (drop_fanout clause)
            t = threading.Thread(
                target=self._fanout_one, args=(host, sig, attempts), daemon=True
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    def _fanout_one(self, host: str, sig: dict, attempts: int) -> None:
        for i in range(attempts):
            try:
                post_signal(host, self.port, sig, timeout=3)
                return
            except OSError as e:
                if i == attempts - 1:
                    _log.warning(
                        "fanout to %s failed after %d attempts: %s", host, attempts, e
                    )
                else:
                    time.sleep(0.5 * (i + 1))

    def _loop(self):
        while not self._stop.wait(CHECK_PERIOD_S):
            self._check_once()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "DetectorServer":
        t1 = threading.Thread(target=self._server.serve_forever, daemon=True)
        t2 = threading.Thread(target=self._loop, daemon=True)
        t1.start()
        t2.start()
        self._threads = [t1, t2]
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()

    def report_local_down(self) -> None:
        """Mark a locally-observed failure (e.g. worker process exit) and
        fan it out to the other hosts' detectors so every MonitoredRun
        restarts in the same round.  A host with no rank state (only the
        main host receives heartbeats) sends epoch=-1 = "unknown" so
        receivers fall back to their own accounting instead of restarting
        from epoch 0."""
        with self._lock:
            if self.results.down_flag:
                return
            if self._ranks:
                min_epoch = min(s.epochs_done for s in self._ranks.values())
            else:
                min_epoch = -1
            self.results.down_flag = True
            self.results.epoch_num = max(min_epoch, 0)
        timeline.event("down", "local", epoch=min_epoch)
        self._fanout({"kind": "otherdown", "epoch": min_epoch, "relay": True})

    def min_epoch(self) -> int:
        """Min completed epochs across ranks seen so far (restart point for
        failures detected via process exit rather than heartbeat stall)."""
        with self._lock:
            return min((s.epochs_done for s in self._ranks.values()), default=0)

    def reset(self, expected_ranks: Optional[int] = None) -> None:
        """Clear state for a relaunch round."""
        with self._lock:
            self._ranks.clear()
            self.results = DetectorResults()
            if expected_ranks is not None:
                self.expected_ranks = expected_ranks


def query_detector(host: str, port: int = DEFAULT_DETECTOR_PORT, timeout: float = 3.0) -> dict:
    """GET a detector's current results — used by non-main hosts to fetch
    the authoritative restart epoch from the main host (the only detector
    that receives worker heartbeats)."""
    with urllib.request.urlopen(f"http://{host}:{port}/", timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def post_signal(host: str, port: int, sig: dict, timeout: float = 5.0) -> None:
    req = urllib.request.Request(
        f"http://{host}:{port}/signal",
        data=json.dumps(sig).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        resp.read()
