"""Request router and serving workers over the host channel (port of
``kungfu_tpu/serve/router.py``).

A serving deployment is a :class:`~kungfu_tpu_torch.peer.Peer` world:
each serving rank runs a :class:`ServeWorker` (one
:class:`~kungfu_tpu_torch.serve.engine.InferenceEngine`, a channel
handler and a load-scaled response-send pool), and one rank runs the
:class:`ServeRouter` (admission, dispatch and the serving rung of the
fault-tolerance ladder).

Wire protocol: PEER_TO_PEER frames on the host channel, every name under
the ``req.srv`` prefix the blob store's p2p handler skips; the JSON
bodies are the reference's byte for byte, so a port worker serves a
reference router and the other way round.

* ``req.srv.<rid>``  router -> worker: ``{rid, prompt, committed,
  max_new, att, tc}``; ``committed`` is non-empty only on replay;
* ``req.srvp.<rid>`` worker -> router: progress, the tokens generated so
  far, sent every ``KF_SERVE_COMMIT_EVERY`` decode positions (plus an
  empty receipt and a keepalive every 0.5 s).  A progress frame COMMITS
  those tokens: after the worker dies, replay restarts from them;
* ``req.srvc.<rid>`` worker -> router: completion (tokens and timings).

Admission is FCFS with a bounded accepted set (``KF_SERVE_QUEUE_DEPTH``);
past it :class:`~kungfu_tpu_torch.comm.faults.ServeOverloadError`
rejects at once.  Dispatch is least-outstanding among live workers.

Failure ladder:

1. a send failure toward a worker, or ``strike_limit`` consecutive
   progress-deadline expiries, declares it dead;
2. with a :class:`~kungfu_tpu_torch.elastic.slices.SliceTopology`, the
   dead set expands to slice grain as in training: a degraded slice is
   excluded whole;
3. every in-flight request of the excluded ranks re-admits on a
   survivor, replaying from its last committed decode position (greedy
   decode re-derives the same continuation);
4. zero live workers left gives the typed
   :class:`~kungfu_tpu_torch.comm.faults.RequestLostError` carrying the
   committed tokens, never a hang.

An engine that raises (an injected death or a real fault) marks its
worker dead and closes its peer, so dispatches to it fail fast.

Where the port differs from the reference: a running worker owns its
rank's ``kf_kv_cache_bytes`` in the rank reporter's snapshots
(:func:`~kungfu_tpu_torch.monitor.aggregator.own_gauge`), so peers of
one process, which share one registry, each report their own pool; a
process of one rank reports what the reference's does.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

from kungfu_tpu_torch.chaos import inject as chaos_inject
from kungfu_tpu_torch.comm.faults import (RequestLostError, ServeOverloadError)
from kungfu_tpu_torch.comm.host import (SERVE_NAME_PREFIX, ConnType,
                                  host_pool_size)
from kungfu_tpu_torch.elastic.slices import SliceTopology, slice_verdict
from kungfu_tpu_torch.monitor import aggregator, timeline
from kungfu_tpu_torch.serve import kvcache, slo
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("serve-router")

#: reserved name space on the host channel — ONE constant, defined in
#: comm/host.py so the blob store's skip and this module's frame names
#: can never drift apart
RESERVED_PREFIX = SERVE_NAME_PREFIX
REQ_PREFIX = RESERVED_PREFIX + "."
PROG_PREFIX = RESERVED_PREFIX + "p."
DONE_PREFIX = RESERVED_PREFIX + "c."

DEFAULT_QUEUE_DEPTH = 64
DEFAULT_COMMIT_EVERY = 8
DEFAULT_DEADLINE_S = 60.0
#: bounded retries on serve-plane sends: a dead worker must fail the
#: send in seconds (and enter the dead-worker ladder), not ride the
#: full 500 x 200 ms connect ladder of the gradient path
SEND_RETRIES = 3

_rid_counter = itertools.count()


def remaining_budget(max_new: int, committed: Sequence[int],
                     eos_id: Optional[int]) -> int:
    """New-token budget left for a (re)dispatched request.  A committed
    tail already ending in EOS is a FINISHED generation — the engine
    stops at EOS, so it can only ever be the last committed token — and
    replaying it with leftover budget would decode past EOS and diverge
    from the failure-free run's output."""
    if eos_id is not None and committed and committed[-1] == eos_id:
        return 0
    return int(max_new) - len(committed)


# -- worker side ------------------------------------------------------------
class ServeWorker:
    """One serving rank: engine loop + request handler + send pool."""

    def __init__(self, peer, engine, *, commit_every: Optional[int] = None,
                 idle_wait_s: float = 0.02, step_period_s: float = 0.0):
        self.peer = peer
        self.engine = engine
        self.commit_every = int(
            commit_every if commit_every is not None
            else envs.parse_int_env(envs.SERVE_COMMIT_EVERY,
                                    DEFAULT_COMMIT_EVERY))
        self._idle_wait_s = idle_wait_s
        #: floor on the decode-iteration cadence.  0 = run flat out;
        #: the CPU-mesh SLO bench pins it so per-token latency models a
        #: heavier model instead of the toy's sub-ms steps — latency
        #: STRUCTURE (queueing, replay, recovery), not raw speed, is
        #: what that row measures
        self.step_period_s = float(step_period_s)
        self._lock = threading.Lock()
        self._src: Dict[str, str] = {}        # rid -> requester peer id
        self._toks: Dict[str, List[int]] = {}  # rid -> generated tokens
        #: rid -> dispatch attempt currently owning it.  The engine runs
        #: under "rid#att" ids, so a superseded attempt's surviving run
        #: (cancel can miss one mid-admission) emits events that simply
        #: fail the attempt check instead of interleaving tokens
        self._att: Dict[str, int] = {}
        self._stop = threading.Event()
        self.dead = False                      # set by an injected death
        self._sendq: "queue.Queue" = queue.Queue()
        n = host_pool_size(peer.size(), pool="serve")
        self._senders = [
            threading.Thread(target=self._send_loop,
                             name=f"kf-serve-send-{i}", daemon=True)
            for i in range(n)
        ]
        self._thread = threading.Thread(
            target=self._loop, name=f"kf-serve-w{peer.chaos_rank()}",
            daemon=True)
        self._kv_gauge = lambda: self.engine.pool.footprint_bytes

    def start(self) -> "ServeWorker":
        if self.peer.channel is None:
            raise RuntimeError("serving needs a started multi-peer world")
        self.peer.channel.on_p2p_request(self._on_frame)
        aggregator.own_gauge(kvcache.GAUGE, self.peer.chaos_rank(),
                             self._kv_gauge)
        for t in self._senders:
            t.start()
        self._thread.start()
        return self

    # -- channel receive path (must stay fast: hand off and return) ------
    def _on_frame(self, name: str, payload: bytes, src: str) -> None:
        # note: progress/completion names ("req.srvp."/"req.srvc.") do
        # not match the request prefix "req.srv." — the dot disambiguates
        if not name.startswith(REQ_PREFIX) or self._stop.is_set():
            return
        try:
            req = json.loads(payload.decode())
            rid = req["rid"]
            prompt = [int(t) for t in req["prompt"]]
            committed = [int(t) for t in req.get("committed") or []]
            max_new = int(req["max_new"])
            att = int(req.get("att", 0))
        except (ValueError, KeyError) as e:
            _log.warning("bad serve request from %s: %s", src, e)
            return
        # kf-xray: the frame's meta carries the router's trace context;
        # this worker's handling mark and the engine's prefill span join
        # that trace (malformed/absent tc = unlinked, never an error)
        trace, parent = timeline.parse_trace_context(req.get("tc"))
        if timeline.enabled():
            timeline.event("serve", "request-recv",
                           rank=self.peer.chaos_rank(), rid=rid, att=att,
                           **timeline.context_attrs(trace, parent))
        ctl = chaos_inject.controller_for(self.peer.chaos_rank())
        if ctl is not None and ctl.on_serve_request(rid):
            return  # injected frame loss: the router's deadline re-admits
        with self._lock:
            prev = self._att.get(rid)
            self._att[rid] = att
            self._src[rid] = src
            # this worker's OWN progress only — the router prepends the
            # committed prefix itself (sending it back would double-count
            # on the next replay)
            self._toks[rid] = []
        # receipt ack (an empty progress frame): the router's deadline
        # measures LIVENESS, not token rate — a request parked in this
        # worker's admission queue behind a backlog must not read as a
        # dead worker (that false strike is how one real failure
        # cascades into killing the healthy rest of the fleet)
        self._queue_progress(rid, [], None)
        if prev is not None and prev != att:
            # a re-dispatch of a request we already hold (the router's
            # deadline fired on a slow, not dead, first attempt): drop
            # the stale run.  Best-effort — a run mid-admission escapes
            # the cancel, but its events carry the OLD attempt id and
            # are discarded by the attempt check in _loop
            self.engine.cancel(f"{rid}#{prev}")
        remaining = remaining_budget(max_new, committed, self.engine.eos_id)
        if remaining <= 0:
            # replay raced completion (budget spent, or the committed
            # tail already ends in EOS): nothing left to generate
            self._queue_done(rid, [], ok=True, ttft_s=0.0,
                             queue_s=0.0, reused_tokens=0, computed_tokens=0)
            return
        try:
            self.engine.submit(f"{rid}#{att}", prompt + committed, remaining,
                               trace=timeline.format_trace_context(trace,
                                                                   parent))
        except ValueError as e:
            self._queue_done(rid, [], ok=False, error=str(e))

    # -- response sends (load-scaled pool, never the engine loop) --------
    def _send_loop(self) -> None:
        # sentinel/stop-flag-terminated worker loop, not a retry loop:
        # each queue item is sent once (channel.send owns its bounded
        # retries) and delivery failures are dropped with a warning
        while True:  # kflint: allow(retry-discipline)
            try:
                item = self._sendq.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            dst, name, body = item
            try:
                from kungfu_tpu_torch.plan.peer import parse_peer_id

                self.peer.channel.send(parse_peer_id(dst), name, body,
                                       ConnType.PEER_TO_PEER,
                                       retries=SEND_RETRIES)
            except (OSError, ConnectionError) as e:
                _log.warning("cannot answer %s: %s", dst, e)

    def _queue_progress(self, rid: str, tokens: List[int],
                        ttft_s: Optional[float]) -> None:
        with self._lock:
            src = self._src.get(rid)
            att = self._att.get(rid, 0)
        if src is None:
            return
        body = json.dumps({"rid": rid, "att": att, "tokens": tokens,
                           "ttft_s": ttft_s}).encode()
        self._sendq.put((src, f"{PROG_PREFIX}{rid}", body))

    def _queue_done(self, rid: str, tokens: List[int], ok: bool,
                    error: str = "", **stats) -> None:
        with self._lock:
            src = self._src.pop(rid, None)
            att = self._att.pop(rid, 0)
            self._toks.pop(rid, None)
        if src is None:
            return
        body = json.dumps({"rid": rid, "att": att, "tokens": tokens,
                           "ok": ok, "error": error, **stats}).encode()
        self._sendq.put((src, f"{DONE_PREFIX}{rid}", body))

    #: wall period between keepalive progress frames for every tracked
    #: request (queued or decoding): liveness proof for the router's
    #: deadline ladder, decoupled from token rate
    KEEPALIVE_S = 0.5

    def _keepalive(self) -> None:
        with self._lock:
            snap = {rid: list(toks) for rid, toks in self._toks.items()}
        for rid, toks in snap.items():
            self._queue_progress(rid, toks, None)

    # -- the engine loop --------------------------------------------------
    def _loop(self) -> None:
        it = 0
        last_beat = time.perf_counter()
        while not self._stop.is_set():
            now = time.perf_counter()
            if now - last_beat >= self.KEEPALIVE_S:
                last_beat = now
                self._keepalive()
            if not self.engine.wait_for_work(self._idle_wait_s):
                continue
            it += 1
            t_step = time.perf_counter()
            try:
                # the serving analog of the training-step boundary: the
                # chaos `die`/`die_slice` step triggers fire here, so a
                # worker kill lands at a deterministic decode iteration
                from kungfu_tpu_torch import chaos

                chaos.note_step(self.peer.chaos_rank(), it)
                events = self.engine.step()
            except Exception as e:  # noqa: BLE001 — no silent wedge
                # injected deaths die on purpose; anything else must
                # look like a death too, not a zombie: a silently-dead
                # loop thread would leave the channel answering (no fast
                # send-failure detection) while every request waits out
                # the full router deadline.  Either way: mark dead, stop,
                # close the peer so dispatch sends fail fast.
                if isinstance(e, chaos_inject.InjectedDeath):
                    timeline.event("serve", "worker-die",
                                   rank=self.peer.chaos_rank(), why=str(e))
                else:
                    _log.exception("serve worker loop failed: %s", e)
                    timeline.event("serve", "worker-error",
                                   rank=self.peer.chaos_rank(), why=str(e))
                self.dead = True
                self._stop.set()
                aggregator.disown_gauge(kvcache.GAUGE,
                                        self.peer.chaos_rank(), self._kv_gauge)
                try:
                    self.peer.close()
                except Exception:  # noqa: BLE001 — dying is the point
                    pass
                return
            for ev in events:
                rid, _, att_s = (ev.get("rid") or "").rpartition("#")
                with self._lock:
                    current = (self._att.get(rid) is not None
                               and str(self._att[rid]) == att_s)
                if not current:
                    continue  # a superseded attempt's surviving run
                if ev["kind"] == "token":
                    with self._lock:
                        toks = self._toks.get(rid)
                        if toks is not None:
                            toks.append(ev["tok"])
                            n = len(toks)
                            snap = list(toks)
                    if toks is not None and n % self.commit_every == 0:
                        self._queue_progress(rid, snap, None)
                elif ev["kind"] == "done":
                    self._queue_done(
                        rid, ev["tokens"], ok=True,
                        ttft_s=ev["ttft_s"], queue_s=ev["queue_s"],
                        reused_tokens=ev["reused_tokens"],
                        computed_tokens=ev["computed_tokens"])
            if self.step_period_s > 0:
                left = self.step_period_s - (time.perf_counter() - t_step)
                if left > 0:
                    time.sleep(left)

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        aggregator.disown_gauge(kvcache.GAUGE, self.peer.chaos_rank(),
                                self._kv_gauge)
        self._thread.join(join_timeout)
        for _ in self._senders:
            self._sendq.put(None)
        for t in self._senders:
            t.join(join_timeout)


# -- router side ------------------------------------------------------------
class RequestHandle:
    """Client-side future for one accepted request."""

    def __init__(self, rid: str, prompt: Sequence[int], max_new: int):
        self.rid = rid
        self.prompt = list(int(t) for t in prompt)
        self.max_new = int(max_new)
        #: kf-xray causal trace of this request: one trace id spans the
        #: router's admission events, the worker's frame handling, and
        #: the engine's prefill span.  The router span id is the parent
        #: every downstream span hangs off.
        self.trace = f"srv.{rid}"
        self.router_span = timeline.new_span_id()
        self.submitted_s = time.perf_counter()
        #: tokens committed across ALL workers (replay restarts here)
        self.committed: List[int] = []
        #: current worker's progress beyond ``committed``
        self.worker_tokens: List[int] = []
        self.worker: Optional[int] = None
        self.deadline = 0.0
        self.replays = 0
        self.ttft_s: Optional[float] = None
        self.stats: dict = {}
        self.tokens: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.done_s: Optional[float] = None  # perf_counter at settle
        self._done = threading.Event()

    @property
    def committed_total(self) -> List[int]:
        return self.committed + self.worker_tokens

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        if self.error is not None:
            raise self.error
        return list(self.tokens or [])


class ServeRouter:
    """Admission + dispatch + the serving fault ladder, riding one
    peer's channel."""

    def __init__(self, peer, worker_ranks: Sequence[int], *,
                 queue_depth: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 topology: Optional[SliceTopology] = None,
                 strike_limit: int = 2,
                 watch_period_s: Optional[float] = None):
        if peer.channel is None:
            raise RuntimeError("routing needs a started multi-peer world")
        self.peer = peer
        workers = peer.config.cluster.workers
        self._addr: Dict[int, object] = {r: workers[r] for r in worker_ranks}
        self._live = set(int(r) for r in worker_ranks)
        self._dead: set = set()
        self.topology = topology
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else envs.parse_int_env(envs.SERVE_QUEUE_DEPTH,
                                    DEFAULT_QUEUE_DEPTH))
        self.deadline_s = float(
            deadline_s if deadline_s is not None
            else envs.parse_float_env(envs.SERVE_REQUEST_DEADLINE,
                                      DEFAULT_DEADLINE_S))
        self.strike_limit = int(strike_limit)
        self._lock = threading.Lock()
        self._reqs: Dict[str, RequestHandle] = {}
        self._outstanding: Dict[int, int] = {r: 0 for r in self._live}
        self._strikes: Dict[int, int] = {}
        self._completed = 0
        self._replayed = 0
        self._stop = threading.Event()
        self._watch_period = (watch_period_s if watch_period_s is not None
                              else max(0.05, min(0.25, self.deadline_s / 4)))
        self._watchdog = threading.Thread(
            target=self._watch_loop, name="kf-serve-router", daemon=True)
        peer.channel.on_p2p_request(self._on_frame)
        self._watchdog.start()

    # -- views -----------------------------------------------------------
    @property
    def live_workers(self) -> List[int]:
        with self._lock:
            return sorted(self._live)

    @property
    def dead_workers(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._reqs)

    def outstanding(self, rank: int) -> int:
        """Requests currently dispatched to ``rank`` — the autoscaler's
        drain check before retiring a worker (serve/scale.py)."""
        with self._lock:
            return int(self._outstanding.get(int(rank), 0))

    @property
    def completed(self) -> int:
        with self._lock:
            return self._completed

    @property
    def replayed(self) -> int:
        with self._lock:
            return self._replayed

    # -- admission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: Optional[int] = None,
               rid: Optional[str] = None) -> RequestHandle:
        """FCFS admission with a bounded accepted set; rejected
        admissions raise the typed overload error immediately.
        ``max_new`` defaults from ``KF_SERVE_MAX_TOKENS``."""
        if max_new is None:
            max_new = envs.parse_int_env(envs.SERVE_MAX_TOKENS, 256)
        rid = rid or f"{self.peer.config.self_id.port}-{next(_rid_counter)}"
        h = RequestHandle(rid, prompt, max_new)
        # check + insert under ONE acquisition: two concurrent
        # submitters passing a split check would both insert and exceed
        # the documented bound
        with self._lock:
            depth = len(self._reqs)
            if depth >= self.queue_depth:
                timeline.event("request", "reject",
                               rank=self.peer.chaos_rank(), depth=depth,
                               trace=h.trace, parent=h.router_span)
                raise ServeOverloadError(depth, self.queue_depth)
            self._reqs[rid] = h
            slo.note_queue_depth(len(self._reqs))
        timeline.event("request", "accept", rank=self.peer.chaos_rank(),
                       rid=rid, trace=h.trace, span=h.router_span)
        self._dispatch(h)
        return h

    def _pick_worker_locked(self) -> Optional[int]:
        live = sorted(self._live)
        if not live:
            return None
        return min(live, key=lambda r: (self._outstanding.get(r, 0), r))

    def _dispatch(self, h: RequestHandle) -> None:
        """Send (or re-send) a request to the least-outstanding live
        worker; a send failure walks the dead-worker ladder and tries
        the next survivor.  Bounded: every failing pass removes a
        worker from the live set, so the loop ends in at most
        ``len(workers) + 1`` passes (the last one fails the handle).
        No backoff on purpose — each pass targets a DIFFERENT endpoint
        (failover, not re-hammering), and channel.send already owns the
        bounded per-endpoint retry."""
        for _ in range(len(self._addr) + 1):  # kflint: allow(retry-discipline)
            with self._lock:
                target = self._pick_worker_locked()
                if target is not None:
                    self._outstanding[target] = (
                        self._outstanding.get(target, 0) + 1)
                    h.worker = target
                    h.worker_tokens = []
                    h.deadline = time.monotonic() + self.deadline_s
                    addr = self._addr[target]
            if target is None:
                self._fail(h, RequestLostError(h.rid, h.committed))
                return
            body = json.dumps({
                "rid": h.rid, "prompt": h.prompt,
                "committed": h.committed, "max_new": h.max_new,
                # attempt id, echoed in every progress/done frame: a
                # replayed-away worker's late frames fail this check, so
                # tokens already folded into h.committed can never be
                # double-counted even when the replay landed on the SAME
                # worker (where the src guard alone is blind)
                "att": h.replays,
                # kf-xray trace context in the existing JSON meta (the
                # HeaderCodec wire header is untouched): the worker
                # re-enters it so its handling + the engine prefill span
                # join this request's trace
                "tc": timeline.format_trace_context(h.trace,
                                                    h.router_span),
            }).encode()
            try:
                self.peer.channel.send(addr, f"{REQ_PREFIX}{h.rid}", body,
                                       ConnType.PEER_TO_PEER,
                                       retries=SEND_RETRIES)
                return
            except (OSError, ConnectionError) as e:
                _log.warning("dispatch of %s to rank %d failed: %s",
                             h.rid, target, e)
                with self._lock:
                    self._outstanding[target] = max(
                        0, self._outstanding.get(target, 1) - 1)
                # the dead-mark replays every OTHER victim; h itself
                # re-dispatches in this loop (it is not yet assigned —
                # mark_worker_dead skips handles whose worker it just
                # unset here)
                with self._lock:
                    h.worker = None
                self.mark_worker_dead(target)
        self._fail(h, RequestLostError(h.rid, h.committed,
                                       "dispatch retries exhausted"))

    # -- channel receive path ---------------------------------------------
    def _on_frame(self, name: str, payload: bytes, src: str) -> None:
        if name.startswith(PROG_PREFIX):
            kind = "progress"
            rid = name[len(PROG_PREFIX):]
        elif name.startswith(DONE_PREFIX):
            kind = "done"
            rid = name[len(DONE_PREFIX):]
        else:
            return
        try:
            msg = json.loads(payload.decode())
        except ValueError as e:
            _log.warning("bad serve frame %s from %s: %s", name, src, e)
            return
        with self._lock:
            h = self._reqs.get(rid)
            if h is None:
                return  # late frame from a worker we already replayed away
            worker = h.worker
            if worker is None or str(self._addr.get(worker)) != src \
                    or int(msg.get("att", -1)) != h.replays:
                # a frame from a PREVIOUS assignment/attempt (the
                # request was replayed away — possibly onto the same
                # worker): its tokens overlap the committed prefix —
                # accepting it would double-count the replay
                return
            self._strikes.pop(worker, None)  # liveness proof
            if kind == "progress":
                h.worker_tokens = [int(t) for t in msg.get("tokens") or []]
                h.deadline = time.monotonic() + self.deadline_s
                if h.ttft_s is None and msg.get("ttft_s") is not None:
                    h.ttft_s = float(msg["ttft_s"])
                return
            # done
            self._reqs.pop(rid, None)
            if worker is not None:
                self._outstanding[worker] = max(
                    0, self._outstanding.get(worker, 1) - 1)
            self._completed += 1
            slo.note_queue_depth(len(self._reqs))
        if not msg.get("ok", False):
            self._fail(h, ValueError(msg.get("error") or "worker rejection"),
                       count="reject")
            return
        h.tokens = h.committed + [int(t) for t in msg.get("tokens") or []]
        h.stats = {k: msg.get(k) for k in ("ttft_s", "queue_s",
                                           "reused_tokens",
                                           "computed_tokens")}
        if h.ttft_s is None and msg.get("ttft_s") is not None:
            h.ttft_s = float(msg["ttft_s"])
        h.done_s = time.perf_counter()
        e2e = h.done_s - h.submitted_s
        slo.observe_e2e(e2e)
        timeline.event("request", "complete", rank=self.peer.chaos_rank(),
                       rid=rid, e2e_ms=e2e * 1e3, replays=h.replays,
                       trace=h.trace, parent=h.router_span)
        h._done.set()

    def _fail(self, h: RequestHandle, err: BaseException,
              count: str = "lost") -> None:
        with self._lock:
            self._reqs.pop(h.rid, None)
            slo.note_queue_depth(len(self._reqs))
        h.error = err
        h.done_s = time.perf_counter()
        timeline.event("request", count, rank=self.peer.chaos_rank(),
                       rid=h.rid, trace=h.trace, parent=h.router_span)
        h._done.set()

    # -- the fault ladder --------------------------------------------------
    def _watch_loop(self) -> None:
        while not self._stop.wait(self._watch_period):
            now = time.monotonic()
            expired: List[tuple] = []  # (handle, worker at expiry)
            with self._lock:
                for h in self._reqs.values():
                    if h.worker is not None and now > h.deadline:
                        expired.append((h, h.worker))
            suspects: Dict[int, int] = {}
            for _, w in expired:
                suspects[w] = suspects.get(w, 0) + 1
            newly_dead: List[int] = []
            for w, n in suspects.items():
                with self._lock:
                    if w not in self._live:
                        continue
                    strikes = self._strikes.get(w, 0) + n
                    self._strikes[w] = strikes
                    is_dead = strikes >= self.strike_limit
                if is_dead:
                    newly_dead.append(w)
            for w in newly_dead:
                self.mark_worker_dead(w)
            # a single expired request on a worker that stays under the
            # strike limit (e.g. a chaos-dropped frame) replays alone —
            # keyed on the worker AT EXPIRY: the dead-mark above already
            # re-dispatched its victims, whose h.worker now names the
            # replacement
            for h, w in expired:
                if w not in newly_dead and not h.done():
                    self._replay(h)

    def _replay(self, h: RequestHandle) -> None:
        with self._lock:
            if h.rid not in self._reqs:
                return  # completed while we deliberated
            if h.worker is not None:
                self._outstanding[h.worker] = max(
                    0, self._outstanding.get(h.worker, 1) - 1)
            h.committed = h.committed + h.worker_tokens
            h.worker_tokens = []
            h.replays += 1
            self._replayed += 1
        timeline.event("request", "replay", rank=self.peer.chaos_rank(),
                       rid=h.rid, committed=len(h.committed),
                       trace=h.trace, parent=h.router_span)
        self._dispatch(h)

    def admit_worker(self, rank: int) -> bool:
        """Admit a (newly spawned or recovered) worker into the
        schedulable set — the autoscale execution path
        (:class:`kungfu_tpu_torch.serve.scale.ServeFleet` spawns the engine +
        :class:`ServeWorker`, then admits its rank here).  The rank
        must exist in the peer's cluster membership; a rank previously
        excluded by the fault ladder is re-admitted fresh (zero
        strikes, zero outstanding).  Returns False when already live."""
        workers = self.peer.config.cluster.workers
        if not 0 <= rank < len(workers):
            raise ValueError(
                f"rank {rank} outside the {len(workers)}-worker cluster")
        with self._lock:
            if rank in self._live:
                return False
            self._live.add(int(rank))
            self._dead.discard(int(rank))
            self._addr[int(rank)] = workers[rank]
            self._outstanding[int(rank)] = 0
            self._strikes.pop(int(rank), None)
        timeline.event("serve", "readmit", rank=self.peer.chaos_rank(),
                       ranks=[int(rank)])
        _log.info("serving worker %d admitted", rank)
        return True

    def mark_worker_dead(self, rank: int, readmit: bool = True) -> List[int]:
        """Remove a worker (and, at slice grain, its whole slice) from
        the schedulable set; re-admit its in-flight requests.  Returns
        the ranks excluded by this call."""
        with self._lock:
            if rank not in self._live:
                return []
            excluded = {rank}
            if self.topology is not None:
                dead_slices, degraded = slice_verdict(
                    self._dead | {rank}, self.topology)
                for s in dead_slices | degraded:
                    excluded |= set(self.topology.ranks_in(s))
                excluded &= self._live
            self._live -= excluded
            self._dead |= excluded
            for r in excluded:
                self._strikes.pop(r, None)
            victims = [h for h in self._reqs.values()
                       if h.worker in excluded]
        if self.topology is not None and len(excluded) > 1:
            timeline.event("serve", "slice-dead", rank=self.peer.chaos_rank(),
                           ranks=sorted(excluded))
        else:
            timeline.event("serve", "worker-dead",
                           rank=self.peer.chaos_rank(), ranks=sorted(excluded))
        _log.warning("serving workers %s excluded (%d in-flight to replay)",
                     sorted(excluded), len(victims))
        if readmit:
            for h in victims:
                self._replay(h)
        return sorted(excluded)

    def close(self) -> None:
        self._stop.set()
        self._watchdog.join(2.0)
