"""Deterministic fault injection: the controller behind the data-path hooks.

Trimmed copy of ``kungfu_tpu/chaos/inject.py``: the controller keeps
the hooks the port's callers reach -- ``on_step`` (:func:`note_step`),
the engine's ``on_collective``, ``on_send`` and ``on_recv``, the
slice-scoped deaths (``die_slice``), the failure detector's
``drop_fanout`` and the consensus config fetch's
``config_unavailable``, and the latency probe's ``on_ping``
(``delay:on=ping``, :func:`kungfu_tpu_torch.monitor.adapt.
get_peer_latencies`) and the serving worker's ``on_serve_request``
(``delay:on=serve``, ``drop_request``).

One :class:`ChaosController` exists per (spec, seed, rank) — the engine
holds the instance for its own rank, the detector and other rank-less
subsystems use the ``rank=None`` instance — so trigger counters (Nth
collective, Nth send, Nth config fetch) are deterministic given a
deterministic call sequence, and an in-process multi-rank test cluster
can target one victim rank while its siblings run fault-free.

The contract that makes this shippable in the hot path: with
``KF_CHAOS_SPEC`` unset, :func:`controller_for` returns ``None`` and
every call site guards with ``if chaos is not None`` — the disabled cost
is one attribute load + branch, and the wire behavior is byte-identical
to a build without the hooks (tier-1 asserts this).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import List, Optional

from kungfu_tpu_torch.chaos.spec import Clause, parse_spec
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("chaos")

# the registry (utils/envs.py) is the single authority for KF_* names;
# chaos was the one subsystem naming its envs locally — drift bait
SPEC_ENV = envs.CHAOS_SPEC
SEED_ENV = envs.CHAOS_SEED

#: worker exit status for ``die`` faults in ``exit`` mode — distinct from
#: real crash codes so the runner's logs attribute the death to chaos
DIE_EXIT_CODE = 43


class InjectedDeath(Exception):
    """A ``die`` fault in ``mode=raise`` — the in-process stand-in for a
    worker process vanishing (the thread playing the victim should close
    its channel and stop participating)."""


class InjectedReset(ConnectionResetError):
    """A ``reset`` fault at the sender: the wire saw a truncated frame;
    a ``ConnectionResetError`` subtype so the engine's bounded-retry send
    path handles it exactly like a real mid-chunk reset."""


class ChaosController:
    """Evaluates the parsed clauses against this rank's event stream."""

    def __init__(self, clauses: List[Clause], rank: Optional[int], seed: int):
        self.rank = rank
        self._clauses = [c for c in clauses if c.matches_rank(rank)]
        self._rng = random.Random(
            seed * 1000003 + (rank if rank is not None else -1)
        )
        self._lock = threading.Lock()
        self._colls = 0
        self._sends = 0
        self._recvs = 0
        self._fetches = 0
        self._fanout_dropped: dict = {}
        #: the last step the training loop announced (note_step) — the
        #: arming clock for ``delay:after_step=N`` mid-run onsets; None
        #: until the first announcement, so un-announced processes never
        #: arm a gated clause by accident
        self._step: Optional[int] = None
        #: clause-index -> count of events MATCHING that clause's filters
        #: (``delay:every=K`` strides over matching events; striding the
        #: global counter would make the outcome depend on unrelated
        #: traffic interleaving — not reproducible across topologies)
        self._matched: dict = {}

    # -- death ------------------------------------------------------------
    def _die(self, clause: Clause, why: str) -> None:
        mode = clause.get("mode", "exit")
        _log.warning("chaos: injecting death (%s, mode=%s)", why, mode)
        timeline.event("chaos", "die", rank=self.rank, why=why, mode=mode)
        if mode == "exit":
            # os._exit skips atexit — flush the flight recorder first so
            # the injected death is correlatable in the merged timeline
            timeline.maybe_dump()
        if mode == "raise":
            raise InjectedDeath(why)
        os._exit(DIE_EXIT_CODE)

    def _slice_matches(self, clause: Clause) -> bool:
        """Does this controller's rank live in the clause's slice?  From
        ``MEGASCALE_SLICE_ID`` (one process a worker), else ``rank //
        rps`` for in-process clusters that share one environment."""
        want = clause.get("slice")
        if want is None:
            return False
        sid = (os.environ.get(envs.MEGASCALE_SLICE_ID, "") or "").strip()
        if sid:
            return int(sid) == want
        rps = clause.get("rps")
        if rps and self.rank is not None:
            return self.rank // rps == want
        return False

    def on_step(self, step: int) -> None:
        """Training loop announced step ``step`` (``die[_slice]:step=N``,
        ``preempt:all[,step=N]``, and the ``delay:after_step=N`` arming
        clock)."""
        self._step = step
        for c in self._clauses:
            if c.kind == "die" and c.get("step") == step:
                self._die(c, f"step={step}")
            elif (c.kind == "die_slice" and c.get("step") == step
                    and self._slice_matches(c)):
                self._die(c, f"slice={c.get('slice')} step={step}")
            elif c.kind == "preempt" and c.get("step") in (None, step):
                # whole-job preemption: every rank's controller matches
                # (no rank scope by grammar), so all processes die at the
                # same announced boundary — no survivors by construction
                self._die(c, f"preempt step={step}")

    def on_collective(self, tag: str) -> None:
        """Engine is starting a collective (``die:coll=N``, 1-based)."""
        with self._lock:
            self._colls += 1
            n = self._colls
        for c in self._clauses:
            if c.kind == "die" and c.get("coll") == n:
                self._die(c, f"coll={n} ({tag!r})")
            elif (c.kind == "die_slice" and c.get("coll") == n
                    and self._slice_matches(c)):
                self._die(c, f"slice={c.get('slice')} coll={n} ({tag!r})")

    # -- data-path perturbation -------------------------------------------
    def on_send(self, to_rank: int, name: str, payload, channel=None,
                peer=None) -> None:
        """Engine send hook: may straggle (``delay``) or tear the wire
        (``reset``).  ``channel``/``peer`` let the reset clause transmit a
        real truncated frame when the backend supports it."""
        with self._lock:
            self._sends += 1
            n = self._sends
        for ci, c in enumerate(self._clauses):
            if c.kind == "delay" and c.get("on", "send") == "send":
                self._maybe_delay(ci, c, to_rank)
            elif c.kind == "reset" and c.get("send") == n:
                if c.get("peer") is not None and c.get("peer") != to_rank:
                    continue
                self._reset(name, payload, channel, peer)

    def on_ping(self, to_rank: int) -> None:
        """Latency-probe hook (``delay:on=ping``), called inside the
        probe's timed window: the MST re-carve must see an injected slow
        link, or it routes straight back onto it."""
        for ci, c in enumerate(self._clauses):
            if c.kind == "delay" and c.get("on") == "ping":
                self._maybe_delay(ci, c, to_rank)

    def on_serve_request(self, rid: str) -> bool:
        """Serving request-path hook (the serve worker's frame handler):
        applies ``delay:on=serve`` stragglers, then ``drop_request``.
        True = the frame is lost (the worker ignores it and the router's
        deadline ladder re-admits the request).  Counted in matching
        requests, like every other clause."""
        dropped = False
        for ci, c in enumerate(self._clauses):
            if c.kind == "delay" and c.get("on") == "serve":
                self._maybe_delay(ci, c, -1)
            elif c.kind == "drop_request":
                with self._lock:
                    n = self._matched[ci] = self._matched.get(ci, 0) + 1
                if n % max(1, c.get("every", 1)) != 0:
                    continue
                budget = c.get("count")
                if budget is not None:
                    with self._lock:
                        used = self._fanout_dropped.get(("req", ci), 0)
                        if used >= budget:
                            continue
                        self._fanout_dropped[("req", ci)] = used + 1
                _log.warning("chaos: dropping serve request %s", rid)
                timeline.event("chaos", "drop_request", rank=self.rank,
                               rid=rid)
                dropped = True
        return dropped

    def on_recv(self, from_rank: int, name: str) -> None:
        """Engine receive hook (``delay:on=recv`` stragglers)."""
        with self._lock:
            self._recvs += 1
        for ci, c in enumerate(self._clauses):
            if c.kind == "delay" and c.get("on") == "recv":
                self._maybe_delay(ci, c, from_rank)

    def _maybe_delay(self, ci: int, c: Clause, other_rank: int) -> None:
        if c.get("peer") is not None and c.get("peer") != other_rank:
            return
        after = c.get("after_step")
        if after is not None and (self._step is None or self._step < after):
            # gated BEFORE the match count: an every=K stride over an
            # after_step clause strides armed-phase events only
            return
        with self._lock:
            n = self._matched[ci] = self._matched.get(ci, 0) + 1
        if n % max(1, c.get("every", 1)) != 0:
            return
        ms = c.get("ms", 0) + (
            self._rng.uniform(0, c.get("jitter", 0)) if c.get("jitter") else 0
        )
        if ms > 0:
            timeline.event("chaos", "delay", rank=self.rank, ms=ms,
                           peer=other_rank)
            time.sleep(ms / 1000.0)

    def _reset(self, name: str, payload, channel, peer) -> None:
        nbytes = (
            len(payload) if isinstance(payload, bytes)
            else memoryview(payload).nbytes
        )
        sent = nbytes // 2
        partial = getattr(channel, "chaos_partial_send", None)
        if partial is not None and peer is not None:
            # real wire damage: header promises nbytes, half arrive, the
            # socket dies — the receiver's stream loop sees peer-closed-
            # mid-message, exactly what a worker dying mid-chunk produces
            try:
                partial(peer, name, payload, sent)
            except OSError:
                pass  # the tear itself failing is still a tear
        _log.warning(
            "chaos: reset mid-chunk on %r (%d/%d bytes sent)", name, sent, nbytes
        )
        timeline.event("chaos", "reset", rank=self.rank, coll=name,
                       sent=sent, nbytes=nbytes)
        raise InjectedReset(f"injected reset mid-chunk on {name!r}")

    # -- control-plane faults ---------------------------------------------
    def drop_fanout(self, host: str) -> bool:
        """True = the detector's fan-out POST to ``host`` is lost."""
        for i, c in enumerate(self._clauses):
            if c.kind != "drop_fanout":
                continue
            if c.get("host") is not None and c.get("host") != host:
                continue
            budget = c.get("count")
            if budget is not None:
                with self._lock:
                    used = self._fanout_dropped.get(i, 0)
                    if used >= budget:
                        continue
                    self._fanout_dropped[i] = used + 1
            _log.warning("chaos: dropping detector fan-out to %s", host)
            timeline.event("chaos", "drop_fanout", rank=self.rank, host=host)
            return True
        return False

    def config_unavailable(self) -> bool:
        """True = this config-server fetch falls in a dark window
        (counted in fetch attempts, not wall time)."""
        with self._lock:
            self._fetches += 1
            n = self._fetches
        for c in self._clauses:
            if c.kind == "config_down":
                after = c.get("after", 0)
                if after < n <= after + c.get("count", 1):
                    timeline.event("chaos", "config_down", rank=self.rank,
                                   fetch=n)
                    return True
        return False


# -- controller registry ----------------------------------------------------
_cache_lock = threading.Lock()
_cache: dict = {}


def controller_for(rank: Optional[int]) -> Optional[ChaosController]:
    """The process's controller for ``rank`` — ``None`` (the fast no-op
    path) unless ``KF_CHAOS_SPEC`` is set.  Cached per (spec, seed, rank)
    so every subsystem of one rank shares one set of trigger counters."""
    spec = os.environ.get(SPEC_ENV)
    if not spec:
        return None
    seed = int(os.environ.get(SEED_ENV, "0") or 0)
    key = (spec, seed, rank)
    with _cache_lock:
        ctl = _cache.get(key)
        if ctl is None:
            ctl = _cache[key] = ChaosController(parse_spec(spec), rank, seed)
        return ctl


def note_step(rank: Optional[int], step: int) -> None:
    """Training-loop step announcement (drives ``die:step=N``); free when
    chaos is disabled.  Also stamps the flight recorder's step counter —
    every instrumented training loop already calls this at each step
    boundary, so timeline events get step attribution without a second
    per-step hook."""
    timeline.set_step(step)
    ctl = controller_for(rank)
    if ctl is not None:
        ctl.on_step(step)


def reset() -> None:
    """Drop all cached controllers (their trigger counters die with
    them).  For tests that reuse one spec across scenarios, and for a
    long-lived process that re-arms an experiment."""
    with _cache_lock:
        _cache.clear()
