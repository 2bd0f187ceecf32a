"""``KF_CHAOS_SPEC`` grammar: deterministic fault clauses.

Copy of ``kungfu_tpu/chaos/spec.py``: every clause kind parses as in the
reference, also those whose hook sites the port has not reached yet
(``drop_request`` of the serving router, ``drop_fanout`` of the failure
detector, ``config_down`` of the elastic config fetch).

A spec is ``;``-separated clauses; each clause is a fault kind followed
by ``key=value`` params::

    kind[:key=value[,key=value...]]

Example — rank 2 dies on its 3rd allreduce, rank 0's 2nd collective send
is reset mid-chunk, rank 1 straggles 200 ms on every send, the detector
drops its fan-out to one host, and the config server is dark for fetch
calls 3..5::

    KF_CHAOS_SPEC="die:coll=3,rank=2;reset:send=2,rank=0;\
delay:ms=200,rank=1;drop_fanout:host=10.0.0.7;config_down:after=2,count=3"

Fault kinds and their params (``rank=R`` scopes a clause to the
controller built for rank R — except ``drop_fanout``, which runs in the
detector's rank-less controller and is scoped by ``host=`` instead;
without scoping a clause applies everywhere):

``die``
    Kill this worker.  Trigger: ``step=N`` (the training loop announced
    step N via :func:`kungfu_tpu_torch.chaos.note_step`) or ``coll=N`` (this
    rank's Nth engine collective, 1-based).  ``mode=exit`` (default —
    ``os._exit(43)``, a real process death) or ``mode=raise`` (raise
    :class:`~kungfu_tpu_torch.chaos.inject.InjectedDeath` in the collective;
    for in-process test clusters where ``_exit`` would take the whole
    interpreter down).
``die_slice``
    Kill every rank of TPU slice ``slice=S`` — the multislice failure
    grain (a slice loses DCN/power as a unit; docs/multislice.md).  Each
    rank's controller evaluates its OWN slice id against ``S``:
    ``MEGASCALE_SLICE_ID`` when the launcher set it (kfrun emulation /
    real pod env), else ``rank // rps`` when ``rps=K`` (ranks per slice)
    is given — in-process multi-rank test clusters have one env, so they
    pass ``rps``.  Triggers and ``mode`` as for ``die``; all matching
    ranks fire at the same step/collective boundary, so the whole slice
    goes down "at once", deterministically under ``KF_CHAOS_SEED``
    (death needs no randomness — the seed only ever feeds delay jitter).
``reset``
    Connection reset mid-chunk: on this rank's Nth engine send
    (``send=N``), transmit a frame header promising the full chunk,
    deliver only half the payload, kill the socket, and raise
    ``InjectedReset`` at the sender — the receiver observes a
    peer-closed-mid-message stream, the sender's bounded retry path
    re-sends.  ``peer=R`` restricts to sends toward rank R.
``delay``
    Straggler: sleep ``ms=X`` (+ uniform ``jitter=Y`` ms, seeded by
    ``KF_CHAOS_SEED``) before a send.  ``peer=R`` restricts the target;
    ``every=K`` delays only every Kth matching send (default 1 = all);
    ``on=recv`` delays the receive side instead, ``on=ping`` the
    latency-probe pings (``get_peer_latencies``) — a throttled link
    must look slow to the MST re-carve, not just to the data path —
    and ``on=serve`` the serving request path (the worker straggles
    ``ms`` before admitting each matching request, kf-serve).
    ``after_step=N`` keeps the clause INERT until the training loop
    announces step N via :func:`kungfu_tpu_torch.chaos.note_step` — a
    mid-run onset, so a regression experiment gets a clean baseline
    phase and a planted degradation from one deterministic step
    boundary (the kf-sentinel changepoint gate).  Matching-event
    counts (``every``) start at the onset, not at process start.
``preempt``
    Whole-job preemption: EVERY rank dies at the same boundary — the
    spot/maintenance eviction that takes the entire capacity at once
    (no survivors, so only the durable manifest plane of
    ``elastic/persist.py`` can recover; docs/persistence.md).  The
    mandatory bare ``all`` token makes the blast radius explicit:
    ``preempt:all[,step=N][,mode=...]``.  ``step=N`` fires when the
    training loop announces step N (without it, the first announced
    step); ``mode`` as for ``die``.  Deliberately NOT rank-scopable —
    a partial kill is ``die``/``die_slice``; preemption means all.
``drop_request``
    The serving plane loses an incoming request frame: this rank's
    serve handler silently discards every matching request
    (``every=K`` strides over matching requests, ``count=N`` bounds
    the total dropped; both default to all) — the router's per-request
    deadline then re-admits it elsewhere, exactly the lost-frame /
    half-open-connection failure the strike ladder exists for
    (docs/serving.md).
``drop_fanout``
    The failure detector's cross-host fan-out silently loses its POST to
    ``host=H`` (absent = every host); ``count=N`` drops only the first N
    (default: all).
``config_down``
    Config-server unavailability window, in units of fetch attempts:
    fetches ``after+1 .. after+count`` fail (``after`` default 0,
    ``count`` default 1) — deterministic regardless of wall clock.

Parsing is strict: an unknown kind or a malformed param raises
``ValueError`` at controller construction — a typo'd chaos spec must
fail the experiment loudly, not silently run fault-free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

KINDS = ("die", "die_slice", "preempt", "reset", "delay", "drop_fanout",
         "drop_request", "config_down")

_INT_PARAMS = {
    "rank", "step", "coll", "send", "peer", "every", "count", "after",
    "ms", "jitter", "slice", "rps", "after_step",
}
_STR_PARAMS = {"mode", "host", "on"}

_ALLOWED = {
    "die": {"rank", "step", "coll", "mode"},
    "die_slice": {"slice", "step", "coll", "mode", "rps"},
    "preempt": {"all", "step", "mode"},
    "reset": {"rank", "send", "peer"},
    "delay": {"rank", "ms", "jitter", "peer", "every", "on", "after_step"},
    "drop_fanout": {"host", "count"},
    "drop_request": {"rank", "count", "every"},
    "config_down": {"rank", "after", "count"},
}


@dataclass(frozen=True)
class Clause:
    kind: str
    params: Tuple[Tuple[str, object], ...] = field(default=())

    def get(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    @property
    def rank(self) -> Optional[int]:
        return self.get("rank")

    def matches_rank(self, rank: Optional[int]) -> bool:
        want = self.rank
        return want is None or want == rank


def _parse_clause(text: str) -> Clause:
    kind, _, rest = text.partition(":")
    kind = kind.strip()
    if kind not in KINDS:
        raise ValueError(f"unknown chaos fault kind {kind!r} (one of {KINDS})")
    params: Dict[str, object] = {}
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if kind == "preempt" and key == "all" and not eq:
                # the explicit blast-radius token, not a key=value pair
                params["all"] = True
                continue
            if not eq or not key or not val:
                raise ValueError(f"malformed chaos param {item!r} in {text!r}")
            if key not in _ALLOWED[kind]:
                raise ValueError(
                    f"param {key!r} not valid for {kind!r} "
                    f"(allowed: {sorted(_ALLOWED[kind])})"
                )
            if key in _INT_PARAMS:
                try:
                    params[key] = int(val)
                except ValueError:
                    raise ValueError(
                        f"chaos param {key}={val!r} must be an integer"
                    ) from None
            else:
                params[key] = val
    mode = params.get("mode")
    if kind in ("die", "die_slice", "preempt") \
            and mode not in (None, "exit", "raise"):
        raise ValueError(f"{kind} mode must be exit|raise, got {mode!r}")
    if kind == "die_slice" and params.get("slice") is None:
        raise ValueError("die_slice needs slice=S (the slice to kill)")
    if kind == "preempt" and params.get("all") is not True:
        raise ValueError(
            "preempt needs the explicit 'all' scope (preempt:all[,step=N])"
            " — a partial kill is die/die_slice")
    if kind == "delay" and params.get("on") not in (None, "send", "recv",
                                                    "ping", "serve"):
        raise ValueError(
            f"delay on= must be send|recv|ping|serve, got "
            f"{params.get('on')!r}")
    return Clause(kind, tuple(sorted(params.items())))


def parse_spec(text: str) -> List[Clause]:
    """Parse a ``KF_CHAOS_SPEC`` value; raises ``ValueError`` on junk."""
    clauses = []
    for part in text.split(";"):
        part = part.strip()
        if part:
            clauses.append(_parse_clause(part))
    if not clauses:
        raise ValueError("KF_CHAOS_SPEC is set but contains no clauses")
    return clauses
