"""Typed data-path failure vocabulary (copy of
``kungfu_tpu/comm/faults.py``).

A dead peer must surface as an attributed failure, not as whichever
low-level error fires first: a collective primitive that exhausts its
per-peer deadline raises :class:`PeerFailureError` with the suspect
rank, and the recovery path turns that into an exclusion among the
survivors.  ``PeerFailureError`` subclasses ``ConnectionError``, so
every ``except (OSError, ConnectionError, TimeoutError)`` site keeps
working while new code can catch the typed form.
"""

from __future__ import annotations

from typing import Optional


class PeerFailureError(ConnectionError):
    """A collective primitive exhausted its per-peer deadline or retries.

    ``rank`` is the *suspect* (the peer this primitive was talking to),
    or ``None`` when the failing layer cannot attribute blame.  A
    suspect is a hint, not a verdict: a peer blocked on the real victim
    times out toward an innocent neighbour, so recovery re-confirms
    every suspect before proposing eviction.
    """

    def __init__(
        self,
        rank: Optional[int],
        peer=None,
        op: str = "",
        phase: str = "",
        cause: Optional[BaseException] = None,
    ):
        self.rank = rank
        self.peer = peer
        self.op = op
        self.phase = phase
        self.cause = cause
        who = f"rank {rank} ({peer})" if rank is not None else "unattributed peer"
        super().__init__(
            f"collective {op!r} {phase or 'failed'} toward {who}: {cause}"
        )


class SliceExcludedError(RuntimeError):
    """This worker is alive but its slice is not: the confirmed dead set
    covers part of its slice, and a half-dead slice has no within-slice
    mesh left.  The surviving slices exclude the whole slice; a worker
    catching this stops cleanly and waits for the repaired slice."""

    def __init__(self, slice_id: int, dead_ranks):
        self.slice_id = slice_id
        self.dead_ranks = sorted(dead_ranks)
        super().__init__(
            f"slice {slice_id} is degraded (dead ranks {self.dead_ranks}); "
            "this surviving member is excluded with it — a half-dead "
            "slice must not keep training"
        )


class ServeOverloadError(RuntimeError):
    """Typed admission rejection: accepted but unfinished requests
    already fill the bounded queue (``KF_SERVE_QUEUE_DEPTH``).  Overload
    surfaces as an immediate rejection the caller can back off on, not
    as an unbounded queue."""

    def __init__(self, depth: int, limit: int):
        self.depth = depth
        self.limit = limit
        super().__init__(
            f"serving queue at capacity ({depth}/{limit} accepted "
            "requests in flight); rejecting admission"
        )


class RequestLostError(RuntimeError):
    """A replayed serving request ran out of live workers or replay
    attempts.  Carries the request id and the committed tokens, so the
    caller can resubmit without losing the paid-for prefix."""

    def __init__(self, rid: str, committed, why: str = ""):
        self.rid = rid
        self.committed = list(committed)
        super().__init__(
            f"request {rid!r} lost after {len(self.committed)} committed "
            f"token(s): {why or 'no live workers remain'}"
        )


class QuorumLostError(RuntimeError):
    """Shrink-to-survivors cannot proceed: the surviving set is not a
    strict majority of the current membership; the last resort is the
    whole-job restart."""

    def __init__(self, survivors: int, total: int):
        self.survivors = survivors
        self.total = total
        super().__init__(
            f"{survivors} survivor(s) of {total} is not a quorum; "
            "falling back to detector-driven restart"
        )
