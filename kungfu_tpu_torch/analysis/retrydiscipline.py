"""retry-discipline checker: network retry loops must bound attempts
and back off.

Port of ``kungfu_tpu/analysis/retrydiscipline.py``: the same rule over
the port's tree.

Motivating bugs (both shipped): the elastic resize fetch loop hammered
the config server from every worker at a constant 0.2 s — a synchronized
thundering herd the moment the server blipped — and the detector's
fan-out serialized ~10 s retry ladders per unreachable host.  Both
passed review because "it retries" *looks* robust; the discipline is
mechanical, so a checker enforces it.

A **retry loop** is a ``while``/``for`` whose body has a ``try`` that
(a) performs a network call (``urlopen``, ``connect``/
``create_connection``, channel ``send``/``recv``/``ping``,
``post_signal``, ``fetch_cluster``, ``request``, ...) and (b) has a
handler catching a network exception (``OSError`` family,
``TimeoutError``, ``URLError``, ``HTTPException``, ...) that loops again
(an explicit ``continue``, or falling off the handler's end).

Two rules over every retry loop:

* **bounded** — a ``for`` over a finite iterable, a non-trivial
  ``while`` condition, or a ``while True`` containing a deadline /
  attempt-count comparison (``time.time()``/``time.monotonic()`` or a
  name mentioning deadline/attempt/retries).  An unbounded retry turns a
  permanent failure into a silent hang.
* **backs off** — the retry path sleeps a *computed* delay:
  :func:`kungfu_tpu_torch.utils.retry.sleep_backoff` (or a ``time.sleep``
  whose argument is an expression — ``jittered(p)``, ``0.5 * (i + 1)``);
  a bare-constant ``time.sleep(0.2)`` re-synchronizes every retrier, and
  no sleep at all is a hot hammer.

Suppress a deliberate exception (with a comment saying why) via
``# kflint: allow(retry-discipline)`` on the loop or sleep line.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_py_files,
    parse_module,
    relpath,
    suppressed,
    terminal_name as _terminal,
)

CHECKER = "retry-discipline"

#: terminal names whose call marks a try body as "doing network IO"
_NET_CALLS = {
    "urlopen", "create_connection", "connect", "connect_ex", "sendall",
    "send", "recv", "recv_into", "ping", "post_signal", "fetch_cluster",
    "request", "getresponse", "wait", "query_detector",
}

#: exception terminal names that read as network failures
_NET_EXCS = {
    "OSError", "IOError", "EnvironmentError", "ConnectionError",
    "ConnectionResetError", "ConnectionRefusedError",
    "ConnectionAbortedError", "BrokenPipeError", "TimeoutError",
    "URLError", "HTTPError", "HTTPException", "SSLError",
    "error", "timeout", "gaierror", "herror",
}

_TIME_FNS = {"time", "monotonic", "perf_counter"}
_BOUND_NAME_HINTS = ("deadline", "attempt", "retr", "tries", "remaining",
                     "budget", "left")

#: sleeps that are compliant by construction (utils/retry.py vocabulary)
_BLESSED_SLEEPS = {"sleep_backoff"}


def _scoped(nodes: Iterable[ast.AST]) -> Iterable[ast.AST]:
    """Walk statements without descending into nested loops, functions,
    or classes — those own their retry discipline separately."""
    stack = list(nodes)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.While, ast.For, ast.AsyncFor)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _exc_names(handler: ast.ExceptHandler) -> List[str]:
    t = handler.type
    if t is None:
        return ["<bare>"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return [n for n in (_terminal(e) for e in elts) if n]


def _handler_retries(handler: ast.ExceptHandler) -> bool:
    """True when the handler can lead to another iteration."""
    for n in ast.walk(handler):
        if isinstance(n, ast.Continue):
            return True
    last = handler.body[-1]
    return not isinstance(last, (ast.Raise, ast.Return, ast.Break))


def _is_net_retry_try(t: ast.Try) -> List[ast.ExceptHandler]:
    """The retrying network handlers of ``t`` ([] = not a retry try)."""
    has_net_call = any(
        isinstance(n, ast.Call) and _terminal(n.func) in _NET_CALLS
        for b in t.body for n in ast.walk(b)
    )
    if not has_net_call:
        return []
    return [
        h for h in t.handlers
        if (set(_exc_names(h)) & _NET_EXCS or "<bare>" in _exc_names(h))
        and _handler_retries(h)
    ]


def _loop_is_bounded(loop) -> bool:
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return True
    test = loop.test
    if not (isinstance(test, ast.Constant) and test.value is True):
        return True  # a real while-condition is the bound
    for n in _scoped(loop.body):
        if not isinstance(n, ast.Compare):
            continue
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call) and _terminal(sub.func) in _TIME_FNS:
                return True
            if isinstance(sub, ast.Name) and any(
                h in sub.id.lower() for h in _BOUND_NAME_HINTS
            ):
                return True
    return False


def _sleeps(nodes: Iterable[ast.AST]) -> List[ast.Call]:
    return [
        n for n in _scoped(nodes)
        if isinstance(n, ast.Call)
        and _terminal(n.func) in ({"sleep"} | _BLESSED_SLEEPS)
    ]


def _sleep_is_constant(call: ast.Call) -> bool:
    if _terminal(call.func) in _BLESSED_SLEEPS:
        return False
    if not call.args:
        return True
    # a Constant, bare Name, or module Attribute is the same value every
    # iteration; any computed expression (BinOp, Call, ...) counts as
    # backoff/jitter
    return isinstance(call.args[0], (ast.Constant, ast.Name, ast.Attribute))


def _scan_module(root: str, path: str) -> List[Violation]:
    mod = parse_module(path)
    tree = mod.tree
    if tree is None:
        return []
    rel = relpath(root, path)
    supp = mod.supp
    out: List[Violation] = []

    def flag(line: int, msg: str) -> None:
        if not suppressed(supp, line, CHECKER):
            out.append(Violation(CHECKER, rel, line, msg))

    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.While, ast.For, ast.AsyncFor)):
            continue
        if isinstance(loop, (ast.For, ast.AsyncFor)) and not (
            isinstance(loop.iter, ast.Call)
            and _terminal(loop.iter.func) == "range"
        ):
            # `for target in collection` with a per-item try/except is
            # iteration over DIFFERENT endpoints, not a retry of one —
            # only counted `for _ in range(attempts)` ladders are retries
            continue
        retry_handlers = []
        tries = [n for n in _scoped(loop.body) if isinstance(n, ast.Try)]
        for t in tries:
            retry_handlers.extend(_is_net_retry_try(t))
        if not retry_handlers:
            continue
        if not _loop_is_bounded(loop):
            flag(loop.lineno,
                 "unbounded network retry loop — bound it with a deadline "
                 "or attempt count (a permanent failure must fail, not hang)")
        # backoff: prefer sleeps on the handler path; a handler with none
        # falls back to the loop's iteration-level sleeps (the
        # `except: pass` + sleep-at-bottom shape)
        handler_sleeps = _sleeps([n for h in retry_handlers for n in h.body])
        sleeps = handler_sleeps or _sleeps(loop.body)
        if not sleeps:
            flag(loop.lineno,
                 "network retry loop with no backoff between attempts "
                 "(hot-hammers the failing endpoint)")
            continue
        for s in sleeps:
            if _sleep_is_constant(s):
                flag(s.lineno,
                     "network retry sleeps a constant period — every "
                     "retrier re-synchronizes; back off with jitter "
                     "(kungfu_tpu_torch.utils.retry)")
    # one loop can be visited via multiple ancestors during ast.walk? no —
    # walk yields each node once; but an inner loop's violations must not
    # also be attributed to the outer loop: _scoped() stops at nested
    # loops, so each Try belongs to exactly one loop
    return out


def check(root: str) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_py_files(root):
        out.extend(_scan_module(root, path))
    return out
