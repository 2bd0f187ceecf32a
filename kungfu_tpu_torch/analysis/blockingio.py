"""blocking-io checker: no unbounded blocking calls in threaded modules.

Port of ``kungfu_tpu/analysis/blockingio.py``: the same rule over the
port's tree.

Scope: any module under ``kungfu_tpu_torch`` that starts (or subclasses)
``threading.Thread``, plus modules whose code runs on channel/runner
background threads without spawning them locally
(``comm/engine.py``, ``runner/watch.py``).  In those modules a blocking
call with no timeout can wedge a daemon thread forever — the recent
transport racing-send hang and teardown use-after-free were exactly
this shape, caught after the fact.

Flagged when no ``timeout=`` is passed:

* ``urllib.request.urlopen`` / ``socket.create_connection``
  (positional timeout counts for the latter)
* ``.get()`` / ``.put()`` on objects constructed from ``queue.Queue``
  in the module (``block=False`` also satisfies the rule)
* ``.accept()`` / ``.recv()`` / ``.recvfrom()`` on anything — socket
  reads and channel receives both hang without a deadline
* ``subprocess.run`` / ``check_output`` / ``check_call`` /
  ``.communicate()`` / ``.wait()`` on process objects

A deliberate forever-block (e.g. a sentinel-terminated worker loop)
carries ``# kflint: allow(blocking-io)`` with a comment saying why.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_py_files,
    parse_module,
    relpath,
    suppressed,
    terminal_name as _terminal,
)

CHECKER = "blocking-io"

#: modules whose handlers run on background threads owned elsewhere.
#: The serve modules spawn threads today (auto-detected), but their
#: channel handlers ALSO run on the host channel's receive threads —
#: pinned here so a refactor that moves the spawns out cannot silently
#: drop the rule from the serving plane
EXTRA_THREAD_MODULES = {
    "kungfu_tpu_torch/comm/engine.py",
    "kungfu_tpu_torch/runner/watch.py",
    "kungfu_tpu_torch/serve/engine.py",
    "kungfu_tpu_torch/serve/router.py",
}

_SUBPROCESS_FNS = {"run", "check_output", "check_call"}
_SOCKETish_METHODS = {"accept", "recv", "recvfrom"}


def _has_kw(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


def _queue_call_bounded(node: ast.Call, method: str) -> bool:
    """True when a Queue.get/put call cannot block forever.  Signature
    ``get(block=True, timeout=None)`` / ``put(item, block=True,
    timeout=None)``: keyword block/timeout counts, and so do the legal
    POSITIONAL forms — ``get(False)``, ``get(True, 5.0)``,
    ``put(x, False)``, ``put(x, True, 2.0)``."""
    if _has_kw(node, "timeout") or _has_kw(node, "block"):
        return True
    pos = node.args if method == "get" else node.args[1:]
    if len(pos) >= 2:
        return True  # explicit positional timeout
    if len(pos) == 1:
        # block given positionally: only a literal False is provably
        # non-blocking; `get(True)` still blocks forever
        a = pos[0]
        return isinstance(a, ast.Constant) and a.value is False
    return False


def _spawns_threads(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _terminal(node.func) == "Thread":
            return True
        if isinstance(node, ast.ClassDef):
            for base in node.bases:
                if _terminal(base) == "Thread":
                    return True
    return False


def _queue_names(tree: ast.AST) -> Dict[str, bool]:
    """``{terminal name: bounded}`` for variables/attributes bound from
    queue.Queue().  ``put()`` can only block on a BOUNDED queue
    (``maxsize > 0``); ``get()`` blocks on any queue."""
    names: Dict[str, bool] = {}
    for node in ast.walk(tree):
        value = getattr(node, "value", None)
        if not (isinstance(value, ast.Call)
                and _terminal(value.func) in ("Queue", "SimpleQueue", "LifoQueue")):
            continue
        bounded = bool(value.args) or any(
            kw.arg == "maxsize" for kw in value.keywords)
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.target is not None:
            targets = [node.target]
        for t in targets:
            name = _terminal(t)
            if name:
                names[name] = bounded
    return names


def _scan_module(root: str, path: str) -> List[Violation]:
    mod = parse_module(path)
    tree = mod.tree
    if tree is None:
        return []
    rel = relpath(root, path)
    if not _spawns_threads(tree) and rel not in EXTRA_THREAD_MODULES:
        return []
    supp = mod.supp
    queues = _queue_names(tree)
    out: List[Violation] = []

    def flag(node: ast.Call, what: str) -> None:
        if not suppressed(supp, node.lineno, CHECKER):
            out.append(Violation(CHECKER, rel, node.lineno, what))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = _terminal(fn)
        if name == "urlopen" and not _has_kw(node, "timeout"):
            flag(node, "urlopen() without timeout= can hang the thread")
        elif name == "create_connection":
            if not _has_kw(node, "timeout") and len(node.args) < 2:
                flag(node, "create_connection() without a timeout")
        elif name in _SUBPROCESS_FNS and isinstance(fn, ast.Attribute) \
                and _terminal(fn.value) == "subprocess" \
                and not _has_kw(node, "timeout"):
            flag(node, f"subprocess.{name}() without timeout=")
        elif isinstance(fn, ast.Attribute):
            recv_name = _terminal(fn.value)
            if fn.attr in ("get", "put") and recv_name in queues:
                if fn.attr == "put" and not queues[recv_name]:
                    pass  # unbounded queue: put() never blocks
                elif not _queue_call_bounded(node, fn.attr):
                    flag(node, f"queue .{fn.attr}() without timeout= "
                               "blocks its thread forever")
            elif fn.attr in _SOCKETish_METHODS and not _has_kw(node, "timeout"):
                # sockets have no timeout kwarg at all — a read deadline
                # comes from settimeout(); restrict to receivers that are
                # recognizably sockets so channel recv() (whose *default*
                # timeout is bounded) stays out of scope
                if fn.attr == "accept" or (
                    recv_name and ("sock" in recv_name.lower()
                                   or recv_name.lower() in ("conn", "client"))
                ):
                    flag(node, f".{fn.attr}() on a socket without a "
                               "deadline (set settimeout, or suppress for "
                               "a connection-lifetime reader)")
            elif fn.attr in ("communicate", "wait") \
                    and recv_name not in (None, "self") \
                    and "popen" in (recv_name or "").lower() \
                    and not _has_kw(node, "timeout"):
                flag(node, f"process .{fn.attr}() without timeout=")
    return out


def check(root: str) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_py_files(root, dirs=("kungfu_tpu_torch",)):
        out.extend(_scan_module(root, path))
    return out
