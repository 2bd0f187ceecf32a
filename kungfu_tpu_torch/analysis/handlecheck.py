"""handle-discipline checker: async collective handles must settle.

Port of ``kungfu_tpu/analysis/handlecheck.py``: the same rule over the
port's tree.

kf-overlap made collectives issueable (``all_reduce_async`` /
``reduce_scatter_async`` / ``all_gather_async`` return a
:class:`~kungfu_tpu_torch.comm.engine.CollectiveHandle`), which creates three
brand-new ways to write a latent hang or a silent data loss:

* **dropped** — the call's result is discarded.  The collective still
  runs and still consumes the in-flight window, but its typed failure
  (``PeerFailureError`` with the suspect rank) can never surface: the
  first symptom is the NEXT collective wedging on a stranded recv.
* **never waited / not waited on every path** — an early ``return`` (or
  an ``if`` with a wait on only one side) leaks the handle past its
  issuing scope; same failure mode, harder to find.
* **held across a membership change** — ``elastic_step`` / the shrink
  ladder rebuild the engine for the new epoch; a handle issued before
  the change references the OLD epoch's tags and peer set.  The engine
  fences this at runtime (``drain_async`` in ``Peer._propose`` and
  ``shrink_to_survivors``), but code that *waits on the stale handle
  after the change* is wrong even when the drain saves the wire — the
  lint catches it statically.

Scope and mechanics (per function, conservative): a handle is a name
assigned directly from a ``*_async(...)`` call.  A handle **settles**
when ``<name>.wait(...)`` is called; it **escapes** (ownership
transferred — fine) when returned/yielded, passed as a call argument
(e.g. ``handles.append(h)``), stored into an attribute/subscript, or
placed in a container literal.  ``*_async`` calls nested inside larger
expressions already flow somewhere and are not tracked.  Path checking
is block-structured (if/else both sides, try body+handlers or finally),
not a full CFG — suppress deliberate exceptions with
``# kflint: allow(handle-discipline)`` and a comment saying why.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_py_files,
    parse_module,
    relpath,
    suppressed,
    terminal_name as _terminal,
)

CHECKER = "handle-discipline"

#: call sites that apply a membership change — a live handle must not
#: straddle one (the engine's runtime drain is the belt; this is the
#: suspenders)
_FENCE_CALLS = {
    "elastic_step", "shrink_to_survivors", "recover_from_peer_failure",
    "recover_from_failure", "propose_new_size", "resize_cluster",
    "resize_cluster_from_url", "_propose",
    # the serving plane's membership boundary (kf-serve): excluding a
    # worker/slice re-dispatches its in-flight requests — a live async
    # handle must not straddle that either
    "mark_worker_dead",
    # kf-pipeline stage re-carve (parallel/pp.py): the boundary's
    # segment exchange reuses the host channel and the post-carve world
    # has a different stage map — a handle issued under the old stage
    # geometry (its tags name the old epoch's virtual stages) must
    # settle before the carve, exactly like a resize
    "recarve", "recarve_stages_after_shrink", "recarve_after_shrink",
    # kf-persist (elastic/persist.py): a live async handle must not
    # straddle the durable plane's boundaries either.  restore_from_
    # manifest rebuilds state from disk — a handle issued against the
    # pre-restore state would settle into a world that no longer exists;
    # persist_fence drains the plane's own internally-tracked writes, so
    # an explicitly-held handle crossing it is at best a double-wait
    # and usually a straddle bug
    "persist_fence", "restore_from_manifest",
}

_WAIT_ATTRS = {"wait"}

#: ``*_async``-named calls that do NOT return a handle (the drain is
#: the fence itself — its return value is a drained count)
_NON_ISSUE = {"drain_async"}


def _is_async_issue(call: ast.Call) -> bool:
    name = _terminal(call.func)
    return bool(name) and name.endswith("_async") and name not in _NON_ISSUE


def _stmt_settles(stmt: ast.stmt, name: str) -> bool:
    """Does executing this single statement wait or escape ``name``?
    (Looks only at the statement's own expressions — compound bodies are
    the path walker's job.)  Nested function definitions are opaque."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return False
    nodes = (
        list(ast.walk(stmt)) if not isinstance(
            stmt, (ast.If, ast.For, ast.While, ast.Try, ast.With))
        else [n for expr in _stmt_exprs(stmt) for n in ast.walk(expr)]
    )
    for n in nodes:
        if isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Attribute) and f.attr in _WAIT_ATTRS
                    and isinstance(f.value, ast.Name)
                    and f.value.id == name):
                return True
            for a in list(n.args) + [k.value for k in n.keywords]:
                if _expr_mentions(a, name):
                    return True  # passed on: ownership transferred
        elif isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)):
            v = getattr(n, "value", None)
            if v is not None and _expr_mentions(v, name):
                return True
        elif isinstance(n, (ast.List, ast.Tuple, ast.Set, ast.Dict)):
            if _expr_mentions(n, name):
                return True
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)) \
                    and _expr_mentions(stmt.value, name):
                return True
    return False


def _stmt_exprs(stmt: ast.stmt) -> List[ast.expr]:
    """The header expressions of a compound statement (test/iter/items)
    — the parts that execute before its body."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, ast.For):
        return [stmt.iter]
    if isinstance(stmt, ast.With):
        return [i.context_expr for i in stmt.items]
    return []


def _expr_mentions(node: ast.expr, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


#: tri-state path verdicts for one block: every path settled the handle
#: / some path left the function with it live / fell through unsettled
_SETTLED, _LEAKED, _FLOWS = "settled", "leaked", "flows"


def _walk_paths(stmts: List[ast.stmt], name: str) -> str:
    for st in stmts:
        if _stmt_settles(st, name):
            return _SETTLED
        if isinstance(st, (ast.Return, ast.Raise)):
            return _LEAKED  # leaves the function with the handle live
        if isinstance(st, ast.If):
            a = _walk_paths(st.body, name)
            b = _walk_paths(st.orelse, name) if st.orelse else _FLOWS
            if _LEAKED in (a, b):
                return _LEAKED
            if a == _SETTLED and b == _SETTLED:
                return _SETTLED
            # one side settled, the other falls through: keep scanning —
            # the fall-through path still needs a settle below
        elif isinstance(st, ast.Try):
            if _walk_paths(st.finalbody, name) == _SETTLED:
                return _SETTLED  # finally runs on every exit, even return
            b = _walk_paths(st.body, name)
            if b == _LEAKED:
                return _LEAKED
            hs = [_walk_paths(h.body, name) for h in st.handlers]
            # a handler that re-raises abandons the handle deliberately
            # (the failure is the collective's own); one that swallows
            # and falls through keeps the obligation alive
            if b == _SETTLED and all(
                    h == _SETTLED or (hh.body
                                      and isinstance(hh.body[-1], ast.Raise))
                    for h, hh in zip(hs, st.handlers)):
                return _SETTLED
            if any(h == _LEAKED for h in hs):
                return _LEAKED
        elif isinstance(st, ast.With):
            t = _walk_paths(st.body, name)
            if t != _FLOWS:
                return t
        # loops: a settle inside may run zero times — no guarantee
    return _FLOWS


def _block_settles(stmts: List[ast.stmt], name: str) -> bool:
    """Block-structured guarantee: executing ``stmts`` settles ``name``
    on EVERY path (an early return/raise without a settle is a leak)."""
    return _walk_paths(stmts, name) == _SETTLED


def _settled_anywhere(stmts: List[ast.stmt], name: str) -> bool:
    for st in stmts:
        for n in ast.walk(st):
            if isinstance(n, ast.stmt) and _stmt_settles(n, name):
                return True
    return False


def _fence_before_settle(stmts: List[ast.stmt], name: str
                         ) -> Optional[ast.Call]:
    """First membership-change call executed while ``name`` is still
    live (scanning stops at the first statement guaranteeing a
    settle)."""
    for st in stmts:
        if _stmt_settles(st, name):
            return None
        for n in ast.walk(st):
            if isinstance(n, ast.Call) and _terminal(n.func) in _FENCE_CALLS:
                return n
        if isinstance(st, ast.If) and st.orelse \
                and _block_settles(st.body, name) \
                and _block_settles(st.orelse, name):
            return None
        if isinstance(st, ast.Try) and (
                _block_settles(st.finalbody, name)
                or _block_settles(st.body, name)):
            return None
        if isinstance(st, ast.With) and _block_settles(st.body, name):
            # a wait inside a with-block settles before the block exits
            # — a fence AFTER the with is fine (the fence scan above
            # already covered a fence inside it, conservatively)
            return None
    return None


def _continuation(body: List[ast.stmt], target: ast.stmt
                  ) -> Optional[List[ast.stmt]]:
    """The statements that execute after ``target`` within ``body``'s
    block structure: the suffix of the innermost block holding it,
    then the suffixes of each enclosing block, flattened in execution
    order.  None when ``target`` is not under ``body``."""
    for i, st in enumerate(body):
        if st is target:
            return list(body[i + 1:])
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue  # a nested scope owns its own discipline
        for sub in (getattr(st, "body", None), getattr(st, "orelse", None),
                    getattr(st, "finalbody", None)):
            if sub:
                got = _continuation(sub, target)
                if got is not None:
                    return got + list(body[i + 1:])
        for h in getattr(st, "handlers", []) or []:
            got = _continuation(h.body, target)
            if got is not None:
                return got + list(body[i + 1:])
    return None


def _scan_function(fn, rel: str, supp, out: List[Violation]) -> None:
    def flag(line: int, msg: str) -> None:
        if not suppressed(supp, line, CHECKER):
            out.append(Violation(CHECKER, rel, line, msg))

    # statements of THIS function only — nested defs are scanned as
    # their own functions by _scan_module's walk
    own_stmts: List[ast.stmt] = []
    stack: List[ast.stmt] = list(fn.body)
    while stack:
        n = stack.pop()
        own_stmts.append(n)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        stack.extend(s for s in ast.iter_child_nodes(n)
                     if isinstance(s, ast.stmt))
        stack.extend(s for h in getattr(n, "handlers", []) or []
                     for s in h.body)
    for st in own_stmts:
        # dropped: the call IS the statement — result discarded
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) \
                and _is_async_issue(st.value):
            flag(st.lineno,
                 f"async handle from {_terminal(st.value.func)}() is "
                 "dropped — its typed failure (PeerFailureError with the "
                 "suspect rank) can never surface; wait() it or hand it "
                 "to an owner")
            continue
        if not (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and isinstance(st.value, ast.Call)
                and _is_async_issue(st.value)):
            continue
        name = st.targets[0].id
        cont = _continuation(fn.body, st)
        if cont is None:
            continue
        verb = _terminal(st.value.func)
        if not _settled_anywhere(cont, name):
            flag(st.lineno,
                 f"async handle {name!r} from {verb}() is never waited "
                 "in this function and never escapes it — a leaked "
                 "in-flight collective")
            continue
        if not _block_settles(cont, name):
            flag(st.lineno,
                 f"async handle {name!r} from {verb}() is not waited on "
                 "every control-flow path (an early return or one-sided "
                 "branch leaks the in-flight collective)")
        fence = _fence_before_settle(cont, name)
        if fence is not None:
            flag(fence.lineno,
                 f"membership-change call {_terminal(fence.func)}() runs "
                 f"while async handle {name!r} is still in flight — a "
                 "handle may never cross a resize/shrink boundary; "
                 "wait() it first (the engine drain is the runtime "
                 "backstop, not a license)")


def _scan_module(root: str, path: str) -> List[Violation]:
    mod = parse_module(path)
    if mod.tree is None:
        return []
    rel = relpath(root, path)
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _scan_function(node, rel, mod.supp, out)
    return out


def check(root: str) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_py_files(root):
        out.extend(_scan_module(root, path))
    return out
