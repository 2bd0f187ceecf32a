"""lock-order checker: cross-module deadlock cycles in Python threading.

Port of ``kungfu_tpu/analysis/pylockorder.py``: the same rule over the
port's tree.

The ``lock-discipline`` checker guards the native transport's
mutexes; the Python side (the detector's signal intake, the host
channel's queue/pool locks, the chaos controller, the config server)
has its own lock web — and an AB/BA inversion between two
modules is exactly the bug no single-module review sees.  This rule
builds a project-wide lock-acquisition graph and reports cycles.

**Lock identity.**  ``self.ATTR = threading.Lock()/RLock()`` registers
``(module, Class, ATTR)``; ``NAME = threading.Lock()`` at module level
registers ``(module, NAME)``.  A ``with self.ATTR:`` (or the
``srv = self`` closure idiom: ``with srv.ATTR:`` where exactly one class
in the module owns ``ATTR``) is an acquisition; ``lk.acquire()`` holds
until the matching ``.release()`` or function end.

**Edges.**  While lock A is held, acquiring B adds A→B — directly, or
**interprocedurally**: a call made under A adds A→X for every lock X
the (conservatively resolved, see :mod:`~kungfu_tpu_torch.analysis.callgraph`)
callee may transitively acquire.  A cycle in the resulting graph is a
potential deadlock; an A→A edge on a non-reentrant ``Lock`` is a
guaranteed self-deadlock and is reported separately.

Known limits (precision over recall — this gates tier-1):

* locks reached through containers (``entry[1]``) or handed across
  objects are invisible;
* unresolvable calls contribute no edges, so a cycle through a callback
  indirection is missed;
* ordering enforced by *runtime* discipline (e.g. always-sorted
  acquisition over a lock list) must carry
  ``# kflint: allow(lock-order)`` where it closes a textual cycle.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from kungfu_tpu_torch.analysis.callgraph import (
    CallGraph,
    FuncInfo,
    project_graph,
)
from kungfu_tpu_torch.analysis.core import (
    Violation,
    parse_module,
    suppressed,
)

CHECKER = "lock-order"

_LOCK_CTORS = {"Lock", "RLock"}

#: lock id: (module, owner-class or None, attr/name)
LockId = Tuple[str, Optional[str], str]


def _fmt_lock(lk: LockId) -> str:
    mod, cls, name = lk
    return f"{mod}::{cls}.{name}" if cls else f"{mod}::{name}"


def _lock_ctor_kind(node: ast.AST) -> Optional[str]:
    """"Lock"/"RLock" when ``node`` is a ``threading.Lock()`` style call."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None
    )
    return name if name in _LOCK_CTORS else None


class _LockIndex:
    """All declared locks, by (module, class, attr) and per-module attr."""

    def __init__(self) -> None:
        self.kinds: Dict[LockId, str] = {}
        #: (module, attr) -> owning classes (for the srv/chan closure idiom)
        self.attr_owners: Dict[Tuple[str, str], List[Optional[str]]] = {}

    def declare(self, lk: LockId, kind: str) -> None:
        if lk in self.kinds:
            return
        self.kinds[lk] = kind
        self.attr_owners.setdefault((lk[0], lk[2]), []).append(lk[1])

    def resolve_attr(self, module: str, cls: Optional[str],
                     attr: str) -> Optional[LockId]:
        """``self.attr`` / ``srv.attr`` -> lock id, preferring the
        enclosing class, else the unique owner in the module."""
        if cls is not None and (module, cls, attr) in self.kinds:
            return (module, cls, attr)
        owners = self.attr_owners.get((module, attr), [])
        if len(owners) == 1:
            return (module, owners[0], attr)
        return None

    def resolve_name(self, module: str, name: str) -> Optional[LockId]:
        lk = (module, None, name)
        return lk if lk in self.kinds else None


def _build_lock_index(graph: CallGraph, root: str) -> _LockIndex:
    idx = _LockIndex()
    seen_modules: Set[str] = set()
    for f in graph.functions:
        # self.X = threading.Lock() inside any method of the class
        for node in ast.walk(f.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            kind = _lock_ctor_kind(node.value)
            if kind is None:
                continue
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and f.cls is not None:
                idx.declare((f.module, f.cls, t.attr), kind)
        seen_modules.add((f.module, f.path))
    # module-level locks: re-parse top-level assigns of each module
    for module, rel in sorted(seen_modules):
        try:
            tree = parse_module(os.path.join(root, rel)).tree
        except OSError:
            continue
        if tree is None:
            continue
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                kind = _lock_ctor_kind(node.value)
                if kind is not None:
                    idx.declare((module, None, node.targets[0].id), kind)
    return idx


def _lock_of_expr(expr: ast.AST, func: FuncInfo,
                  idx: _LockIndex) -> Optional[LockId]:
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        return idx.resolve_attr(func.module, func.cls, expr.attr)
    if isinstance(expr, ast.Name):
        return idx.resolve_name(func.module, expr.id)
    return None


class _FuncLocks(ast.NodeVisitor):
    """Per-function pass: direct acquisitions, nested-order edges, and
    call sites made while holding locks."""

    def __init__(self, func: FuncInfo, idx: _LockIndex):
        self.func = func
        self.idx = idx
        self.acquires: Set[LockId] = set()
        #: (held, acquired, line) direct nesting edges
        self.edges: List[Tuple[LockId, LockId, int]] = []
        #: (held-set frozen, callee terminal, receiver, line)
        self.held_calls: List[Tuple[Tuple[LockId, ...], ast.Call, int]] = []
        self._held: List[LockId] = []

    def run(self) -> "_FuncLocks":
        self._stmts(self.func.node.body)
        return self

    def _stmts(self, body) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes analyzed as their own functions
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.With):
            acquired: List[LockId] = []
            for item in stmt.items:
                self._expr(item.context_expr)
                lk = _lock_of_expr(item.context_expr, self.func, self.idx)
                if lk is not None:
                    self._acquire(lk, stmt.lineno)
                    acquired.append(lk)
            self._stmts(stmt.body)
            for lk in reversed(acquired):
                # an explicit release() inside the body (the lock-handoff
                # pattern) may have dropped it already
                if lk in self._held:
                    self._held.remove(lk)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for h in stmt.handlers:
                self._stmts(h.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
            return
        # explicit acquire()/release() pairs at statement level
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in ("acquire",
                                                           "release"):
                lk = _lock_of_expr(f.value, self.func, self.idx)
                if lk is not None:
                    if f.attr == "acquire":
                        self._acquire(lk, stmt.lineno)
                    elif lk in self._held:
                        self._held.remove(lk)
                    return
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                self._call(node)

    def _expr(self, expr: Optional[ast.AST]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._call(node)

    def _acquire(self, lk: LockId, line: int) -> None:
        self.acquires.add(lk)
        for held in self._held:
            self.edges.append((held, lk, line))
        self._held.append(lk)

    def _call(self, call: ast.Call) -> None:
        if self._held:
            self.held_calls.append((tuple(self._held), call, call.lineno))


def check(root: str) -> List[Violation]:
    graph = project_graph(root)
    idx = _build_lock_index(graph, root)
    if not idx.kinds:
        return []

    passes = {f.qualname: _FuncLocks(f, idx).run() for f in graph.functions}

    # transitive may-acquire fixpoint over resolved call edges
    call_edges: Dict[str, Set[str]] = {}
    for f in graph.functions:
        targets: Set[str] = set()
        for site in f.calls:
            for callee in graph.resolve(f, site):
                targets.add(callee.qualname)
        call_edges[f.qualname] = targets
    may: Dict[str, Set[LockId]] = {
        q: set(p.acquires) for q, p in passes.items()
    }
    changed = True
    while changed:
        changed = False
        for q, targets in call_edges.items():
            for t in targets:
                extra = may.get(t, set()) - may[q]
                if extra:
                    may[q] |= extra
                    changed = True

    # assemble the lock graph: direct nesting edges + call-under-lock
    # edges; remember one witness (path, line, note) per edge
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}
    supp_cache: Dict[str, Dict[int, set]] = {}

    def supp_for(path: str) -> Dict[int, set]:
        if path not in supp_cache:
            supp_cache[path] = parse_module(
                os.path.join(root, path)).supp
        return supp_cache[path]

    def add_edge(a: LockId, b: LockId, path: str, line: int,
                 note: str) -> None:
        if suppressed(supp_for(path), line, CHECKER):
            return
        edges.setdefault((a, b), (path, line, note))

    out: List[Violation] = []
    for f in graph.functions:
        p = passes[f.qualname]
        for a, b, line in p.edges:
            add_edge(a, b, f.path, line, "nested `with`")
        for held, call, line in p.held_calls:
            # re-resolve this call through the graph
            for site in f.calls:
                if site.node is call:
                    for callee in graph.resolve(f, site):
                        for lk in may.get(callee.qualname, ()):
                            for h in held:
                                add_edge(h, lk, f.path, line,
                                         f"call into {callee.name}()")
                    break

    # self-deadlock: A -> A on a non-reentrant Lock
    for (a, b), (path, line, note) in sorted(
            edges.items(), key=lambda kv: (_fmt_lock(kv[0][0]),
                                           _fmt_lock(kv[0][1]))):
        if a == b and idx.kinds.get(a) == "Lock":
            out.append(Violation(
                CHECKER, path, line,
                f"non-reentrant lock {_fmt_lock(a)} may be re-acquired "
                f"while already held ({note}) — guaranteed self-deadlock"))

    # cycles: DFS over the lock digraph (self-edges reported above)
    adj: Dict[LockId, List[LockId]] = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, []).append(b)
    reported: Set[frozenset] = set()

    def dfs(start: LockId, node: LockId, path: List[LockId],
            visiting: Set[LockId]) -> None:
        for nxt in sorted(adj.get(node, []), key=_fmt_lock):
            if nxt == start and len(path) > 1:
                key = frozenset(path)
                if key in reported:
                    continue
                reported.add(key)
                steps = []
                for i, lk in enumerate(path):
                    nlk = path[(i + 1) % len(path)]
                    wpath, wline, note = edges[(lk, nlk)]
                    steps.append(
                        f"{_fmt_lock(lk)} -> {_fmt_lock(nlk)} "
                        f"({wpath}:{wline}, {note})")
                wpath, wline, _ = edges[(path[0], path[1 % len(path)])]
                out.append(Violation(
                    CHECKER, wpath, wline,
                    "lock-order cycle (potential deadlock): "
                    + "; ".join(steps)))
            elif nxt not in visiting:
                visiting.add(nxt)
                dfs(start, nxt, path + [nxt], visiting)
                visiting.discard(nxt)

    for start in sorted(adj, key=_fmt_lock):
        dfs(start, start, [start], {start})

    return sorted(out, key=lambda v: (v.path, v.line, v.message))
