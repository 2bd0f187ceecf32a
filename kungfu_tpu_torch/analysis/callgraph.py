"""Shared project call graph for the interprocedural (kf-verify) rules.

Port of ``kungfu_tpu/analysis/callgraph.py``: the same rule over the
port's tree.

Single-function lints see one AST at a time; the
protocol invariants this project actually breaks on — a collective
issued on one rank only, a lock taken under another module's lock — are
properties of *paths through the tree*.  This module builds the one
index those rules share:

* every function/method in the scan dirs, keyed by
  ``module::Class.method`` / ``module::func``;
* every call site inside each function, with its terminal callee name
  and the stack of enclosing ``if`` branches (so a rule can ask "is this
  call rank-conditional?");
* best-effort static resolution of a call site to project functions.

Resolution is deliberately conservative — precision over recall, because
these rules gate tier-1 and a false cycle/false divergence is a red
build:

* ``self.foo()`` resolves only within the enclosing class;
* a bare ``foo()`` resolves to the same module's ``foo`` or a
  ``from mod import foo`` binding;
* ``obj.foo()`` (non-self) resolves only when exactly one project
  function is named ``foo`` tree-wide (unique ⇒ unambiguous).

Anything unresolved is simply not an edge.  The graph is built once per
``check()`` pass and cached per root by :func:`project_graph`.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kungfu_tpu_torch.analysis.core import (PY_SCAN_DIRS, iter_py_files,
                                      parse_module, relpath)

#: method names answered by the builtin containers / sync primitives —
#: a cross-object call through one of these says nothing about WHICH
#: object, so it never resolves (``self.foo()`` / bare-name calls are
#: unaffected: those paths carry their own evidence)
_UBIQUITOUS_METHODS = (
    set(dir(dict)) | set(dir(list)) | set(dir(set)) | set(dir(str))
    | set(dir(bytes)) | {
        "put", "put_nowait", "get_nowait", "acquire", "release", "start",
        "close", "send", "recv", "sendall", "connect", "read", "write",
        "wait", "set", "is_set", "submit", "result", "cancel", "shutdown",
    }
)


@dataclass(frozen=True)
class Branch:
    """One enclosing conditional of a call site."""

    test: ast.AST  #: the ``if``/``while`` test expression
    side: str  #: "body" or "orelse"
    line: int


@dataclass
class CallSite:
    callee: str  #: terminal identifier (``self.peer.barrier`` -> "barrier")
    node: ast.Call
    line: int
    #: attribute receiver chain, e.g. ["self", "channel"] for
    #: ``self.channel.send(...)``; [] for a bare-name call
    receiver: Tuple[str, ...]
    branches: Tuple[Branch, ...]  #: innermost last


@dataclass
class FuncInfo:
    #: dotted path under the repo root ("kungfu_tpu_torch.comm.host")
    module: str
    cls: Optional[str]
    name: str
    path: str  #: repo-root relative
    node: ast.AST
    lineno: int
    calls: List[CallSite] = field(default_factory=list)
    #: enclosing function for nested defs (None at module/class level) —
    #: lets scope-aware consumers resolve a bare name to the RIGHT
    #: same-named nested def instead of every one in the module
    parent: Optional["FuncInfo"] = field(default=None, compare=False,
                                         repr=False)

    @property
    def qualname(self) -> str:
        prefix = f"{self.cls}." if self.cls else ""
        return f"{self.module}::{prefix}{self.name}"


def _terminal_and_receiver(func: ast.AST) -> Tuple[Optional[str], Tuple[str, ...]]:
    """``a.b.c(...)`` -> ("c", ("a", "b")); ``f(...)`` -> ("f", ())."""
    chain: List[str] = []
    n = func
    while isinstance(n, ast.Attribute):
        chain.append(n.attr)
        n = n.value
    if isinstance(n, ast.Name):
        chain.append(n.id)
    elif not chain:
        return None, ()
    chain.reverse()
    return chain[-1], tuple(chain[:-1])


def _module_of(root: str, path: str) -> str:
    rel = relpath(root, path)
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


class _FuncVisitor(ast.NodeVisitor):
    """Collect FuncInfos + their call sites with branch context."""

    def __init__(self, module: str, path: str):
        self.module = module
        self.path = path
        self.funcs: List[FuncInfo] = []
        self.imports: Dict[str, str] = {}  # local name -> source module
        self._cls: List[str] = []
        self._func_stack: List[FuncInfo] = []

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            self.imports[alias.asname or alias.name] = node.module or ""

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def _visit_func(self, node) -> None:
        info = FuncInfo(
            module=self.module,
            cls=self._cls[-1] if self._cls else None,
            name=node.name,
            path=self.path,
            node=node,
            lineno=node.lineno,
            parent=self._func_stack[-1] if self._func_stack else None,
        )
        self._collect_calls(node.body, info, ())
        self.funcs.append(info)
        # nested defs get their own FuncInfo (class context preserved)
        self._func_stack.append(info)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _collect_calls(self, stmts: Sequence[ast.stmt], info: FuncInfo,
                       branches: Tuple[Branch, ...]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes own their calls
            if isinstance(stmt, ast.If):
                for call in self._calls_in(stmt.test):
                    self._record(call, info, branches)
                b = Branch(stmt.test, "body", stmt.lineno)
                self._collect_calls(stmt.body, info, branches + (b,))
                o = Branch(stmt.test, "orelse", stmt.lineno)
                self._collect_calls(stmt.orelse, info, branches + (o,))
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                header = stmt.test if isinstance(stmt, ast.While) else stmt.iter
                for call in self._calls_in(header):
                    self._record(call, info, branches)
                self._collect_calls(stmt.body, info, branches)
                self._collect_calls(stmt.orelse, info, branches)
                continue
            if isinstance(stmt, ast.Try):
                self._collect_calls(stmt.body, info, branches)
                for h in stmt.handlers:
                    self._collect_calls(h.body, info, branches)
                self._collect_calls(stmt.orelse, info, branches)
                self._collect_calls(stmt.finalbody, info, branches)
                continue
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    for call in self._calls_in(item.context_expr):
                        self._record(call, info, branches)
                self._collect_calls(stmt.body, info, branches)
                continue
            for call in self._calls_in(stmt):
                self._record(call, info, branches)

    @staticmethod
    def _calls_in(node: Optional[ast.AST]) -> Iterable[ast.Call]:
        if node is None:
            return []
        return [n for n in ast.walk(node) if isinstance(n, ast.Call)]

    def _record(self, call: ast.Call, info: FuncInfo,
                branches: Tuple[Branch, ...]) -> None:
        callee, receiver = _terminal_and_receiver(call.func)
        if callee is None:
            return
        info.calls.append(CallSite(
            callee=callee, node=call, line=call.lineno,
            receiver=receiver, branches=branches,
        ))


class CallGraph:
    """The project-wide function index + conservative call resolution."""

    def __init__(self) -> None:
        self.functions: List[FuncInfo] = []
        self.by_qualname: Dict[str, FuncInfo] = {}
        self.by_name: Dict[str, List[FuncInfo]] = {}
        #: per-module ``from X import name`` bindings
        self.module_imports: Dict[str, Dict[str, str]] = {}

    @classmethod
    def build(cls, root: str,
              dirs: Iterable[str] = PY_SCAN_DIRS) -> "CallGraph":
        g = cls()
        for path in iter_py_files(root, dirs):
            try:
                tree = parse_module(path).tree
            except OSError:
                continue
            if tree is None:
                continue
            module = _module_of(root, path)
            v = _FuncVisitor(module, relpath(root, path))
            v.visit(tree)
            g.module_imports[module] = v.imports
            for f in v.funcs:
                g.functions.append(f)
                g.by_qualname[f.qualname] = f
                g.by_name.setdefault(f.name, []).append(f)
        return g

    # -- resolution ------------------------------------------------------
    def resolve(self, caller: FuncInfo, site: CallSite) -> List[FuncInfo]:
        """Project functions ``site`` may invoke (possibly empty)."""
        cands = self.by_name.get(site.callee, [])
        if not cands:
            return []
        if site.receiver and site.receiver[0] in ("self", "cls", "srv", "chan"):
            # method on the current object (incl. the `srv = self` /
            # `chan = self` closure idiom of the handler classes): same
            # class only — and only a direct attribute (`self.foo()`, not
            # `self.x.foo()`, which targets another object)
            if len(site.receiver) > 1 or caller.cls is None:
                return self._unique(cands)
            return [f for f in cands
                    if f.cls == caller.cls and f.module == caller.module]
        if not site.receiver:
            # bare name: same module, or an explicit from-import of it
            same = [f for f in cands
                    if f.module == caller.module and f.cls is None]
            if same:
                return same
            imported_from = self.module_imports.get(caller.module, {}).get(
                site.callee
            )
            if imported_from:
                hit = [f for f in cands
                       if f.cls is None and f.module.endswith(imported_from)]
                if hit:
                    return hit
            return []
        return self._unique(cands)

    @staticmethod
    def _unique(cands: List[FuncInfo]) -> List[FuncInfo]:
        """A cross-object call resolves only when unambiguous tree-wide —
        and never through a name every builtin container also answers
        (``d.clear()`` must not resolve to the one project ``clear``)."""
        if len(cands) != 1 or cands[0].name in _UBIQUITOUS_METHODS:
            return []
        return cands

    def callers_of(self, target: FuncInfo) -> List[Tuple[FuncInfo, CallSite]]:
        out: List[Tuple[FuncInfo, CallSite]] = []
        for f in self.functions:
            for site in f.calls:
                if site.callee != target.name:
                    continue
                if target in self.resolve(f, site):
                    out.append((f, site))
        return out


_GRAPH_CACHE: Dict[str, CallGraph] = {}


def project_graph(root: str) -> CallGraph:
    """Build (or reuse) the call graph for ``root`` — the kf-verify rules
    all run over one tree in one CLI pass, so one build serves all."""
    key = os.path.abspath(root)
    g = _GRAPH_CACHE.get(key)
    if g is None:
        g = _GRAPH_CACHE[key] = CallGraph.build(key)
    return g


def invalidate_cache() -> None:
    """Tests that rewrite a tree between checks call this.  The axis
    environment and the taint engine are derived from this graph and
    cascade with it; the protocol verifier's cache is keyed on this
    graph's identity, so it goes stale with it."""
    _GRAPH_CACHE.clear()
    from kungfu_tpu_torch.analysis import axisenv, taint

    axisenv.invalidate_cache()
    taint.invalidate_cache()
