"""jit-purity checker: no host syncs or side effects inside jitted or
captured code (port of ``kungfu_tpu/analysis/jitpurity.py``).

Inside any function whose body is traced into compiled code — decorated
with (or passed to) ``jax.jit`` / ``pmap`` / ``shard_map``, including
``functools.partial(jax.jit, ...)``, nested call forms like
``jit(shard_map(f, ...))`` and ``jit(value_and_grad(f))`` — and inside
every function reachable from one through the project call graph
(resolved calls AND callback references like ``lax.scan(step, ...)``,
to any depth, across modules), flag the classic host-round-trip and
side-effect calls:

* ``.item()`` / ``.tolist()`` / ``.block_until_ready()``
* ``float(x)`` / ``int(x)`` on non-static values (shape/len/ndim/size
  arithmetic and env-string parsing are trace-static and stay legal)
* ``np.asarray`` / ``np.array`` (device→host copy mid-trace)
* ``print`` (tracer leak; use ``jax.debug.print``)
* ``time.time()`` / ``time.monotonic()`` / ``time.perf_counter()``
  (traces to a constant — a silent correctness bug)

The port's counterpart of jit scope is **capture scope**
(:mod:`~kungfu_tpu_torch.analysis.axisenv`): a ``with
torch.cuda.graph(...)`` block, the lambdas and functions handed to a
capture-entry parameter (``serve/engine.py`` ``graphed(fn)``), and every
function they reach.  There CUDA refuses a host sync outright (the
capture fails), and host code runs once, at capture, never on replay.
Flagged there, besides the list above: ``.cpu()`` / ``.numpy()``,
``torch.cuda.synchronize()`` and any ``.synchronize()``; ``print`` and
the clock reads are flagged because they run once at capture.
``.numel()`` / ``.dim()`` / ``.size(...)`` are static like ``.shape``.

Reach comes from the shared
:mod:`~kungfu_tpu_torch.analysis.axisenv` jit- and capture-scope maps
(the same fixpoint the kf-shard rules use), so a sync two helpers deep
is attributed back to its root.  This rule also reports every file that
does not parse.  Suppress a deliberate sync with ``# kflint:
allow(jit-sync)``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from kungfu_tpu_torch.analysis.axisenv import axis_environment, fkey
from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_py_files,
    parse_module,
    relpath,
    suppressed,
    terminal_name as _terminal_name,
)

CHECKER = "jit-sync"

_SYNC_METHODS = {"item", "tolist", "block_until_ready"}
#: the port's device->host copies, flagged in capture scope
_CAPTURE_SYNC_METHODS = _SYNC_METHODS | {"cpu", "numpy", "synchronize"}
_STATIC_MARKERS = {"shape", "ndim", "size", "dtype", "itemsize", "nbytes",
                   "numel", "dim", "element_size"}
#: bare-call terminals whose result is a host value, not a tracer
_HOST_VALUE_BARE = {"len", "getenv", "axis_size"}
#: (method, receiver terminal) pairs that are host values — receiver-
#: qualified so `x.prod()`/`state.get()` on a TRACED x stay syncs
_HOST_VALUE_QUALIFIED = {
    ("get", "environ"), ("getenv", "os"),
    ("prod", "math"), ("prod", "np"), ("prod", "numpy"),
    ("ceil", "math"), ("floor", "math"),
    # lax.axis_size is a static mesh-axis extent — the exact remedy the
    # recompile-hazard messages prescribe (axis_index stays OUT: it
    # returns a tracer)
    ("axis_size", "lax"),
}


def _host_value_call(call: ast.Call,
                     static_names: Optional[Set[str]] = None) -> bool:
    fn = call.func
    name = _terminal_name(fn)
    if isinstance(fn, ast.Name):
        return name in _HOST_VALUE_BARE
    if isinstance(fn, ast.Attribute):
        if (name, _terminal_name(fn.value)) not in _HOST_VALUE_QUALIFIED:
            return False
        if name in ("prod", "ceil", "floor"):
            # np.prod(x.shape) is static; np.prod(x) on a TRACED x is a
            # host concretization — the math family qualifies only when
            # its own arguments are static
            return all(_is_static_expr(a, static_names)
                       for a in call.args)
        return True
    return False


def _module_aliases(tree: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(numpy aliases, time aliases) bound by this module's imports."""
    np_aliases: Set[str] = set()
    time_aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    np_aliases.add(a.asname or "numpy")
                if a.name == "time":
                    time_aliases.add(a.asname or "time")
    return np_aliases, time_aliases


def _is_static_expr(node: ast.AST,
                    static_names: Optional[Set[str]] = None) -> bool:
    """Shape arithmetic, env parsing, and other trace-time constants:
    legal under jit.  ``static_names`` are locals the enclosing body
    assigned from static expressions (``T = x.shape[0]``)."""
    if isinstance(node, ast.Constant):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_MARKERS:
            return True
        if isinstance(sub, ast.Call) \
                and _host_value_call(sub, static_names):
            return True
        if static_names and isinstance(sub, ast.Name) \
                and sub.id in static_names:
            return True
    return False


def _static_locals(stmts) -> Set[str]:
    """Names assigned from static expressions anywhere in the body —
    one flow-insensitive pass, transitive (``T = x.shape[0]; C = T * 2``)."""
    assigns: List[Tuple[str, ast.AST]] = []
    for stmt in stmts:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                assigns.append((n.targets[0].id, n.value))
    static: Set[str] = set()
    # to convergence, not a fixed pass count: textual order need not be
    # topological (chains assigned inside loops arrive reversed)
    for _ in range(len(assigns) + 1):
        grew = False
        for name, value in assigns:
            if name not in static and _is_static_expr(value, static):
                static.add(name)
                grew = True
        if not grew:
            break
    return static


class _BodyScan(ast.NodeVisitor):
    """Sync/side-effect call sites in one function body (nested defs
    included — they share the trace).  ``capture`` selects the port's
    capture-scope list and wording."""

    def __init__(self, np_aliases: Set[str], time_aliases: Set[str],
                 static_names: Optional[Set[str]] = None,
                 capture: bool = False) -> None:
        self.np_aliases = np_aliases
        self.time_aliases = time_aliases
        self.static_names = static_names or set()
        self.capture = capture
        self.hits: List[Tuple[int, str]] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.hits.append((node.lineno, what))

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        name = _terminal_name(fn)
        syncs = _CAPTURE_SYNC_METHODS if self.capture else _SYNC_METHODS
        if isinstance(fn, ast.Attribute):
            if fn.attr in syncs:
                self._flag(node, f".{fn.attr}() forces a host sync")
            base = _terminal_name(fn.value)
            if base in self.np_aliases and fn.attr in ("asarray", "array"):
                self._flag(node,
                           f"{base}.{fn.attr}() copies device→host mid-trace")
            if base in self.time_aliases and fn.attr in (
                "time", "monotonic", "perf_counter",
            ):
                self._flag(
                    node,
                    f"{base}.{fn.attr}() runs once at capture (replays keep "
                    f"the stale clock)" if self.capture else
                    f"{base}.{fn.attr}() traces to a constant (stale clock)",
                )
        elif isinstance(fn, ast.Name):
            if name == "print":
                self._flag(node, "print() in captured code runs once at "
                                 "capture, never on replay" if self.capture
                           else "print() in jitted code (use jax.debug.print)")
            elif name in ("float", "int") and node.args:
                if not _is_static_expr(node.args[0], self.static_names):
                    self._flag(
                        node,
                        f"{name}() on a traced value forces a host sync",
                    )
        self.generic_visit(node)


def check(root: str) -> List[Violation]:
    env = axis_environment(root)
    alias_cache: Dict[str, Tuple[Set[str], Set[str]]] = {}

    def aliases_for(path: str) -> Tuple[Set[str], Set[str]]:
        if path not in alias_cache:
            tree = parse_module(os.path.join(root, path)).tree
            alias_cache[path] = (_module_aliases(tree) if tree is not None
                                 else (set(), set()))
        return alias_cache[path]

    out: List[Violation] = []
    seen: Set[Tuple[str, int, str]] = set()

    # an unparseable file is invisible to EVERY rule — this checker owns
    # surfacing it (as it did pre-callgraph), so the suite cannot go
    # green on a tree it could not actually analyze
    for path in iter_py_files(root):
        err = parse_module(path).error
        if err is not None:
            out.append(Violation(
                CHECKER, relpath(root, path), err.lineno or 1,
                f"syntax error prevents analysis: {err.msg}"))

    def report(func, stmts, scope: str, via: str, capture: bool) -> None:
        np_aliases, time_aliases = aliases_for(func.path)
        scan = _BodyScan(np_aliases, time_aliases, _static_locals(stmts),
                         capture=capture)
        for stmt in stmts:
            scan.visit(stmt)
        if not scan.hits:
            return
        supp = parse_module(os.path.join(root, func.path)).supp
        for line, what in scan.hits:
            key = (func.path, line, what)
            if key in seen or suppressed(supp, line, CHECKER):
                continue
            seen.add(key)
            out.append(Violation(CHECKER, func.path, line,
                                 f"in {scope}{via}: {what}"))

    for func in env.graph.functions:
        roots = env.jit_roots.get(fkey(func))
        if roots:
            is_root = func.name in roots
            via = "" if is_root else (
                f" (called from jitted {sorted(roots)[0]})")
            report(func, func.node.body, f"jit scope `{func.name}`", via,
                   False)
        croots = env.capture_roots.get(fkey(func))
        if croots:
            via = "" if func.name in croots else (
                f" (called from captured {sorted(croots)[0]})")
            report(func, func.node.body, f"capture scope `{func.name}`",
                   via, True)
    # the capture blocks and the lambdas run under capture themselves
    for func, block, prov in env.capture_regions:
        report(func, block.body, f"capture scope `{func.name}`",
               f" ({prov})", True)
    for func, lam, prov in env.capture_lambdas:
        report(func, [ast.Expr(lam.body)], "capture scope `<lambda>`",
               f" (passed to {prov})", True)

    return sorted(out, key=lambda v: (v.path, v.line, v.message))
