"""Axis-environment abstract interpretation — the kf-shard substrate
(port of ``kungfu_tpu/analysis/axisenv.py``).

The reference's jax idioms are read as source text (never imported) and
give the reference's environments, so its fixtures lint the same; the
port's own idioms are read beside them:

* **constants** — the port's axis tables resolve through the same
  constant table (``parallel/mesh.py`` ``AXIS_DP`` ... ``AXES``,
  ``comm/device.py`` ``HOST_AXIS``/``LOCAL_AXIS``);
* **rank worlds** — ``rank_world([(name, size), ...])``
  (``ops/collective.py``) declares the names of a literal pair list;
  a function that returns one (``Mesh.world()``, ``Communicator.world()``)
  is a *world method* whose axes are its class's, found through
  ``self.axes``-style class attributes;
* **world contexts** — the body of ``with <mesh>.world():``, ``with
  <comm>.world():`` or ``with rank_world(...):`` binds its axes for the
  calls inside it, as a ``shard_map`` body does.  A world REPLACES the
  enclosing one (the port's collectives read the innermost world only),
  so a call inside the block carries exactly that world's context, and
  the functions it calls receive it through a binding instead of the
  plain call edge.  A dynamic pair list (``rank_world([(axis, 1)])``),
  ``use_world(w)`` or a receiver whose class is unknown gives an *open*
  context;
* **capture scope** — the counterpart of jit scope: the body of a
  ``with torch.cuda.graph(...)`` block, every function reached from it
  through calls and callback references, ``torch.compile`` /
  ``torch.cuda.make_graphed_callables`` targets, and *capture-entry
  parameters*: a helper that calls its own parameter inside a capture
  block (``serve/engine.py`` ``graphed(fn)``) makes every function or
  lambda its callers pass there a capture root.  Lambdas are kept as
  regions (:attr:`AxisEnv.capture_lambdas`), since they have no
  :class:`FuncInfo`.

The sharding bugs that only surface at trace time on a pod are all
*environment* bugs: a collective names a mesh axis that is not bound
where it runs, a ``PartitionSpec`` names an axis its mesh never
declared, a jitted closure bakes the world size in as a Python
constant.  This module computes, once per tree, everything the three
kf-shard rules (``shard-axis``, ``shard-spec``, ``recompile-hazard``)
need to see those statically:

* a project-wide **constant table** (module-level ``AXIS_DP = "dp"`` /
  ``AXES = (AXIS_DP, ...)`` bindings, resolved through imports);
* every **mesh**: ``Mesh(...)`` constructors, functions that return
  one (``MeshPlan.build_mesh``), and ``self.mesh = ...`` class
  attributes — each reduced to its frozenset of axis names where the
  names are static, plus the **global axis vocabulary** (every axis
  any mesh/pmap in the tree declares);
* the **axis environment of every function**, as a set of *contexts*:
  a function directly passed to ``shard_map``/``pmap`` (call form,
  decorator form, ``functools.partial(shard_map, mesh=...)`` aliases,
  and mesh-entry *parameters* like ``Communicator._shard_jit(body)``)
  gets the mapped mesh's axes as a context; functions it calls — or
  references as callbacks (``value_and_grad(self._local_loss)``,
  ``lax.scan(step, ...)``) — inherit each caller context through a
  fixpoint over the shared :mod:`~kungfu_tpu_torch.analysis.callgraph`.
  Contexts are kept SEPARATE, not unioned: a helper reached from two
  meshes with different axis sets must be valid in each (an axis from
  mesh A is a bug when the helper runs under mesh B — union-merging
  would hide exactly that).  A context whose mesh could not be
  resolved is *open* (more axes may be live), and open contexts never
  prove an axis absent, so unresolved indirection loses recall, never
  precision;
* **jit-scope membership** with root attribution — which functions'
  bodies end up traced into compiled code (``jax.jit``/``pmap``/
  ``shard_map`` roots plus everything reachable through calls and
  callback references), shared with the migrated ``jit-sync`` rule.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from kungfu_tpu_torch.analysis.callgraph import (
    CallGraph,
    FuncInfo,
    _terminal_and_receiver,
    project_graph,
)
from kungfu_tpu_torch.analysis.core import terminal_name

#: constructors that declare mesh axis names (arg 1 / ``axis_names=``)
MESH_CTORS = {"Mesh", "AbstractMesh", "make_mesh"}

#: wrappers that bind mesh axes over a mapped function
MAP_WRAPPERS = {"shard_map", "pmap"}

#: wrappers that enter jit scope (compiled-code membership)
JIT_WRAPPERS = {"jit"} | MAP_WRAPPERS

#: transparent wrappers a jitted function threads through —
#: ``jit(value_and_grad(f))`` traces ``f``
TRANSPARENT_WRAPPERS = {
    "grad", "value_and_grad", "vmap", "checkpoint", "remat", "partial",
}

#: the port's rank-world constructor: a literal ``[(name, size), ...]``
WORLD_CTORS = {"rank_world"}

#: re-entry of a world captured earlier: its axes are not static
WORLD_REENTRY = {"use_world"}

#: methods whose unresolved call in a ``with`` item still enters a world
#: (open): ``<unknown>.world()``
WORLD_METHODS = {"world"}

#: ``torch.compile(f)`` / ``torch.cuda.make_graphed_callables(f, ...)``:
#: capture roots by wrapping
CAPTURE_WRAPPERS = {"compile", "make_graphed_callables"}

_EVAL_FAIL = object()  #: sentinel: expression is not statically constant

#: unique per-function key: qualnames COLLIDE for same-named nested
#: defs (every builder has a ``body``), and collisions would merge —
#: i.e. cross-contaminate — their axis environments
FKey = Tuple[str, int]


def fkey(func: FuncInfo) -> FKey:
    return (func.qualname, func.lineno)


# ---------------------------------------------------------------------------
# contexts

@dataclass(frozen=True)
class Ctx:
    """One axis environment a function may execute under.

    ``axes`` are the names proven bound; ``open`` means the mesh (or an
    enclosing one) could not be resolved, so MORE axes may be live and
    absence cannot be proven."""

    axes: FrozenSet[str]
    open: bool

    def merged(self, axes: Optional[FrozenSet[str]]) -> "Ctx":
        if axes is None:
            return Ctx(self.axes, True)
        return Ctx(self.axes | axes, self.open)


@dataclass
class ShardMapSite:
    """One ``shard_map(...)`` call site, for the shard-spec rule."""

    func: FuncInfo                      #: the function containing the call
    node: ast.Call
    axes: Optional[FrozenSet[str]]      #: mesh axes (None = unresolved)
    targets: List[FuncInfo]             #: resolved mapped functions
    in_specs: Optional[ast.AST]
    out_specs: Optional[ast.AST]


@dataclass
class JitSite:
    """One ``jit(...)`` call/decorator, for the recompile-hazard rule."""

    func: FuncInfo                      #: containing function
    node: ast.Call
    targets: List[FuncInfo]             #: resolved jitted functions
    static_argnums: Optional[ast.AST]
    static_argnames: Optional[ast.AST]


class AxisEnv:
    def __init__(self, root: str, graph: CallGraph) -> None:
        self.root = root
        self.graph = graph
        #: module -> {name: value expr AST} (module-level constants)
        self.consts: Dict[str, Dict[str, ast.AST]] = {}
        #: every axis name any mesh/pmap in the tree declares
        self.vocabulary: Set[str] = set()
        #: fkey -> {Ctx: provenance string}
        self.contexts: Dict[FKey, Dict[Ctx, str]] = {}
        #: fkey -> root names whose trace this function joins
        self.jit_roots: Dict[FKey, Set[str]] = {}
        self.shard_sites: List[ShardMapSite] = []
        self.jit_sites: List[JitSite] = []
        #: (module, cls, attr) -> axes for ``self.attr = <mesh>``
        self.class_mesh: Dict[Tuple[str, Optional[str], str],
                              Optional[FrozenSet[str]]] = {}
        #: fkey -> axes for functions returning a mesh
        self.mesh_returns: Dict[FKey, Optional[FrozenSet[str]]] = {}
        #: fkey -> {local name: value expr} (function-local constants)
        self._local_consts: Dict[FKey, Dict[str, ast.AST]] = {}
        #: fkey -> {local name: axes} (function-local mesh variables)
        self._mesh_vars: Dict[FKey, Dict[str, Optional[FrozenSet[str]]]] = {}
        #: id(call node) -> {Ctx: provenance} for calls inside a
        #: ``with <world>:`` block (the innermost world, replacing the
        #: function's own contexts)
        self.site_contexts: Dict[int, Dict[Ctx, str]] = {}
        #: fkey -> root names for the port's capture scope (CUDA graphs)
        self.capture_roots: Dict[FKey, Set[str]] = {}
        #: ``with torch.cuda.graph(...)`` blocks: (function, block, prov)
        self.capture_regions: List[Tuple[FuncInfo, ast.AST, str]] = []
        #: lambdas run under capture: (enclosing function, lambda, prov)
        self.capture_lambdas: List[Tuple[FuncInfo, ast.Lambda, str]] = []
        #: fkey -> axes of the world the function returns (None: open)
        self.world_returns: Dict[FKey, Optional[FrozenSet[str]]] = {}

    # -- constant evaluation ------------------------------------------------
    def _const_lookup(self, module: str, name: str,
                      seen: Set[Tuple[str, str]]):
        if (module, name) in seen:
            return _EVAL_FAIL
        # `seen` is the recursion STACK (cycle guard), not a visited
        # set: pop on the way out, or `AXES = (A, B)` with A and B both
        # aliasing AXIS_DP would fail its second lookup and silently
        # unresolve the whole tuple
        seen.add((module, name))
        try:
            expr = self.consts.get(module, {}).get(name)
            if expr is not None:
                return self._eval(expr, module, seen)
            src = self.graph.module_imports.get(module, {}).get(name)
            if src:
                for mod in self.consts:
                    if mod == src or mod.endswith("." + src):
                        return self._const_lookup(mod, name, seen)
            return _EVAL_FAIL
        finally:
            seen.discard((module, name))

    def _eval(self, expr: ast.AST, module: str,
              seen: Optional[Set[Tuple[str, str]]] = None,
              local: Optional[Dict[str, ast.AST]] = None):
        """Evaluate an expression to a static value (str/int/None/tuple)
        or ``_EVAL_FAIL``.  ``local`` layers a function's own constant
        assignments over the module table."""
        seen = seen if seen is not None else set()
        if isinstance(expr, ast.Constant):
            return expr.value
        if isinstance(expr, (ast.Tuple, ast.List)):
            out = []
            for e in expr.elts:
                v = self._eval(e, module, seen, local)
                if v is _EVAL_FAIL:
                    return _EVAL_FAIL
                out.append(v)
            return tuple(out)
        if isinstance(expr, ast.Name):
            if local and expr.id in local:
                return self._eval(local[expr.id], module, seen)
            return self._const_lookup(module, expr.id, seen)
        return _EVAL_FAIL

    def eval_in(self, func: FuncInfo, expr: ast.AST):
        """Static value of ``expr`` inside ``func`` (or ``None`` when
        dynamic — callers must treat that as unknowable, not falsy:
        use :data:`EVAL_FAIL` sentinel via :meth:`eval_raw`)."""
        return self._eval(expr, func.module,
                          local=self._local_consts.get(fkey(func)))

    def axis_strings(self, func: FuncInfo,
                     expr: ast.AST) -> Optional[Tuple[str, ...]]:
        """The literal axis names ``expr`` denotes, flattened — or None
        when the expression is dynamic or not axis-shaped (ints, etc.)."""
        v = self.eval_in(func, expr)
        if v is _EVAL_FAIL:
            return None
        flat: List[str] = []

        def flatten(x) -> bool:
            if isinstance(x, str):
                flat.append(x)
                return True
            if isinstance(x, tuple):
                return all(flatten(e) for e in x)
            return False

        if not flatten(v):
            return None
        return tuple(flat)

    # -- context queries ----------------------------------------------------
    def contexts_of(self, func: FuncInfo) -> Dict[Ctx, str]:
        return self.contexts.get(fkey(func), {})

    def contexts_at(self, func: FuncInfo, call: ast.AST) -> Dict[Ctx, str]:
        """The contexts a call site runs under: its innermost ``with
        <world>:`` block's, else its function's."""
        return self.site_contexts.get(id(call)) or self.contexts_of(func)

    def jit_scope(self, func: FuncInfo) -> bool:
        return fkey(func) in self.jit_roots

    def capture_scope(self, func: FuncInfo) -> bool:
        return fkey(func) in self.capture_roots

    # -- mesh resolution ----------------------------------------------------
    def site_for(self, func: FuncInfo, call: ast.Call):
        """A transient CallSite for :meth:`CallGraph.resolve`."""
        from kungfu_tpu_torch.analysis.callgraph import CallSite

        callee = terminal_name(call.func)
        chain: List[str] = []
        n: ast.AST = call.func
        while isinstance(n, ast.Attribute):
            chain.append(n.attr)
            n = n.value
        if isinstance(n, ast.Name):
            chain.append(n.id)
        chain.reverse()
        return CallSite(callee=callee or "", node=call,
                        line=call.lineno, receiver=tuple(chain[:-1]),
                        branches=())

    def mesh_axes(self, func: FuncInfo,
                  expr: Optional[ast.AST]) -> Optional[FrozenSet[str]]:
        """Axis names of a mesh-typed expression: a ``Mesh(...)`` ctor,
        a local variable bound from one, a ``self.mesh`` class attribute,
        or a call to a mesh-returning function.  None = unresolvable."""
        if expr is None:
            return None
        if isinstance(expr, ast.Call):
            name = terminal_name(expr.func)
            if name in MESH_CTORS:
                return _mesh_ctor_axes(self, func, expr)
            for g in self.graph.resolve(func, self.site_for(func, expr)):
                if fkey(g) in self.mesh_returns:
                    return self.mesh_returns[fkey(g)]
            return None
        if isinstance(expr, ast.Name):
            # own scope first, then enclosing functions (a nested body
            # may close over a mesh its builder constructed), then
            # module-level constants (MESH = Mesh(...))
            scope: Optional[FuncInfo] = func
            while scope is not None:
                hit = self._mesh_vars.get(fkey(scope), {}).get(expr.id)
                if hit is not None:
                    return hit
                scope = scope.parent
            cexpr = self.consts.get(func.module, {}).get(expr.id)
            if isinstance(cexpr, ast.Call) \
                    and terminal_name(cexpr.func) in MESH_CTORS:
                return _mesh_ctor_axes(self, func, cexpr)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls") and func.cls is not None:
            return self.class_mesh.get((func.module, func.cls, expr.attr))
        return None


# ---------------------------------------------------------------------------
# build

#: cap on distinct contexts tracked per function; beyond it the set
#: collapses to one open union (degrades to the vocabulary check)
_CTX_CAP = 8


def _positional_params(node: ast.AST) -> List[str]:
    a = node.args
    return [p.arg for p in (list(a.posonlyargs) + list(a.args))]


def _mesh_kwarg(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "mesh":
            return kw.value
    # positional: shard_map(f, mesh, in_specs, out_specs)
    if len(call.args) >= 2:
        return call.args[1]
    return None


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _mesh_ctor_axes(env: AxisEnv, func: FuncInfo,
                    call: ast.Call) -> Optional[FrozenSet[str]]:
    """Axis names a Mesh/make_mesh constructor declares (None=dynamic)."""
    expr = _kwarg(call, "axis_names")
    if expr is None and len(call.args) >= 2:
        expr = call.args[1]
    if expr is None:
        return None
    axes = env.axis_strings(func, expr)
    if axes is None:
        return None
    return frozenset(axes)


class _ModuleConstVisitor(ast.NodeVisitor):
    """Top-level ``NAME = <const expr>`` bindings of one module."""

    def __init__(self) -> None:
        self.consts: Dict[str, ast.AST] = {}

    def visit_Module(self, node: ast.Module) -> None:
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                self.consts[stmt.targets[0].id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and stmt.value is not None:
                self.consts[stmt.target.id] = stmt.value


def _name_targets(graph: CallGraph, func: FuncInfo,
                  name: str) -> List[FuncInfo]:
    """Scope-aware bare-name resolution: defs nested in ``func`` or an
    enclosing function (innermost first), then module-level functions,
    then explicit imports.  Never every same-named def in the module —
    that would hand one builder's mesh context to another's body."""
    cands = graph.by_name.get(name, [])
    scope: Optional[FuncInfo] = func
    while scope is not None:
        nested = [g for g in cands if g.parent is scope]
        if nested:
            return nested
        scope = scope.parent
    top = [g for g in cands if g.module == func.module
           and g.parent is None and g.cls is None]
    if top:
        return top
    src = graph.module_imports.get(func.module, {}).get(name)
    if src:
        # dotted-boundary match: `from core import f` must not suffix-
        # match an unrelated in-tree module like kungfu_tpu.score
        hit = [g for g in cands if g.cls is None
               and (g.module == src or g.module.endswith("." + src))]
        if hit:
            return hit
    return []


def _jit_ref_targets(graph: CallGraph, func: FuncInfo,
                     expr: ast.AST) -> List[FuncInfo]:
    """Targets of a jit-wrapper argument.  Wider than _fn_targets for
    bound references: `jax.jit(t.step)` marks every same-module `step`
    as traced (the pre-callgraph checker's over-report stance — for jit
    SCOPE an over-approximation flags more, never less; axis contexts
    keep the strict resolver)."""
    res = _fn_targets(graph, func, expr)
    if res or not isinstance(expr, ast.Attribute):
        return res
    name = terminal_name(expr)
    return [g for g in graph.by_name.get(name or "", [])
            if g.module == func.module]


def _fn_targets(graph: CallGraph, func: FuncInfo,
                expr: ast.AST) -> List[FuncInfo]:
    """Functions a Name/Attribute reference may denote (conservative:
    scope-aware for bare names, same class for ``self.x``; [] when
    ambiguous across objects)."""
    if isinstance(expr, ast.Name):
        return _name_targets(graph, func, expr.id)
    if isinstance(expr, ast.Attribute):
        chain: List[str] = []
        n: ast.AST = expr
        while isinstance(n, ast.Attribute):
            chain.append(n.attr)
            n = n.value
        if isinstance(n, ast.Name) and n.id in ("self", "cls") \
                and len(chain) == 1 and func.cls is not None:
            return [g for g in graph.by_name.get(chain[0], [])
                    if g.cls == func.cls and g.module == func.module]
    return []


class _FuncScan(ast.NodeVisitor):
    """One function's own-scope facts: local consts, mesh vars,
    partial-shard_map aliases, return shapes."""

    def __init__(self) -> None:
        self.consts: Dict[str, ast.AST] = {}
        self.assigns: Dict[str, ast.AST] = {}   # every single-Name assign
        self.self_assigns: Dict[str, ast.AST] = {}  # self.X = expr
        self.returns: List[ast.AST] = []

    def _visit_func(self, node) -> None:
        pass  # nested defs own their scope — do not descend

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                self.assigns[t.id] = node.value
                if isinstance(node.value, (ast.Constant, ast.Tuple,
                                           ast.List, ast.Name)):
                    self.consts[t.id] = node.value
            elif isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                self.self_assigns[t.attr] = node.value
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        # `self.axes: List[...] = [...]` declares like a plain assign
        t = node.target
        if node.value is not None:
            if isinstance(t, ast.Name):
                self.assigns[t.id] = node.value
            elif isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) and t.value.id == "self":
                self.self_assigns[t.attr] = node.value
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is not None:
            self.returns.append(node.value)
        self.generic_visit(node)


def _unwrap_mapped(expr: ast.AST) -> Tuple[ast.AST, List[ast.Call]]:
    """Peel transparent/jit wrappers off a mapped-function expression:
    ``jit(value_and_grad(f))`` -> (f ref, [wrapper calls]).  Returns the
    innermost non-wrapper expression."""
    wrappers: List[ast.Call] = []
    n = expr
    while isinstance(n, ast.Call):
        name = terminal_name(n.func)
        if name in TRANSPARENT_WRAPPERS | JIT_WRAPPERS and n.args:
            wrappers.append(n)
            n = n.args[0]
            continue
        break
    return n, wrappers


def build(root: str) -> AxisEnv:
    graph = project_graph(root)
    env = AxisEnv(root, graph)

    # pass 0: module constants (from the cached ASTs the graph indexed)
    from kungfu_tpu_torch.analysis.core import iter_py_files, parse_module

    modpaths: Dict[str, str] = {}
    for f in graph.functions:
        modpaths.setdefault(f.module, f.path)
    for path in iter_py_files(root):
        tree = parse_module(path).tree
        if tree is None:
            continue
        from kungfu_tpu_torch.analysis.callgraph import _module_of

        module = _module_of(root, path)
        v = _ModuleConstVisitor()
        v.visit(tree)
        env.consts[module] = v.consts
        # modules with no functions still carry imports for const lookup
        graph.module_imports.setdefault(module, {})
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    graph.module_imports[module].setdefault(
                        alias.asname or alias.name, node.module or "")

    # pass 1: function facts + vocabulary from mesh ctors / pmap kinds
    facts: Dict[FKey, _FuncScan] = {}
    for f in graph.functions:
        scan = _FuncScan()
        # visit children of the def (visiting the def itself would stop)
        for stmt in f.node.body:
            scan.visit(stmt)
        facts[fkey(f)] = scan
        env._local_consts[fkey(f)] = scan.consts

    mesh_axes_of = env.mesh_axes

    # fixpoint over mesh-returning functions / mesh vars / class attrs
    for _ in range(4):  # nesting depth of mesh plumbing is shallow
        changed = False
        for f in graph.functions:
            scan = facts[fkey(f)]
            mvars = env._mesh_vars.setdefault(fkey(f), {})
            for name, expr in scan.assigns.items():
                axes = mesh_axes_of(f, expr) if isinstance(
                    expr, (ast.Call,)) else None
                if axes is not None and mvars.get(name) != axes:
                    mvars[name] = axes
                    changed = True
            for attr, expr in scan.self_assigns.items():
                if not isinstance(expr, ast.Call):
                    continue
                axes = mesh_axes_of(f, expr)
                key = (f.module, f.cls, attr)
                if axes is not None and env.class_mesh.get(key) != axes:
                    env.class_mesh[key] = axes
                    changed = True
            for rexpr in scan.returns:
                axes = None
                if isinstance(rexpr, ast.Call):
                    axes = mesh_axes_of(f, rexpr)
                elif isinstance(rexpr, ast.Name):
                    axes = mvars.get(rexpr.id)
                if axes is not None \
                        and env.mesh_returns.get(fkey(f)) != axes:
                    env.mesh_returns[fkey(f)] = axes
                    changed = True
        if not changed:
            break

    # vocabulary: every mesh ctor + pmap axis_name anywhere in the tree
    for f in graph.functions:
        for site in f.calls:
            if site.callee in MESH_CTORS:
                axes = _mesh_ctor_axes(env, f, site.node)
                if axes:
                    env.vocabulary |= axes
            elif site.callee == "pmap":
                expr = _kwarg(site.node, "axis_name")
                if expr is not None:
                    ax = env.axis_strings(f, expr)
                    if ax:
                        env.vocabulary |= set(ax)
    # module-level Mesh(...) constructors (outside any function)
    for module, consts in env.consts.items():
        for expr in consts.values():
            for node in ast.walk(expr):
                if isinstance(node, ast.Call) \
                        and terminal_name(node.func) in MESH_CTORS:
                    dummy = FuncInfo(module=module, cls=None, name="<mod>",
                                     path=modpaths.get(module, module),
                                     node=expr, lineno=1)
                    axes = _mesh_ctor_axes(env, dummy, node)
                    if axes:
                        env.vocabulary |= axes

    # pass 1b: the port's rank worlds, world contexts and capture scope
    worlds = _PortWorlds(env, facts)
    worlds.run()

    # pass 2: binding sites — shard_map/pmap/jit wrappings, partial
    # aliases, mesh-entry params
    bindings: List[Tuple[FKey, FKey, Optional[FrozenSet[str]], str]] = []
    jit_root_names: Dict[FKey, Set[str]] = {}
    mesh_entry: Dict[FKey, Tuple[int, Optional[FrozenSet[str]], str]] = {}
    #: mapped-function argument nodes of binding wrappers: the binding
    #: models their context flow, a plain callback edge would leak the
    #: binder's context WITHOUT the mapped mesh's axes
    mapped_args: Set[int] = set()

    def bind(binder: FuncInfo, target: FuncInfo,
             axes: Optional[FrozenSet[str]], prov: str) -> None:
        bindings.append((fkey(binder), fkey(target), axes, prov))

    def note_jit_root(target: FuncInfo, why: str) -> None:
        jit_root_names.setdefault(fkey(target), set()).add(why)

    def record_shard_map(f: FuncInfo, call: ast.Call,
                         axes: Optional[FrozenSet[str]]) -> None:
        mapped_expr = call.args[0] if call.args else None
        targets: List[FuncInfo] = []
        if mapped_expr is not None:
            mapped_args.add(id(mapped_expr))
            inner, _ = _unwrap_mapped(mapped_expr)
            targets = _fn_targets(graph, f, inner)
            for g in targets:
                prov = (f"shard_map at {f.path}:{call.lineno} over mesh "
                        f"{{{', '.join(sorted(axes))}}}" if axes is not None
                        else f"shard_map at {f.path}:{call.lineno} "
                             f"(unresolved mesh)")
                bind(f, g, axes, prov)
                note_jit_root(g, g.name)
            # the mapped expr may be one of f's own parameters: f is a
            # mesh-entry helper (Communicator._shard_jit(body) idiom)
            if isinstance(mapped_expr, ast.Name) \
                    and hasattr(f.node, "args"):
                params = _positional_params(f.node)
                if mapped_expr.id in params and not targets:
                    mesh_entry[fkey(f)] = (
                        params.index(mapped_expr.id), axes,
                        f"{f.qualname} (shard_map at {f.path}:{call.lineno})",
                    )
        env.shard_sites.append(ShardMapSite(
            func=f, node=call, axes=axes, targets=targets,
            in_specs=_kwarg(call, "in_specs") or (
                call.args[2] if len(call.args) > 2 else None),
            out_specs=_kwarg(call, "out_specs") or (
                call.args[3] if len(call.args) > 3 else None),
        ))

    for f in graph.functions:
        scan = facts[fkey(f)]
        # partial(shard_map, mesh=...) local aliases
        partial_alias: Dict[str, Optional[FrozenSet[str]]] = {}
        for name, expr in scan.assigns.items():
            if isinstance(expr, ast.Call) \
                    and terminal_name(expr.func) == "partial" and expr.args:
                inner_name = terminal_name(expr.args[0])
                if inner_name == "shard_map":
                    partial_alias[name] = mesh_axes_of(
                        f, _kwarg(expr, "mesh"))

        # decorators on f itself
        def _deco_pmap_bind(deco_call, form: str) -> None:
            ax_expr = _kwarg(deco_call, "axis_name")
            ax = (env.axis_strings(f, ax_expr)
                  if ax_expr is not None else ())
            if ax:
                env.vocabulary |= set(ax)
            bindings.append((
                fkey(f), fkey(f),
                frozenset(ax) if ax is not None else None,
                f"{form} at {f.path}:{f.lineno}"))

        for deco in f.node.decorator_list if hasattr(
                f.node, "decorator_list") else []:
            name = terminal_name(deco if not isinstance(deco, ast.Call)
                                 else deco.func)
            if isinstance(deco, ast.Call) and name == "partial" and deco.args:
                inner = terminal_name(deco.args[0])
                if inner in JIT_WRAPPERS:
                    note_jit_root(f, f.name)
                if inner == "shard_map":
                    axes = mesh_axes_of(f, _kwarg(deco, "mesh"))
                    bindings.append((
                        fkey(f), fkey(f), axes,
                        f"@partial(shard_map) at {f.path}:{f.lineno}"))
                if inner == "pmap":
                    _deco_pmap_bind(deco, "@partial(pmap)")
                if inner == "jit":
                    env.jit_sites.append(JitSite(
                        func=f, node=deco, targets=[f],
                        static_argnums=_kwarg(deco, "static_argnums"),
                        static_argnames=_kwarg(deco, "static_argnames")))
            elif name in JIT_WRAPPERS:
                note_jit_root(f, f.name)
                if isinstance(deco, ast.Call) and name == "pmap":
                    _deco_pmap_bind(deco, "@pmap")
                if isinstance(deco, ast.Call) and name == "jit":
                    env.jit_sites.append(JitSite(
                        func=f, node=deco, targets=[f],
                        static_argnums=_kwarg(deco, "static_argnums"),
                        static_argnames=_kwarg(deco, "static_argnames")))

        # call sites inside f
        for site in f.calls:
            call = site.node
            if site.callee == "shard_map":
                record_shard_map(f, call, mesh_axes_of(f, _mesh_kwarg(call)))
                continue
            if site.callee in partial_alias and not site.receiver:
                if call.args:
                    mapped_args.add(id(call.args[0]))
                    inner, _ = _unwrap_mapped(call.args[0])
                    for g in _fn_targets(graph, f, inner):
                        axes = partial_alias[site.callee]
                        prov = (f"partial(shard_map) at {f.path}:"
                                f"{call.lineno}" + (
                                    f" over mesh {{{', '.join(sorted(axes))}}}"
                                    if axes is not None else
                                    " (unresolved mesh)"))
                        bind(f, g, axes, prov)
                        note_jit_root(g, g.name)
                continue
            if site.callee == "pmap":
                if call.args:
                    mapped_args.add(id(call.args[0]))
                    inner, _ = _unwrap_mapped(call.args[0])
                    axis_expr = _kwarg(call, "axis_name")
                    ax = env.axis_strings(f, axis_expr) \
                        if axis_expr is not None else ()
                    axes = frozenset(ax) if ax is not None else None
                    for g in _fn_targets(graph, f, inner):
                        bind(f, g, axes,
                             f"pmap at {f.path}:{call.lineno}")
                        note_jit_root(g, g.name)
                continue
            if site.callee == "jit":
                if call.args:
                    inner, wrappers = _unwrap_mapped(call.args[0])
                    targets = _jit_ref_targets(graph, f, inner)
                    for g in targets:
                        note_jit_root(g, g.name)
                    env.jit_sites.append(JitSite(
                        func=f, node=call, targets=targets,
                        static_argnums=_kwarg(call, "static_argnums"),
                        static_argnames=_kwarg(call, "static_argnames")))
                continue

    # module-level wrappings: `train_step = jax.jit(step)` at import
    # time enters jit scope too (the pre-callgraph jit-sync saw these;
    # losing them would be a silent coverage regression)
    from kungfu_tpu_torch.analysis.callgraph import _module_of
    from kungfu_tpu_torch.analysis.core import relpath as _relpath

    for path in iter_py_files(root):
        mod = parse_module(path)
        if mod.tree is None:
            continue
        dummy = FuncInfo(module=_module_of(root, path), cls=None,
                         name="<module>", path=_relpath(root, path),
                         node=mod.tree, lineno=0)
        stack: List[ast.AST] = list(mod.tree.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue  # function-level sites: pass 2 covered them
            if isinstance(n, ast.Call):
                name = terminal_name(n.func)
                if name == "jit" and n.args:
                    inner, _ = _unwrap_mapped(n.args[0])
                    targets = _jit_ref_targets(graph, dummy, inner)
                    for g in targets:
                        note_jit_root(g, g.name)
                    if targets:
                        env.jit_sites.append(JitSite(
                            func=dummy, node=n, targets=targets,
                            static_argnums=_kwarg(n, "static_argnums"),
                            static_argnames=_kwarg(n, "static_argnames")))
                elif name == "shard_map":
                    record_shard_map(dummy, n,
                                     env.mesh_axes(dummy, _mesh_kwarg(n)))
                elif name == "pmap" and n.args:
                    inner, _ = _unwrap_mapped(n.args[0])
                    ax_expr = _kwarg(n, "axis_name")
                    ax = (env.axis_strings(dummy, ax_expr)
                          if ax_expr is not None else ())
                    for g in _fn_targets(graph, dummy, inner):
                        bind(dummy, g,
                             frozenset(ax) if ax is not None else None,
                             f"pmap at {dummy.path}:{n.lineno}")
                        note_jit_root(g, g.name)
            stack.extend(ast.iter_child_nodes(n))

    # mesh-entry params: callers passing a function into a helper that
    # shard_maps its argument (one indirection level)
    for f in graph.functions:
        for site in f.calls:
            for g in graph.resolve(f, site):
                entry = mesh_entry.get(fkey(g))
                if entry is None:
                    continue
                idx, axes, prov = entry
                # account for the bound receiver: self.helper(body) calls
                # helper(self, body)
                pos = idx - (1 if (g.cls is not None and site.receiver)
                             else 0)
                if 0 <= pos < len(site.node.args):
                    mapped_args.add(id(site.node.args[pos]))
                    inner, _ = _unwrap_mapped(site.node.args[pos])
                    for h in _fn_targets(graph, f, inner):
                        bind(f, h, axes, f"via {prov}")
                        note_jit_root(h, h.name)

    # pass 3: propagation fixpoint — contexts flow binder->target and
    # caller->callee (calls and callback references).  ``edges`` reach
    # every callee (jit and capture scope); ``ctx_edges`` leave out the
    # calls inside a ``with <world>:`` block, whose targets take the
    # block's world through a binding instead
    edges: Dict[FKey, Set[FKey]] = {}
    ctx_edges: Dict[FKey, Set[FKey]] = {}
    for f in graph.functions:
        out = edges.setdefault(fkey(f), set())
        cout = ctx_edges.setdefault(fkey(f), set())
        for site in f.calls:
            hit: Set[FKey] = set()
            resolved = graph.resolve(f, site)
            for g in resolved:
                hit.add(fkey(g))
            if not resolved and not site.receiver:
                # bare call to a nested def inside a method: the shared
                # resolver skips these (they carry a cls) — scope-aware
                # resolution finds the one the name actually binds
                for g in _name_targets(graph, f, site.callee):
                    if fkey(g) != fkey(f):
                        hit.add(fkey(g))
            args: List[ast.AST] = [
                a for a in site.node.args if id(a) not in mapped_args
            ] + [kw.value for kw in site.node.keywords]
            # one level into list/tuple args: lax.switch branch lists,
            # defvjp pairs
            for arg in list(args):
                if isinstance(arg, (ast.List, ast.Tuple)):
                    args.extend(arg.elts)
            for arg in args:
                if isinstance(arg, (ast.Name, ast.Attribute)):
                    for g in _fn_targets(graph, f, arg):
                        if fkey(g) != fkey(f):
                            hit.add(fkey(g))
            out |= hit
            if id(site.node) not in env.site_contexts:
                cout |= hit
    for binder, target, axes, prov in worlds.bindings:
        # a world binding replaces the binder's contexts: the target
        # runs under exactly that world
        bindings.append((binder, target, axes, prov))
    world_targets = {(b, t) for b, t, _, _ in worlds.bindings}

    def add_ctx(qual: FKey, ctx: Ctx, prov: str) -> bool:
        cur = env.contexts.setdefault(qual, {})
        if ctx in cur:
            return False
        if len(cur) >= _CTX_CAP:
            # collapse: one open union context keeps soundness
            union = frozenset().union(*(c.axes for c in cur)) | ctx.axes
            collapsed = Ctx(frozenset(union), True)
            if collapsed in cur:
                return False
            cur.clear()
            cur[collapsed] = "(merged contexts)"
            return True
        cur[ctx] = prov
        return True

    # a binder that is itself a binding target — or reachable from one
    # — may GAIN contexts during the fixpoint; processing its bindings'
    # base case early would freeze a stale closed context (a
    # definition-order-dependent false positive).  Such binders wait for
    # their contexts; only binders that provably never gain any use the
    # base case.
    holders: Set[FKey] = {t for _, t, _, _ in bindings}
    hchanged = True
    while hchanged:
        hchanged = False
        for src, dsts in ctx_edges.items():
            if src in holders:
                new = dsts - holders
                if new:
                    holders |= new
                    hchanged = True

    changed = True
    iters = 0
    while changed and iters < 64:
        changed = False
        iters += 1
        for binder, target, axes, prov in bindings:
            base = env.contexts.get(binder)
            if (binder, target) in world_targets:
                if add_ctx(target, Ctx(axes or frozenset(), axes is None),
                           prov):
                    changed = True
            elif base:
                for ctx in list(base):
                    if add_ctx(target, ctx.merged(axes), prov):
                        changed = True
            elif binder not in holders:
                ctx = Ctx(axes or frozenset(), axes is None)
                if add_ctx(target, ctx, prov):
                    changed = True
        for src, dsts in ctx_edges.items():
            ctxs = env.contexts.get(src)
            if not ctxs:
                continue
            for dst in dsts:
                for ctx, prov in list(ctxs.items()):
                    if add_ctx(dst, ctx, prov):
                        changed = True

    # pass 4: jit-scope reachability with root attribution
    roots = dict(jit_root_names)
    changed = True
    iters = 0
    while changed and iters < 64:
        changed = False
        iters += 1
        for src, dsts in edges.items():
            names = roots.get(src)
            if not names:
                continue
            for dst in dsts:
                cur = roots.setdefault(dst, set())
                before = len(cur)
                cur |= names
                if len(cur) != before:
                    changed = True
    env.jit_roots = roots
    # direct roots keep their own name as attribution
    for qual in jit_root_names:
        env.jit_roots.setdefault(qual, set()).update(jit_root_names[qual])

    # pass 5: capture-scope reachability, the same walk from the port's
    # capture roots
    env.capture_roots = _reach(edges, worlds.capture_root_names)
    return env


def _reach(edges: Dict[FKey, Set[FKey]],
           seeds: Dict[FKey, Set[str]]) -> Dict[FKey, Set[str]]:
    """Root attribution over ``edges``: every function reachable from a
    seed carries the seed's names."""
    roots = {k: set(v) for k, v in seeds.items()}
    changed = True
    iters = 0
    while changed and iters < 64:
        changed = False
        iters += 1
        for src, dsts in edges.items():
            names = roots.get(src)
            if not names:
                continue
            for dst in dsts:
                cur = roots.setdefault(dst, set())
                before = len(cur)
                cur |= names
                if len(cur) != before:
                    changed = True
    return roots


def _is_capture_block(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (any alias ending in ``cuda``)."""
    if not isinstance(expr, ast.Call):
        return False
    term, recv = _terminal_and_receiver(expr.func)
    return term == "graph" and bool(recv) and recv[-1] == "cuda"


def _is_capture_wrapper(call: ast.Call) -> bool:
    """``torch.compile(f)`` or ``torch.cuda.make_graphed_callables(f)``."""
    term, recv = _terminal_and_receiver(call.func)
    if term not in CAPTURE_WRAPPERS:
        return False
    return term != "compile" or recv == ("torch",)


class _PortWorlds:
    """The port's idioms over the shared call graph: rank-world axes,
    world methods, the receivers' classes, ``with <world>:`` blocks,
    capture blocks and capture/world-entry parameters.  Fills
    ``env.site_contexts``, ``env.world_returns``, ``env.vocabulary``,
    ``env.capture_regions`` and ``env.capture_lambdas``; leaves the
    bindings and capture roots for :func:`build` to propagate."""

    def __init__(self, env: AxisEnv, facts: Dict[FKey, "_FuncScan"]):
        self.env = env
        self.graph = env.graph
        self.facts = facts
        #: (binder, target, axes, provenance): a world binding
        self.bindings: List[Tuple[FKey, FKey, Optional[FrozenSet[str]],
                                  str]] = []
        self.capture_root_names: Dict[FKey, Set[str]] = {}
        #: (module, cls, attr) -> [(assigning method, value expr)]
        self.class_attrs: Dict[Tuple[str, Optional[str], str],
                               List[Tuple[FuncInfo, ast.AST]]] = {}
        #: class name -> [(module, cls)]
        self.classes: Dict[str, List[Tuple[str, str]]] = {}
        #: fkey -> (module, cls) of the object the function returns
        self.returns_class: Dict[FKey, Tuple[str, str]] = {}
        #: fkey -> [(param index, "capture" | "world", axes, prov)]
        self.entries: Dict[FKey, List[Tuple[int, str,
                                            Optional[FrozenSet[str]],
                                            str]]] = {}

    # -- typing ---------------------------------------------------------
    def targets(self, func: FuncInfo, call: ast.Call) -> List[FuncInfo]:
        site = self.env.site_for(func, call)
        res = self.graph.resolve(func, site)
        if not res and isinstance(call.func, ast.Name):
            res = [g for g in _name_targets(self.graph, func, call.func.id)
                   if fkey(g) != fkey(func)]
        return res

    def class_by_name(self, func: FuncInfo,
                      name: str) -> Optional[Tuple[str, str]]:
        cands = self.classes.get(name, [])
        same = [c for c in cands if c[0] == func.module]
        if same:
            return same[0]
        src = self.graph.module_imports.get(func.module, {}).get(name)
        if src:
            hit = [c for c in cands if c[0] == src or c[0].endswith("." + src)]
            if len(hit) == 1:
                return hit[0]
        return cands[0] if len(cands) == 1 else None

    def class_of_call(self, func: FuncInfo,
                      call: ast.Call) -> Optional[Tuple[str, str]]:
        name = terminal_name(call.func) or ""
        if name[:1].isupper():
            hit = self.class_by_name(func, name)
            if hit is not None:
                return hit
        targets = self.targets(func, call)
        if not targets:
            # an ambiguous method name (``plan.build_mesh``): the
            # candidates that return a known class must all agree
            targets = self.graph.by_name.get(name, [])
        hits = {self.returns_class[fkey(g)] for g in targets
                if fkey(g) in self.returns_class}
        return hits.pop() if len(hits) == 1 else None

    def class_of_expr(self, func: FuncInfo,
                      expr: ast.AST) -> Optional[Tuple[str, str]]:
        if isinstance(expr, ast.Call):
            return self.class_of_call(func, expr)
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls") and func.cls is not None:
                return (func.module, func.cls)
            scope: Optional[FuncInfo] = func
            while scope is not None:
                val = self.facts[fkey(scope)].assigns.get(expr.id)
                if isinstance(val, ast.Call):
                    return self.class_of_call(scope, val)
                ann = _param_annotation(scope.node, expr.id)
                if ann is not None:
                    return self.class_by_name(scope, ann)
                scope = scope.parent
            return None
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls") and func.cls is not None:
            hits = {self.class_of_call(g, e)
                    for g, e in self.class_attrs.get(
                        (func.module, func.cls, expr.attr), [])
                    if isinstance(e, ast.Call)}
            hits.discard(None)
            return hits.pop() if len(hits) == 1 else None
        return None

    # -- worlds ---------------------------------------------------------
    def pair_axes(self, func: FuncInfo, expr: Optional[ast.AST],
                  depth: int = 0) -> Optional[FrozenSet[str]]:
        """Axis names of a ``[(name, size), ...]`` pair list; None when
        any name is dynamic."""
        if expr is None or depth > 4:
            return None
        if isinstance(expr, (ast.List, ast.Tuple)):
            names: List[str] = []
            for e in expr.elts:
                if not isinstance(e, (ast.Tuple, ast.List)) or not e.elts:
                    return None
                ax = self.env.axis_strings(func, e.elts[0])
                if ax is None or len(ax) != 1:
                    return None
                names.append(ax[0])
            return frozenset(names)
        if isinstance(expr, ast.Name):
            scope: Optional[FuncInfo] = func
            while scope is not None:
                val = self.facts[fkey(scope)].assigns.get(expr.id)
                if val is not None:
                    return self.pair_axes(scope, val, depth + 1)
                scope = scope.parent
            cexpr = self.env.consts.get(func.module, {}).get(expr.id)
            return self.pair_axes(func, cexpr, depth + 1)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and func.cls is not None:
            vals = {self.pair_axes(g, e, depth + 1)
                    for g, e in self.class_attrs.get(
                        (func.module, func.cls, expr.attr), [])}
            return vals.pop() if len(vals) == 1 else None
        return None

    def world_of(self, func: FuncInfo, expr: ast.AST
                 ) -> Optional[Tuple[Optional[FrozenSet[str]], str]]:
        """``(axes or None when open, provenance)`` when ``expr`` enters
        a rank world, else None."""
        if not isinstance(expr, ast.Call):
            return None
        name = terminal_name(expr.func) or ""
        where = f"{func.path}:{expr.lineno}"

        def render(what: str, axes: Optional[FrozenSet[str]]) -> str:
            if axes is None:
                return f"{what} at {where} (unresolved world)"
            return f"{what} at {where} over {{{', '.join(sorted(axes))}}}"

        if name in WORLD_CTORS:
            arg = expr.args[0] if expr.args else _kwarg(expr, "axes")
            axes = self.pair_axes(func, arg)
            return axes, render("rank_world", axes)
        if name in WORLD_REENTRY:
            return None, render(name, None)
        targets = self.targets(func, expr)
        if not targets and isinstance(expr.func, ast.Attribute):
            owner = self.class_of_expr(func, expr.func.value)
            if owner is not None:
                targets = [g for g in self.graph.by_name.get(name, [])
                           if (g.module, g.cls) == owner and g.parent is None]
        hits = [self.env.world_returns[fkey(g)] for g in targets
                if fkey(g) in self.env.world_returns]
        if hits:
            axes = hits[0] if all(h == hits[0] for h in hits) else None
            return axes, render(f"{name}()", axes)
        if name in WORLD_METHODS and isinstance(expr.func, ast.Attribute):
            return None, render(f"{name}()", None)
        return None

    # -- build ----------------------------------------------------------
    def run(self) -> None:
        env, graph = self.env, self.graph
        for f in graph.functions:
            if f.cls is None:
                continue
            owners = self.classes.setdefault(f.cls, [])
            if (f.module, f.cls) not in owners:
                owners.append((f.module, f.cls))
            for attr, expr in self.facts[fkey(f)].self_assigns.items():
                self.class_attrs.setdefault((f.module, f.cls, attr),
                                            []).append((f, expr))
        # returned classes and returned worlds, to a fixpoint (the
        # plumbing is shallow: build_mesh -> Mesh, world -> rank_world)
        for _ in range(4):
            changed = False
            for f in graph.functions:
                for rexpr in self.facts[fkey(f)].returns:
                    c = (self.class_of_expr(f, rexpr)
                         if isinstance(rexpr, (ast.Call, ast.Name)) else None)
                    if c is not None and self.returns_class.get(fkey(f)) != c:
                        self.returns_class[fkey(f)] = c
                        changed = True
                    w = self.world_of(f, rexpr)
                    if w is not None and (
                            fkey(f) not in env.world_returns
                            or env.world_returns[fkey(f)] != w[0]):
                        env.world_returns[fkey(f)] = w[0]
                        changed = True
            if not changed:
                break
        for axes in env.world_returns.values():
            if axes:
                env.vocabulary |= axes
        for f in graph.functions:
            for site in f.calls:
                if site.callee in WORLD_CTORS:
                    w = self.world_of(f, site.node)
                    if w is not None and w[0]:
                        env.vocabulary |= w[0]
        for f in graph.functions:
            self._regions(f)
        self._entry_callers()

    def _callbacks(self, func: FuncInfo, call: ast.Call) -> List[FuncInfo]:
        out: List[FuncInfo] = []
        args = list(call.args) + [kw.value for kw in call.keywords]
        for arg in list(args):
            if isinstance(arg, (ast.List, ast.Tuple)):
                args.extend(arg.elts)
        for arg in args:
            if isinstance(arg, (ast.Name, ast.Attribute)):
                out.extend(g for g in _fn_targets(self.graph, func, arg)
                           if fkey(g) != fkey(func))
        return out

    def _root(self, g: FuncInfo, why: str) -> None:
        self.capture_root_names.setdefault(fkey(g), set()).add(why)

    def _regions(self, f: FuncInfo) -> None:
        env = self.env
        world_at: Dict[int, Tuple[Optional[FrozenSet[str]], str]] = {}
        capture_at: Dict[int, str] = {}

        def visit(node: ast.AST, world, capture) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return  # nested scopes own their calls
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    # an item is evaluated under the items before it
                    visit(item, world, capture)
                    got = self.world_of(f, item.context_expr)
                    if got is not None:
                        world = got
                    if _is_capture_block(item.context_expr):
                        capture = (f"torch.cuda.graph at {f.path}:"
                                   f"{item.context_expr.lineno}")
                        env.capture_regions.append((f, node, capture))
                for stmt in node.body:
                    visit(stmt, world, capture)
                return
            if isinstance(node, ast.Call):
                if world is not None:
                    world_at[id(node)] = world
                if capture is not None:
                    capture_at[id(node)] = capture
            for child in ast.iter_child_nodes(node):
                visit(child, world, capture)

        for stmt in f.node.body:
            visit(stmt, None, None)

        params = _positional_params(f.node)
        for site in f.calls:
            call = site.node
            if _is_capture_wrapper(call) and call.args:
                inner, _ = _unwrap_mapped(call.args[0])
                elts = (inner.elts if isinstance(inner, (ast.Tuple, ast.List))
                        else [inner])
                for e in elts:
                    for g in _jit_ref_targets(self.graph, f, e):
                        self._root(g, g.name)
            w = world_at.get(id(call))
            c = capture_at.get(id(call))
            if w is None and c is None:
                continue
            # a parameter shadows every module-level name it spells
            own_param = (isinstance(call.func, ast.Name)
                         and call.func.id in params)
            targets = [] if own_param else self.targets(f, call)
            targets += self._callbacks(f, call)
            if w is not None:
                axes, prov = w
                env.site_contexts[id(call)] = {
                    Ctx(axes or frozenset(), axes is None): prov}
                for g in targets:
                    self.bindings.append((fkey(f), fkey(g), axes, prov))
                if own_param:
                    self.entries.setdefault(fkey(f), []).append(
                        (params.index(call.func.id), "world", axes,
                         f"via {f.qualname} ({prov})"))
            if c is not None:
                for g in targets:
                    self._root(g, g.name)
                if own_param:
                    self.entries.setdefault(fkey(f), []).append(
                        (params.index(call.func.id), "capture", None,
                         f"{f.qualname} ({c})"))
        for deco in getattr(f.node, "decorator_list", []):
            if _is_capture_wrapper(deco if isinstance(deco, ast.Call)
                                   else ast.Call(func=deco, args=[],
                                                 keywords=[])):
                self._root(f, f.name)

    def _entry_callers(self) -> None:
        """Callers passing a function or a lambda into a capture-entry
        or world-entry parameter (one indirection level, as the
        reference's mesh-entry parameters)."""
        env = self.env
        for f in self.graph.functions:
            for site in f.calls:
                for g in self.targets(f, site.node):
                    for idx, kind, axes, prov in self.entries.get(fkey(g), []):
                        pos = idx - (1 if (g.cls is not None and site.receiver
                                           and g.parent is None) else 0)
                        if not 0 <= pos < len(site.node.args):
                            continue
                        arg = site.node.args[pos]
                        if isinstance(arg, ast.Lambda):
                            if kind == "capture":
                                env.capture_lambdas.append((f, arg, prov))
                            calls = [n for n in ast.walk(arg.body)
                                     if isinstance(n, ast.Call)]
                            hits = [h for n in calls
                                    for h in self.targets(f, n)
                                    + self._callbacks(f, n)]
                            if kind == "world":
                                for n in calls:
                                    env.site_contexts[id(n)] = {
                                        Ctx(axes or frozenset(),
                                            axes is None): prov}
                        else:
                            inner, _ = _unwrap_mapped(arg)
                            hits = _fn_targets(self.graph, f, inner)
                        for h in hits:
                            if kind == "capture":
                                self._root(h, h.name)
                            else:
                                self.bindings.append(
                                    (fkey(f), fkey(h), axes, prov))


def _param_annotation(node: ast.AST, name: str) -> Optional[str]:
    """The class name a parameter is annotated with (``comm:
    Communicator`` or ``"Communicator"``), else None."""
    args = getattr(node, "args", None)
    if args is None or not hasattr(args, "args"):
        return None
    for p in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        if p.arg != name or p.annotation is None:
            continue
        ann = p.annotation
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.rsplit(".", 1)[-1]
        return terminal_name(ann)
    return None


_ENV_CACHE: Dict[str, AxisEnv] = {}


def axis_environment(root: str) -> AxisEnv:
    """Build (or reuse) the axis environment for ``root`` — all three
    kf-shard rules run over one tree in one CLI pass."""
    key = os.path.abspath(root)
    envp = _ENV_CACHE.get(key)
    if envp is None:
        envp = _ENV_CACHE[key] = build(key)
    return envp


def invalidate_cache() -> None:
    _ENV_CACHE.clear()
