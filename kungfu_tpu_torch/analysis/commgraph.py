"""Comm-plane extraction for the kf-verify protocol checker (port of
``kungfu_tpu/analysis/commgraph.py`` over the port's tree).

This is the front half of ``proto-verify`` (``analysis/protoverify.py``):
an abstract interpreter over the communication plane that lifts, per
registered **entrypoint** (the dp/zero host bucket loops, the pipeline
``train_step``, both re-carve protocols, the ring mirrors, the serve
dispatch/replay path), the symbolic sequence of collective / p2p
operations the function issues — *without importing any of it* (the
analysis layer is stdlib-only; kflint runs in bare CI images).

What gets extracted per entrypoint:

* every **issue site** of a
  :class:`~kungfu_tpu_torch.comm.engine.CollectiveEngine`
  wire op (matched against the declarative ``COMM_OP_SPECS`` table the
  engine module carries — op kind, group axis, tag template, arg
  positions), plus the host-channel p2p layer (``chan.send`` /
  ``channel.send`` / ``_recv_or_fail``);
* the **tag template** of each site — f-strings become constant parts
  with ``{}`` holes, local straight-line assigns (``name = f"kf.zbuddy.
  {tag}"``) and single-return tag helpers (``self._act_tag(mb, vs)``,
  ``seg_name("p", i)``) are inlined, and a tag handed whole to a local
  send helper (the port's byte-counting ``send(dst, name, arr, kind)``
  in ``StageBoundary.recarve``) keeps the caller's template at the wire;
* the **branch context** (which enclosing ``if`` guards feed the site,
  and whether their tests read rank-like state) and the **loop
  context** (which loop variables feed the tag holes, and whether the
  iteration order is reversed) — the raw material of the
  ordering-consistency pass;
* **fence sites** (``drain_async`` and the membership fences of
  handle-discipline) and statically-trackable **handle waits**, for the
  wait-for-graph pass.

Resolution is conservative, like :mod:`kungfu_tpu_torch.analysis.callgraph`
(precision over recall — a false protocol finding is a red build): a
site whose tag cannot be resolved to a template with at least one
constant part marks the entrypoint *unresolved* rather than guessing,
and the downstream pairing rules skip what they cannot see (the
concrete geometry simulation in ``protoverify.py`` covers those).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from kungfu_tpu_torch.analysis.callgraph import (
    CallGraph,
    FuncInfo,
    _terminal_and_receiver,
    project_graph,
)
from kungfu_tpu_torch.analysis.core import Violation, relpath
from kungfu_tpu_torch.analysis.handlecheck import _FENCE_CALLS

CHECKER = "proto-verify"

ENGINE_RELPATH = "kungfu_tpu_torch/comm/engine.py"

#: mirror of ``kungfu_tpu_torch/comm/engine.py``'s ``COMM_OP_SPECS`` — used
#: when the scanned tree carries no engine module (lint fixtures).  A
#: tier-1 test pins this against the parsed table so they cannot drift.
FALLBACK_SPECS = {
    "all_reduce":          {"kind": "collective", "group": "world",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "broadcast":           {"kind": "collective", "group": "world",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "reduce":              {"kind": "collective", "group": "world",
                            "tag": "{name}.r", "blocking": True,
                            "name_pos": 3, "peer_pos": None},
    "gather":              {"kind": "collective", "group": "world",
                            "tag": "{name}.g", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "all_gather":          {"kind": "collective", "group": "world",
                            "tag": "{name}.ag", "blocking": True,
                            "name_pos": 1, "peer_pos": None},
    "reduce_scatter":      {"kind": "collective", "group": "world",
                            "tag": "{name}.rs", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "local_reduce":        {"kind": "collective", "group": "slice",
                            "tag": "{name}.lr", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "local_broadcast":     {"kind": "collective", "group": "slice",
                            "tag": "{name}.lb", "blocking": True,
                            "name_pos": 1, "peer_pos": None},
    "cross_all_reduce":    {"kind": "collective", "group": "cross",
                            "tag": "{name}.x", "blocking": True,
                            "name_pos": 2, "peer_pos": None},
    "send_to":             {"kind": "p2p-send", "group": "pair",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 2, "peer_pos": 0},
    "recv_from":           {"kind": "p2p-recv", "group": "pair",
                            "tag": "{name}", "blocking": True,
                            "name_pos": 1, "peer_pos": 0},
    "send_async":          {"kind": "p2p-send", "group": "pair",
                            "tag": "{name}", "blocking": False,
                            "name_pos": 2, "peer_pos": 0},
    "recv_async":          {"kind": "p2p-recv", "group": "pair",
                            "tag": "{name}", "blocking": False,
                            "name_pos": 1, "peer_pos": 0},
    "all_reduce_async":    {"kind": "collective", "group": "world",
                            "tag": "{name}", "blocking": False,
                            "name_pos": 2, "peer_pos": None},
    "reduce_scatter_async": {"kind": "collective", "group": "world",
                             "tag": "{name}.rs", "blocking": False,
                             "name_pos": 2, "peer_pos": None},
    "all_gather_async":    {"kind": "collective", "group": "world",
                            "tag": "{name}.ag", "blocking": False,
                            "name_pos": 1, "peer_pos": None},
}

#: engine methods whose bare terminal name is too generic to claim from
#: an arbitrary receiver — these additionally need an engine-shaped
#: receiver chain (``engine.`` / ``eng.`` / ``self.engine.``)
_GENERIC_OPS = {"broadcast", "reduce", "gather"}

#: primitives the engine ops bottom out in — a *public* engine method
#: directly touching one of these is a wire op and must carry metadata
_WIRE_PRIMITIVES = {
    "_begin_collective", "_issue_async", "_send", "_recv", "_recv_into",
    "_subset_reduce", "_subset_bcast",
}

#: the registered protocol entrypoints of the shipped tree:
#: (module, class or None, function, pair_scope).  ``pair_scope`` None
#: exempts the entry from the static tag-pairing rule — its recvs live
#: on another process's entrypoint (the serve plane's push handlers) or
#: behind dynamic tag plumbing; the geometry simulation covers those.
ENTRYPOINTS: Tuple[Tuple[str, Optional[str], str, Optional[str]], ...] = (
    ("kungfu_tpu_torch.parallel.zero", None, "host_bucket_pipeline", "local"),
    ("kungfu_tpu_torch.parallel.zero", None, "host_bucket_all_gather",
     "local"),
    ("kungfu_tpu_torch.parallel.pp", "HostPipeline", "train_step", None),
    ("kungfu_tpu_torch.parallel.pp", "StageBoundary", "replicate_ring",
     "local"),
    ("kungfu_tpu_torch.parallel.pp", "StageBoundary", "recarve", "local"),
    ("kungfu_tpu_torch.elastic.reshard", "ZeroBoundary", "replicate_ring",
     "local"),
    ("kungfu_tpu_torch.elastic.reshard", "ZeroBoundary", "_recarve_channel",
     "local"),
    ("kungfu_tpu_torch.serve.router", "ServeRouter", "_dispatch", None),
    ("kungfu_tpu_torch.serve.router", "ServeRouter", "_replay", None),
    ("kungfu_tpu_torch.elastic.persist", "PersistPlane", "agree_manifest",
     "local"),
)

#: functions named like this anywhere in scan scope are entrypoints too
#: (the lint-fixture hook; scope "local" = full static checking)
ENTRY_NAME_PREFIX = "proto_entry"

_RANK_NAMES = {
    "me", "my_rank", "self_rank", "my_old", "my_new", "my_dp", "my_stage",
    "my_new_stage", "dp_index", "serv", "succ", "pred",
}
_RANK_CALLS = {"rank", "local_rank", "chaos_rank"}


def _is_rank_test(test: ast.AST) -> bool:
    """Does an ``if`` test read rank-like state (so its two sides run on
    different group members)?  Mirrors collective-consistency's
    heuristic, widened with the elastic re-carve vocabulary."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            name = None
            if isinstance(n.func, ast.Attribute):
                name = n.func.attr
            elif isinstance(n.func, ast.Name):
                name = n.func.id
            if name in _RANK_CALLS or (name or "").startswith("_rank"):
                return True
        elif isinstance(n, ast.Name):
            if n.id in _RANK_NAMES or "rank" in n.id.lower():
                return True
        elif isinstance(n, ast.Attribute):
            if "rank" in n.attr.lower() or n.attr in _RANK_NAMES:
                return True
    return False


class Hole:
    """One ``{...}`` hole of a tag template (the f-string expression)."""

    __slots__ = ("src", "node")

    def __init__(self, src: str, node: Optional[ast.AST] = None):
        self.src = src
        self.node = node

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{{{self.src}}}"


class TagTemplate:
    """A wire tag as constant parts + holes; ``skeleton()`` is the
    canonical ``{}``-holed string two sites are matched by."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[object]):
        # merge adjacent constants so equal skeletons compare equal
        merged: List[object] = []
        for p in parts:
            if isinstance(p, str) and merged and isinstance(merged[-1], str):
                merged[-1] += p
            else:
                merged.append(p)
        self.parts = tuple(merged)

    def skeleton(self) -> str:
        return "".join(p if isinstance(p, str) else "{}"
                       for p in self.parts)

    def holes(self) -> List[Hole]:
        return [p for p in self.parts if isinstance(p, Hole)]

    def constant(self) -> bool:
        return all(isinstance(p, str) for p in self.parts)

    def has_constant_part(self) -> bool:
        return any(isinstance(p, str) and p for p in self.parts)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TagTemplate({self.skeleton()!r})"


@dataclass
class BranchCtx:
    test: ast.AST
    side: str  #: "body" / "orelse"
    line: int
    rank_dep: bool

    @property
    def key(self) -> Tuple[int, str]:
        return (self.line, self.side)


@dataclass
class LoopCtx:
    targets: frozenset  #: names bound by the loop target
    reversed_iter: bool
    line: int


@dataclass
class CommSite:
    """One statically-extracted comm issue site inside an entrypoint."""

    op: str
    kind: str  #: "collective" | "p2p-send" | "p2p-recv"
    blocking: bool
    tag: Optional[TagTemplate]
    peer: Optional[str]  #: source text of the peer/rank argument
    line: int
    path: str  #: repo-root relative
    func: str  #: qualname of the containing function
    branches: Tuple[BranchCtx, ...]
    loops: Tuple[LoopCtx, ...]
    order: int

    def rank_guard(self) -> Optional[BranchCtx]:
        """Innermost rank-dependent enclosing branch, if any."""
        for b in reversed(self.branches):
            if b.rank_dep:
                return b
        return None


@dataclass
class FenceSite:
    name: str
    line: int
    path: str
    func: str
    order: int


@dataclass
class WaitSite:
    site: CommSite  #: the async issue site this wait settles
    line: int
    order: int


@dataclass
class EntryProtocol:
    """Everything extracted from one protocol entrypoint."""

    #: display name ("kungfu_tpu_torch.parallel.pp::HostPipeline.train_step")
    name: str
    func: FuncInfo
    pair_scope: Optional[str]
    sites: List[CommSite] = field(default_factory=list)
    fences: List[FenceSite] = field(default_factory=list)
    waits: List[WaitSite] = field(default_factory=list)
    #: (line, reason) for sites whose tag/shape could not be resolved —
    #: non-empty disables the static pairing/deadlock rules (soundness)
    unresolved: List[Tuple[int, str]] = field(default_factory=list)

    @property
    def resolvable(self) -> bool:
        return not self.unresolved

    def p2p_sites(self) -> List[CommSite]:
        return [s for s in self.sites if s.kind != "collective"]

    def collective_sites(self) -> List[CommSite]:
        return [s for s in self.sites if s.kind == "collective"]


# -- engine metadata ---------------------------------------------------------
def engine_specs(root: str) -> Tuple[Dict[str, dict], List[Violation]]:
    """The ``COMM_OP_SPECS`` table of ``root``'s engine module (parsed,
    never imported), cross-checked both ways against the actual
    ``CollectiveEngine`` method defs.  Falls back to
    :data:`FALLBACK_SPECS` for trees without an engine (fixtures)."""
    from kungfu_tpu_torch.analysis.core import parse_module

    path = os.path.join(root, ENGINE_RELPATH)
    if not os.path.isfile(path):
        return dict(FALLBACK_SPECS), []
    mod = parse_module(path)
    if mod.tree is None:
        return dict(FALLBACK_SPECS), []
    rel = relpath(root, path)
    out: List[Violation] = []
    specs: Optional[Dict[str, dict]] = None
    spec_line = 1
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "COMM_OP_SPECS"):
            spec_line = node.lineno
            try:
                specs = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                out.append(Violation(
                    CHECKER, rel, node.lineno,
                    "COMM_OP_SPECS must be a pure literal dict — the "
                    "analysis layer reads it without importing the "
                    "engine"))
                return dict(FALLBACK_SPECS), out
    if specs is None:
        out.append(Violation(
            CHECKER, rel, 1,
            "comm/engine.py carries no COMM_OP_SPECS table — every "
            "public wire op needs static protocol metadata"))
        return dict(FALLBACK_SPECS), out

    # both-ways drift check against the CollectiveEngine method defs
    methods: Dict[str, ast.FunctionDef] = {}
    wire_ops: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == "CollectiveEngine":
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    methods[m.name] = m
                    if not m.name.startswith("_"):
                        called = set()
                        for n in ast.walk(m):
                            if isinstance(n, ast.Call):
                                t, _ = _terminal_and_receiver(n.func)
                                if t:
                                    called.add(t)
                        if called & _WIRE_PRIMITIVES:
                            wire_ops.add(m.name)
    for op in sorted(specs):
        if op not in methods:
            out.append(Violation(
                CHECKER, rel, spec_line,
                f"COMM_OP_SPECS lists `{op}` but CollectiveEngine "
                "defines no such method — stale protocol metadata"))
    for op in sorted(wire_ops - set(specs)):
        out.append(Violation(
            CHECKER, rel, methods[op].lineno,
            f"CollectiveEngine.{op} touches the wire primitives but "
            "has no COMM_OP_SPECS entry — wire ops need static "
            "protocol metadata (op kind, group axis, tag template)"))
    return specs, out


# -- template resolution -----------------------------------------------------
def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 - best-effort source text
        return "<expr>"


def _single_return_template(func_node: ast.AST) -> Optional[ast.AST]:
    """The returned expression of a ``def f(...): return <tag expr>``
    helper (docstring allowed), else None."""
    body = [s for s in func_node.body
            if not (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant)
                    and isinstance(s.value.value, str))]
    if len(body) == 1 and isinstance(body[0], ast.Return) \
            and body[0].value is not None:
        return body[0].value
    return None


class _Resolver:
    """Scope-aware lookup of bare/self call targets for one entrypoint
    walk: nested defs (by parent chain), same-class methods, same-module
    functions — the conservative subset the extractor descends into."""

    def __init__(self, graph: CallGraph, entry: FuncInfo):
        self.graph = graph
        self.entry = entry
        #: nested defs by enclosing function — bare names resolve up
        #: the CALLER's lexical scope chain, so helpers nested inside a
        #: descended-into method are visible too
        self._children: Dict[int, Dict[str, FuncInfo]] = {}
        for f in graph.functions:
            if f.parent is not None:
                self._children.setdefault(
                    id(f.parent), {}).setdefault(f.name, f)

    def target_of(self, call: ast.Call,
                  caller: FuncInfo) -> Optional[FuncInfo]:
        terminal, receiver = _terminal_and_receiver(call.func)
        if terminal is None:
            return None
        if not receiver:
            scope: Optional[FuncInfo] = caller
            while scope is not None:
                hit = self._children.get(id(scope), {}).get(terminal)
                if hit is not None:
                    return hit
                scope = scope.parent
            return self.graph.by_qualname.get(
                f"{caller.module}::{terminal}")
        if receiver == ("self",) and caller.cls:
            return self.graph.by_qualname.get(
                f"{caller.module}::{caller.cls}.{terminal}")
        return None


class _Walker:
    """One entrypoint's comm-site walk: program order, branch + loop
    context, straight-line tag environments, bounded descent into
    resolved local helpers."""

    MAX_DEPTH = 3

    def __init__(self, graph: CallGraph, specs: Dict[str, dict],
                 entry: FuncInfo, proto: EntryProtocol):
        self.graph = graph
        self.specs = specs
        self.entry = entry
        self.proto = proto
        self.resolver = _Resolver(graph, entry)
        self._order = 0
        self._visiting: Set[int] = set()
        self._handles: Dict[str, CommSite] = {}
        #: per walked function (innermost last): its parameters bound to
        #: the tag templates the call site passed (see _bind_args)
        self._fwd: List[Dict[str, TagTemplate]] = []

    def run(self) -> None:
        self._walk_func(self.entry, (), (), 0)

    # -- function / statement walk ---------------------------------------
    def _walk_func(self, func: FuncInfo, branches: Tuple[BranchCtx, ...],
                   loops: Tuple[LoopCtx, ...], depth: int,
                   fwd: Optional[Dict[str, TagTemplate]] = None) -> None:
        key = id(func.node)
        if key in self._visiting:
            return
        self._visiting.add(key)
        env: Dict[str, TagTemplate] = {}
        self._fwd.append(fwd or {})
        try:
            self._walk_stmts(func.node.body, func, env, branches, loops,
                             depth)
        finally:
            self._fwd.pop()
            self._visiting.discard(key)

    def _walk_stmts(self, stmts: Sequence[ast.stmt], func: FuncInfo,
                    env: Dict[str, TagTemplate],
                    branches: Tuple[BranchCtx, ...],
                    loops: Tuple[LoopCtx, ...], depth: int) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes walked on call
            if isinstance(stmt, ast.If):
                self._visit_expr(stmt.test, func, env, branches, loops,
                                 depth, stmt)
                b = BranchCtx(stmt.test, "body", stmt.lineno,
                              _is_rank_test(stmt.test))
                self._walk_stmts(stmt.body, func, env, branches + (b,),
                                 loops, depth)
                o = BranchCtx(stmt.test, "orelse", stmt.lineno,
                              _is_rank_test(stmt.test))
                self._walk_stmts(stmt.orelse, func, env, branches + (o,),
                                 loops, depth)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._visit_expr(stmt.iter, func, env, branches, loops,
                                 depth, stmt)
                lc = LoopCtx(frozenset(_target_names(stmt.target)),
                             _is_reversed_iter(stmt.iter), stmt.lineno)
                self._walk_stmts(stmt.body, func, env, branches,
                                 loops + (lc,), depth)
                self._walk_stmts(stmt.orelse, func, env, branches, loops,
                                 depth)
                continue
            if isinstance(stmt, ast.While):
                self._visit_expr(stmt.test, func, env, branches, loops,
                                 depth, stmt)
                lc = LoopCtx(frozenset(), False, stmt.lineno)
                self._walk_stmts(stmt.body, func, env, branches,
                                 loops + (lc,), depth)
                self._walk_stmts(stmt.orelse, func, env, branches, loops,
                                 depth)
                continue
            if isinstance(stmt, ast.Try):
                self._walk_stmts(stmt.body, func, env, branches, loops,
                                 depth)
                for h in stmt.handlers:
                    self._walk_stmts(h.body, func, env, branches, loops,
                                     depth)
                self._walk_stmts(stmt.orelse, func, env, branches, loops,
                                 depth)
                self._walk_stmts(stmt.finalbody, func, env, branches,
                                 loops, depth)
                continue
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    self._visit_expr(item.context_expr, func, env,
                                     branches, loops, depth, stmt)
                self._walk_stmts(stmt.body, func, env, branches, loops,
                                 depth)
                continue
            if isinstance(stmt, ast.Assign):
                site = self._visit_expr(stmt.value, func, env, branches,
                                        loops, depth, stmt)
                if len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    name = stmt.targets[0].id
                    if site is not None and not site.blocking:
                        self._handles[name] = site
                    else:
                        tmpl = self._template_of(stmt.value, func, env)
                        if tmpl is not None:
                            env[name] = tmpl
                        else:
                            env.pop(name, None)
                continue
            # everything else: visit contained expressions in order
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._visit_expr(child, func, env, branches, loops,
                                     depth, stmt)

    def _visit_expr(self, expr: Optional[ast.AST], func: FuncInfo,
                    env: Dict[str, TagTemplate],
                    branches: Tuple[BranchCtx, ...],
                    loops: Tuple[LoopCtx, ...], depth: int,
                    stmt: ast.stmt) -> Optional[CommSite]:
        """Process every call in ``expr``; returns the comm site when the
        expression IS directly a comm call (assignment tracking)."""
        if expr is None:
            return None
        direct: Optional[CommSite] = None
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            comp = _comp_loops(expr, node)
            site = self._handle_call(node, func, env, branches,
                                     loops + comp, depth)
            if node is expr and site is not None:
                direct = site
        return direct

    # -- call classification ----------------------------------------------
    def _handle_call(self, call: ast.Call, func: FuncInfo,
                     env: Dict[str, TagTemplate],
                     branches: Tuple[BranchCtx, ...],
                     loops: Tuple[LoopCtx, ...],
                     depth: int) -> Optional[CommSite]:
        terminal, receiver = _terminal_and_receiver(call.func)
        if terminal is None:
            return None
        spec = self.specs.get(terminal)
        if spec is not None and receiver \
                and (terminal not in _GENERIC_OPS
                     or _engineish(receiver)):
            return self._record_site(call, terminal, spec, func, env,
                                     branches, loops)
        if terminal in ("send", "recv") and receiver \
                and receiver[-1] in ("chan", "channel"):
            spec = {"kind": "p2p-send" if terminal == "send"
                    else "p2p-recv", "group": "pair", "blocking": True,
                    "name_pos": 1, "peer_pos": 0}
            return self._record_site(call, f"channel.{terminal}", spec,
                                     func, env, branches, loops)
        if terminal == "_recv_or_fail":
            spec = {"kind": "p2p-recv", "group": "pair", "blocking": True,
                    "name_pos": 4, "peer_pos": 1}
            return self._record_site(call, "_recv_or_fail", spec, func,
                                     env, branches, loops)
        if terminal == "drain_async" or terminal in _FENCE_CALLS:
            self.proto.fences.append(FenceSite(
                terminal, call.lineno, func.path, func.qualname,
                self._next_order()))
            return None
        if terminal == "wait" and len(receiver) == 1 \
                and receiver[0] in self._handles:
            self.proto.waits.append(WaitSite(
                self._handles[receiver[0]], call.lineno,
                self._next_order()))
            return None
        if depth < self.MAX_DEPTH:
            target = self.resolver.target_of(call, func)
            if target is not None and target is not self.entry:
                self._walk_func(target, branches, loops, depth + 1,
                                self._bind_args(call, target, func, env))
        return None

    def _bind_args(self, call: ast.Call, target: FuncInfo,
                   func: FuncInfo,
                   env: Dict[str, TagTemplate]) -> Dict[str, TagTemplate]:
        """The callee's parameters bound to the tag templates of the
        call's arguments, where they resolve.  Used only where the
        parameter IS the wire tag of a comm call in the callee: a local
        send helper (``send(dst, seg_name("p", i), arr, "params")``
        around ``chan.send(dst, name, ...)``) keeps the caller's
        template at the wire, while a parameter inside an f-string hole
        stays a hole, as the reference's extraction leaves it."""
        a = target.node.args
        params = [p.arg for p in a.posonlyargs + a.args]
        if _terminal_and_receiver(call.func)[1] == ("self",) and params:
            params = params[1:]
        out: Dict[str, TagTemplate] = {}
        for name, arg in zip(params, call.args):
            if isinstance(arg, ast.Starred):
                break
            tmpl = self._template_of(arg, func, env)
            if tmpl is not None:
                out[name] = tmpl
        known = set(params) | {p.arg for p in a.kwonlyargs}
        for kw in call.keywords:
            if kw.arg in known:
                tmpl = self._template_of(kw.value, func, env)
                if tmpl is not None:
                    out[kw.arg] = tmpl
        return out

    def _record_site(self, call: ast.Call, op: str, spec: dict,
                     func: FuncInfo, env: Dict[str, TagTemplate],
                     branches: Tuple[BranchCtx, ...],
                     loops: Tuple[LoopCtx, ...]) -> CommSite:
        tag_expr = _arg(call, spec.get("name_pos"), "name")
        tmpl = (self._template_of(tag_expr, func, env)
                if tag_expr is not None else None)
        if tmpl is None and isinstance(tag_expr, ast.Name) and self._fwd:
            # a wire tag forwarded whole through a send helper's parameter
            tmpl = self._fwd[-1].get(tag_expr.id)
        if tmpl is not None and not tmpl.has_constant_part():
            tmpl = None
        peer_expr = (_arg(call, spec["peer_pos"], None)
                     if spec.get("peer_pos") is not None else None)
        site = CommSite(
            op=op, kind=spec["kind"], blocking=spec.get("blocking", True),
            tag=tmpl,
            peer=_src(peer_expr) if peer_expr is not None else None,
            line=call.lineno, path=func.path, func=func.qualname,
            branches=branches, loops=loops, order=self._next_order())
        if tmpl is None:
            self.proto.unresolved.append(
                (call.lineno, f"dynamic tag for {op}"))
        self.proto.sites.append(site)
        return site

    def _next_order(self) -> int:
        self._order += 1
        return self._order

    # -- tag templates -----------------------------------------------------
    def _template_of(self, expr: Optional[ast.AST], func: FuncInfo,
                     env: Dict[str, TagTemplate],
                     _depth: int = 0) -> Optional[TagTemplate]:
        if expr is None or _depth > 4:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return TagTemplate([expr.value])
        if isinstance(expr, ast.JoinedStr):
            parts: List[object] = []
            for v in expr.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                elif isinstance(v, ast.FormattedValue):
                    inner = self._template_of(v.value, func, env,
                                              _depth + 1)
                    if inner is not None and v.format_spec is None \
                            and v.conversion == -1:
                        parts.extend(inner.parts)
                    else:
                        parts.append(Hole(_src(v.value), v.value))
                else:
                    return None
            return TagTemplate(parts)
        if isinstance(expr, ast.Name):
            return env.get(expr.id)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            left = self._template_of(expr.left, func, env, _depth + 1)
            right = self._template_of(expr.right, func, env, _depth + 1)
            if left is not None and right is not None:
                return TagTemplate(list(left.parts) + list(right.parts))
            return None
        if isinstance(expr, ast.Call):
            target = self.resolver.target_of(expr, func)
            if target is None:
                return None
            ret = _single_return_template(target.node)
            if ret is None:
                return None
            return self._template_of(ret, target, {}, _depth + 1)
        return None


def _engineish(receiver: Tuple[str, ...]) -> bool:
    last = receiver[-1]
    return "engine" in last or last in ("eng", "self")


def _arg(call: ast.Call, pos: Optional[int],
         kw: Optional[str]) -> Optional[ast.AST]:
    if kw is not None:
        for k in call.keywords:
            if k.arg == kw:
                return k.value
    if pos is not None and pos < len(call.args):
        a = call.args[pos]
        if not isinstance(a, ast.Starred):
            return a
    return None


def _target_names(target: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _is_reversed_iter(it: ast.AST) -> bool:
    """Is the loop iterable order-reversed (``reversed(...)`` anywhere
    in the iterable chain, or a negative-step ``range``)?"""
    for n in ast.walk(it):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            if n.func.id == "reversed":
                return True
            if n.func.id == "range" and len(n.args) == 3:
                step = n.args[2]
                if isinstance(step, ast.UnaryOp) \
                        and isinstance(step.op, ast.USub):
                    return True
                if isinstance(step, ast.Constant) \
                        and isinstance(step.value, (int, float)) \
                        and step.value < 0:
                    return True
    return False


def _comp_loops(expr: ast.AST, call: ast.Call) -> Tuple[LoopCtx, ...]:
    """Loop contexts contributed by comprehensions in ``expr`` that
    enclose ``call`` (the serial bucket loops are comprehensions)."""
    out: List[LoopCtx] = []
    for node in ast.walk(expr):
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            if any(n is call for n in ast.walk(node)):
                for gen in node.generators:
                    out.append(LoopCtx(
                        frozenset(_target_names(gen.target)),
                        _is_reversed_iter(gen.iter), node.lineno))
    return tuple(out)


# -- entry discovery ---------------------------------------------------------
def entry_protocols(
        root: str) -> Tuple[Dict[str, dict], List[EntryProtocol],
                            List[Violation]]:
    """(engine op specs, extracted entry protocols, metadata findings)
    for ``root`` — the input of every proto-verify pass."""
    graph = project_graph(root)
    specs, violations = engine_specs(root)
    entries: List[EntryProtocol] = []
    seen: Set[int] = set()
    for module, cls, name, scope in ENTRYPOINTS:
        qual = f"{module}::{cls + '.' if cls else ''}{name}"
        func = graph.by_qualname.get(qual)
        if func is None:
            continue  # subset trees (fixtures) simply lack the module
        entries.append(_extract(graph, specs, func, scope))
        seen.add(id(func))
    for func in graph.functions:
        if func.name.startswith(ENTRY_NAME_PREFIX) \
                and id(func) not in seen and func.parent is None:
            entries.append(_extract(graph, specs, func, "local"))
    return specs, entries, violations


def _extract(graph: CallGraph, specs: Dict[str, dict], func: FuncInfo,
             scope: Optional[str]) -> EntryProtocol:
    proto = EntryProtocol(name=func.qualname, func=func, pair_scope=scope)
    _Walker(graph, specs, func, proto).run()
    proto.sites.sort(key=lambda s: s.order)
    return proto
