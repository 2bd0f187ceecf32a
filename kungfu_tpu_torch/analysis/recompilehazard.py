"""recompile-hazard checker: no membership constants baked into jit or
into a captured CUDA graph (port of
``kungfu_tpu/analysis/recompilehazard.py``).

The port's counterpart of a compiled step is a CUDA graph: host code in
capture scope (:mod:`~kungfu_tpu_torch.analysis.axisenv`) runs once, at
capture, and every replay reuses what it read.  In capture scope — a
``torch.cuda.graph`` block, the functions and lambdas handed to a
capture-entry parameter, and what they reach — the rule flags
``torch.cuda.device_count()``, ``os.environ`` reads, ``len(peers)``-style
peer-list lengths and ``.rank()`` calls, and a captured lambda or
nested def that closes over a value its builder assigned from one of
those.  The ``static_argnums``/``static_argnames`` checks have no torch
counterpart and apply to jax code only.

Elastic resize is this framework's core maneuver — and its quietest
failure mode is compiled code that froze the OLD world into itself.
Anything cluster-size-shaped that reaches a traced body as a Python
value becomes a compile-time constant: at best every resize triggers a
full recompile of every step function (a recompile *storm* across the
pod — cf. the per-step recompilation tax in arXiv:1909.09756), at worst
the stale constant silently mis-shapes a collective after a shrink.
Three shapes, on the :mod:`~kungfu_tpu_torch.analysis.axisenv` jit-scope map:

* **membership read in traced code** — inside any function whose body
  is traced (jit/pmap/shard_map root, or reachable from one through
  calls/callbacks): ``jax.device_count()`` / ``jax.devices()`` /
  ``jax.process_count()`` / ``jax.process_index()``, ``len(peers)``-
  style peer-list lengths, ``os.environ`` reads, and per-process
  ``.rank()`` calls.  Sizes belong to the mesh: use
  ``lax.axis_index``/``axis_size`` (resize builds a new mesh, so those
  are correct by construction), or rebuild the step per mesh epoch the
  way :mod:`kungfu_tpu.parallel.zero` does (``comm``-scoped values are
  epoch-scoped by design and are NOT flagged).
* **hazardous static args** — ``jit(..., static_argnums=...)`` indices
  out of range of the target's signature, static parameters whose names
  say they vary per step (``batch``, ``step``, ``grads``, ...; every
  distinct value compiles a new executable), and static parameters with
  non-hashable (list/dict/set) defaults — a ``TypeError`` the first
  time the default is actually used.
* **closure leak** — a nested function that enters jit scope and closes
  over a variable its enclosing function assigned from a
  process-global membership source (``jax.device_count()``,
  ``jax.devices()``, ``jax.process_count()``, ``os.environ``): the
  world size at *build* time is frozen into the step and survives every
  resize.

Suppress a deliberate trace-time constant (with a comment saying why it
cannot go stale) via ``# kflint: allow(recompile-hazard)``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from kungfu_tpu_torch.analysis.axisenv import axis_environment, fkey
from kungfu_tpu_torch.analysis.core import (
    Violation,
    parse_module,
    suppressed,
    terminal_name,
)

CHECKER = "recompile-hazard"

_SKIP_PREFIXES = ("kungfu_tpu_torch/analysis/",)

#: process-global world facts; calling these in traced code bakes the
#: launch-time world in
_PROCESS_GLOBAL = {
    "device_count", "local_device_count", "process_count",
    "process_index", "host_count",
}
_DEVICE_LISTS = {"devices", "local_devices"}

#: receiver/attr names that read as peer-list membership
_MEMBERSHIP_NAMES = {
    "peers", "workers", "hosts", "members", "survivors", "replicas",
    "peer_list", "host_list",
}

#: static params with these names vary per step — each new value is a
#: fresh compile
_VARYING_PARAMS = {
    "step", "batch", "x", "grads", "grad", "params", "state",
    "opt_state", "inputs", "targets", "ids", "data", "batch_idx", "t",
    "iteration",
}


def _jaxish(receiver: Tuple[str, ...]) -> bool:
    return bool(receiver) and receiver[0] == "jax"


def _torchish(receiver: Tuple[str, ...]) -> bool:
    return bool(receiver) and receiver[0] == "torch"


def _environ_read(site) -> bool:
    if site.callee == "getenv" and (not site.receiver
                                    or site.receiver[-1] == "os"):
        return True
    return site.callee == "get" and bool(site.receiver) \
        and site.receiver[-1] == "environ"


def _len_membership(site) -> Optional[str]:
    if site.callee != "len" or not site.node.args:
        return None
    arg = site.node.args[0]
    name = None
    if isinstance(arg, ast.Name):
        name = arg.id
    elif isinstance(arg, ast.Attribute):
        name = arg.attr
    elif isinstance(arg, ast.Call):
        t = terminal_name(arg.func)
        if t in _DEVICE_LISTS:
            return f"{t}()"
        return None
    if name and name.lower() in _MEMBERSHIP_NAMES:
        return name
    return None


def _params_of(node: ast.AST) -> Tuple[List[str], bool,
                                       Dict[str, ast.AST], List[str]]:
    """(positional param names, has *args, {param: default expr},
    keyword-only param names — legal static_argnames targets too)."""
    a = node.args
    params = [p.arg for p in (list(a.posonlyargs) + list(a.args))]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    defaults: Dict[str, ast.AST] = {}
    named = [p.arg for p in (list(a.posonlyargs) + list(a.args))]
    for p, d in zip(named[len(named) - len(a.defaults):], a.defaults):
        defaults[p] = d
    kwonly = [k.arg for k in a.kwonlyargs]
    for p, d in zip(kwonly, a.kw_defaults):
        if d is not None:
            defaults[p] = d
    return params, a.vararg is not None, defaults, kwonly


def _nonhashable_default(expr: Optional[ast.AST]) -> bool:
    return isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp))


def check(root: str) -> List[Violation]:
    env = axis_environment(root)
    graph = env.graph
    out: List[Violation] = []
    supp_cache: Dict[str, Dict[int, set]] = {}

    def flag(path: str, line: int, msg: str) -> None:
        if path not in supp_cache:
            supp_cache[path] = parse_module(os.path.join(root, path)).supp
        if not suppressed(supp_cache[path], line, CHECKER):
            out.append(Violation(CHECKER, path, line, msg))

    def in_scope(func) -> bool:
        return not any(func.path.startswith(p) for p in _SKIP_PREFIXES)

    # -- membership reads inside traced code ------------------------------
    for func in graph.functions:
        if not in_scope(func) or fkey(func) not in env.jit_roots:
            continue
        roots = sorted(env.jit_roots[fkey(func)])
        via = (f" (traced via jitted `{roots[0]}`)"
               if roots and roots[0] != func.name else "")
        for site in func.calls:
            if site.callee in _PROCESS_GLOBAL and (
                    _jaxish(site.receiver) or not site.receiver):
                flag(func.path, site.line,
                     f"`{site.callee}()` inside traced code{via} bakes the "
                     f"launch-time world in as a Python constant — stale "
                     f"after an elastic resize, and every size change "
                     f"recompiles; use lax.axis_index/axis_size over the "
                     f"mesh, or rebuild per mesh epoch")
            elif site.callee in _DEVICE_LISTS and _jaxish(site.receiver):
                flag(func.path, site.line,
                     f"`jax.{site.callee}()` inside traced code{via} is a "
                     f"trace-time constant of the launch-time device set — "
                     f"derive shapes from the mesh instead")
            elif _environ_read(site):
                flag(func.path, site.line,
                     f"environment read inside traced code{via} traces to "
                     f"a constant — resize/config changes never reach the "
                     f"compiled step")
            elif site.callee in ("rank", "local_rank") and site.receiver \
                    and site.receiver[0] not in ("jax", "lax"):
                flag(func.path, site.line,
                     f"`.{site.callee}()` inside traced code{via} freezes "
                     f"a per-process rank into the compiled step — after "
                     f"a shrink the surviving ranks renumber; use "
                     f"lax.axis_index over the mesh axis")
            else:
                m = _len_membership(site)
                if m is not None:
                    flag(func.path, site.line,
                         f"len({m}) inside traced code{via} bakes the "
                         f"peer-list length in as a shape/constant — a "
                         f"resize silently recompiles (or keeps the stale "
                         f"size); take sizes from the mesh axis instead")

    # -- hazardous static args --------------------------------------------
    for site in env.jit_sites:
        func = site.func
        if not in_scope(func) or not site.targets:
            continue
        sigs = [_params_of(t.node) for t in site.targets]
        if site.static_argnums is not None:
            v = env.eval_in(func, site.static_argnums)
            idxs = []
            if isinstance(v, int):
                idxs = [v]
            elif isinstance(v, tuple) and all(
                    isinstance(i, int) for i in v):
                idxs = list(v)
            for i in idxs:
                oob = [s for s in sigs if not s[1] and i >= len(s[0])]
                if len(oob) == len(sigs):
                    params = sigs[0][0]
                    flag(func.path, site.node.lineno,
                         f"static_argnums={i} is out of range for "
                         f"`{site.targets[0].name}` "
                         f"({len(params)} positional parameter(s))")
                    continue
                names = {s[0][i] for s in sigs if i < len(s[0])}
                varying = names & _VARYING_PARAMS
                if varying and len(varying) == len(names):
                    flag(func.path, site.node.lineno,
                         f"static_argnums marks `{sorted(varying)[0]}` "
                         f"static — a per-step-varying argument compiles a "
                         f"NEW executable every call (recompile storm)")
                for s in sigs:
                    if i < len(s[0]) and _nonhashable_default(
                            s[2].get(s[0][i])):
                        flag(func.path, site.node.lineno,
                             f"static argument `{s[0][i]}` has a "
                             f"non-hashable default — jit static args must "
                             f"hash; this raises the first time the "
                             f"default is used")
                        break
        if site.static_argnames is not None:
            v = env.eval_in(func, site.static_argnames)
            names = []
            if isinstance(v, str):
                names = [v]
            elif isinstance(v, tuple) and all(
                    isinstance(s, str) for s in v):
                names = list(v)
            for name in names:
                known = [s for s in sigs if name in s[0]
                         or name in s[3]]
                if not known:
                    flag(func.path, site.node.lineno,
                         f"static_argnames={name!r} does not name a "
                         f"parameter of `{site.targets[0].name}`")
                elif name in _VARYING_PARAMS:
                    flag(func.path, site.node.lineno,
                         f"static_argnames marks `{name}` static — a "
                         f"per-step-varying argument compiles a NEW "
                         f"executable every call (recompile storm)")

    # -- closure leaks ----------------------------------------------------
    # nested jitted functions closing over process-global membership
    for func in graph.functions:
        if not in_scope(func):
            continue
        # hazard assigns in func's own scope
        hazards: Dict[str, Tuple[str, int]] = {}
        stack: List[ast.AST] = list(func.node.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                from kungfu_tpu_torch.analysis.axisenv import MESH_CTORS

                # a Mesh IS the sanctioned carrier of the device set:
                # resize builds a new mesh and re-traces, so closing
                # over one is the pattern, not the hazard
                if any(isinstance(sub, ast.Call)
                       and terminal_name(sub.func) in MESH_CTORS
                       for sub in ast.walk(n.value)):
                    continue
                for sub in ast.walk(n.value):
                    if isinstance(sub, ast.Call):
                        t = terminal_name(sub.func)
                        if t in (_PROCESS_GLOBAL | _DEVICE_LISTS):
                            hazards[n.targets[0].id] = (
                                f"{t}()", n.lineno)
                    elif isinstance(sub, ast.Attribute) \
                            and sub.attr == "environ":
                        hazards[n.targets[0].id] = (
                            "os.environ", n.lineno)
            stack.extend(ast.iter_child_nodes(n))
        if not hazards:
            continue
        # nested defs of func that enter jit scope
        nested_nodes = {id(n): n for n in ast.walk(func.node)
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and n is not func.node}
        for g in graph.functions:
            if g.module != func.module or id(g.node) not in nested_nodes:
                continue
            if fkey(g) not in env.jit_roots:
                continue
            bound: Set[str] = {p.arg for p in (
                list(g.node.args.posonlyargs) + list(g.node.args.args)
                + list(g.node.args.kwonlyargs))}
            for n in ast.walk(g.node):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    bound.add(n.id)
            for n in ast.walk(g.node):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                        and n.id in hazards and n.id not in bound:
                    src, aline = hazards[n.id]
                    flag(func.path, n.lineno,
                         f"jitted `{g.name}` closes over `{n.id}` "
                         f"(assigned from {src} at line {aline}) — the "
                         f"launch-time world size is frozen into the "
                         f"compiled step and survives every elastic "
                         f"resize; derive it from the mesh or rebuild the "
                         f"step per mesh epoch")
                    break

    _check_capture(env, flag, in_scope)
    return sorted(out, key=lambda v: (v.path, v.line, v.message))


def _capture_read(site) -> Optional[str]:
    """The message stem of a membership read, for capture scope."""
    if site.callee in _PROCESS_GLOBAL and (
            not site.receiver or _jaxish(site.receiver)
            or _torchish(site.receiver)):
        return (f"`{site.callee}()` inside captured code{{via}} is frozen "
                f"into the CUDA graph — stale after an elastic resize; read "
                f"it before the capture and capture again per membership "
                f"epoch")
    if _environ_read(site):
        return ("environment read inside captured code{via} runs once, at "
                "capture — config changes never reach the replayed graph")
    if site.callee in ("rank", "local_rank") and site.receiver \
            and site.receiver[0] not in ("jax", "lax", "torch"):
        return (f"`.{site.callee}()` inside captured code{{via}} freezes a "
                f"per-process rank into the CUDA graph — after a shrink the "
                f"surviving ranks renumber")
    m = _len_membership(site)
    if m is not None:
        return (f"len({m}) inside captured code{{via}} freezes the peer-list "
                f"length into the CUDA graph — a resize keeps the stale "
                f"size")
    return None


def _capture_hazard(value: ast.AST) -> Optional[str]:
    """What a capture-scope closure must not freeze: the reference's
    process-global reads plus ``len(peers)`` and ``.rank()``."""
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call):
            t = terminal_name(sub.func)
            if t in (_PROCESS_GLOBAL | _DEVICE_LISTS):
                return f"{t}()"
            if t in ("rank", "local_rank") \
                    and isinstance(sub.func, ast.Attribute):
                return f".{t}()"
            if t == "len" and sub.args:
                arg = sub.args[0]
                name = (arg.id if isinstance(arg, ast.Name) else
                        arg.attr if isinstance(arg, ast.Attribute) else None)
                if name and name.lower() in _MEMBERSHIP_NAMES:
                    return f"len({name})"
        elif isinstance(sub, ast.Attribute) and sub.attr == "environ":
            return "os.environ"
    return None


def _free_loads(node: ast.AST, bound: Set[str]) -> List[ast.Name]:
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            and n.id not in bound]


def _check_capture(env, flag, in_scope) -> None:
    graph = env.graph

    def reads(func, calls, via: str) -> None:
        for call in calls:
            site = env.site_for(func, call)
            stem = _capture_read(site)
            if stem is not None:
                flag(func.path, call.lineno, stem.format(via=via))

    # -- membership reads in captured functions, blocks and lambdas -------
    for func in graph.functions:
        roots = env.capture_roots.get(fkey(func))
        if not roots or not in_scope(func):
            continue
        first = sorted(roots)[0]
        via = f" (captured via `{first}`)" if first != func.name else ""
        reads(func, [s.node for s in func.calls], via)
    for func, block, prov in env.capture_regions:
        if in_scope(func):
            reads(func, [n for stmt in block.body for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)], f" ({prov})")
    for func, lam, prov in env.capture_lambdas:
        if in_scope(func):
            reads(func, [n for n in ast.walk(lam.body)
                         if isinstance(n, ast.Call)], f" (passed to {prov})")

    # -- closures: captured lambdas and nested defs over a hazard ---------
    hazards_of: Dict[int, Dict[str, Tuple[str, int]]] = {}

    def hazards(func) -> Dict[str, Tuple[str, int]]:
        if id(func.node) not in hazards_of:
            found: Dict[str, Tuple[str, int]] = {}
            stack: List[ast.AST] = list(func.node.body)
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                    continue
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name):
                    src = _capture_hazard(n.value)
                    if src is not None:
                        found[n.targets[0].id] = (src, n.lineno)
                stack.extend(ast.iter_child_nodes(n))
            hazards_of[id(func.node)] = found
        return hazards_of[id(func.node)]

    def leak(func, body: ast.AST, args: ast.arguments, what: str) -> None:
        found = hazards(func)
        if not found:
            return
        bound = {p.arg for p in (list(args.posonlyargs) + list(args.args)
                                 + list(args.kwonlyargs))}
        bound |= {n.id for n in ast.walk(body)
                  if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
        for n in _free_loads(body, bound):
            if n.id in found:
                src, aline = found[n.id]
                flag(func.path, n.lineno,
                     f"captured {what} closes over `{n.id}` (assigned from "
                     f"{src} at line {aline}) — the launch-time world is "
                     f"frozen into the CUDA graph and survives every elastic "
                     f"resize; capture again per membership epoch")
                break

    for func, lam, _ in env.capture_lambdas:
        if in_scope(func):
            leak(func, lam.body, lam.args, "`<lambda>`")
    for g in graph.functions:
        if g.parent is None or fkey(g) not in env.capture_roots \
                or not in_scope(g.parent):
            continue
        leak(g.parent, g.node, g.node.args, f"`{g.name}`")
