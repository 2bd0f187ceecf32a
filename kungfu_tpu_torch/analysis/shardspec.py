"""shard-spec checker: PartitionSpecs must match the mesh that runs them
(port of ``kungfu_tpu/analysis/shardspec.py``).

The port has the reference's object: ``parallel/train.py``
``PartitionSpec`` (alias ``P``), consumed by ``shard_stacked`` /
``gather_stacked``, ``ShardedTrainer._layout``'s spec trees and
``parallel/pp.py StageModule.param_specs``.  The same rule applies to
it: every literal axis must be one a rank world of the tree declares
(:mod:`~kungfu_tpu_torch.analysis.axisenv`), and no axis may appear
twice.  A class named ``PartitionSpec``, a module-level alias of it
(``P = PartitionSpec``) and an import of either are recognized as the
jax import is.  The port has no ``shard_map``, so the ``in_specs`` /
``out_specs`` checks below (mesh precision and arity) apply to jax
code only.

A ``PartitionSpec`` axis the mesh never declared, a duplicated axis
(one mesh axis cannot shard two dims), or an ``in_specs``/``out_specs``
tuple whose arity disagrees with the mapped function's signature all
raise at trace time — on the pod, hours into a queue slot, never in a
single-device unit test.  Three checks, on the shared
:mod:`~kungfu_tpu_torch.analysis.axisenv` substrate:

* **axis validity** — every *literal* axis entry of every
  ``PartitionSpec(...)`` (aliased ``P`` included, resolved through the
  module's real imports) must be an axis some mesh in the tree declares;
  where the spec is lexically an ``in_specs``/``out_specs`` of a
  ``shard_map`` whose mesh resolved (or the spec half of a
  ``NamedSharding(mesh, ...)``), it must name an axis of THAT mesh.
  ``None`` entries (unconstrained dims) and dynamic expressions are
  fine; nested tuples (multi-axis dims) are flattened.
* **duplicate axis** — the same axis twice in one spec.
* **arity** — ``in_specs`` given as a literal tuple is diffed against
  the mapped function's positional signature (defaults give a range;
  ``*args`` drops the upper bound), and a literal ``out_specs`` tuple
  against the function's return statements when every return is an
  explicit tuple literal.  Either mismatch is today's
  ``TypeError``/``ValueError`` at trace time; pre-submit here.

Suppress with ``# kflint: allow(shard-spec)`` on the flagged line.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from kungfu_tpu_torch.analysis.axisenv import AxisEnv, axis_environment
from kungfu_tpu_torch.analysis.callgraph import _module_of
from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_py_files,
    parse_module,
    relpath,
    suppressed,
    terminal_name,
)

CHECKER = "shard-spec"

_SKIP_PREFIXES = ("kungfu_tpu_torch/analysis/",)


def _pspec_aliases(tree: ast.AST) -> Set[str]:
    """Names this module binds to jax.sharding.PartitionSpec."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "PartitionSpec":
                    out.add(a.asname or a.name)
    out.add("PartitionSpec")  # attribute form jax.sharding.PartitionSpec
    return out


def _spec_classes(root: str) -> Dict[str, Set[str]]:
    """module -> names it binds to a PartitionSpec of its own: a class
    of that name, or a module-level alias of one (``P =
    PartitionSpec``)."""
    out: Dict[str, Set[str]] = {}
    for path in iter_py_files(root):
        tree = parse_module(path).tree
        if tree is None:
            continue
        names = {n.name for n in tree.body
                 if isinstance(n, ast.ClassDef) and n.name == "PartitionSpec"}
        if not names:
            continue
        for _ in range(2):
            for n in tree.body:
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id in names:
                    names.add(n.targets[0].id)
        out[_module_of(root, path)] = names
    return out


def _port_aliases(tree: ast.AST, module: str,
                  classes: Dict[str, Set[str]]) -> Set[str]:
    """Names this module binds to a project PartitionSpec: its own, and
    any imported from a module that defines one."""
    out = set(classes.get(module, ()))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for mod, names in classes.items():
                if mod == node.module or mod.endswith("." + node.module):
                    out |= {a.asname or a.name for a in node.names
                            if a.name in names}
    return out


def _flatten_axes(value) -> Optional[List[Optional[str]]]:
    """Spec entries -> flat axis names (None entries kept as None);
    None result = some entry is not statically a str/None/tuple."""
    flat: List[Optional[str]] = []

    def rec(v) -> bool:
        if v is None or isinstance(v, str):
            flat.append(v)
            return True
        if isinstance(v, tuple):
            return all(rec(e) for e in v)
        return False

    return flat if rec(value) else None


def _spec_entries(env: AxisEnv, func, call: ast.Call
                  ) -> List[Tuple[ast.AST, Optional[List[Optional[str]]]]]:
    """Each P(...) argument with its statically-evaluated axis names."""
    out = []
    for arg in call.args:
        v = env.eval_in(func, arg)
        from kungfu_tpu_torch.analysis.axisenv import _EVAL_FAIL

        out.append((arg, None if v is _EVAL_FAIL else _flatten_axes(v)))
    return out


def _positional_params(node: ast.AST,
                       drop_self: bool) -> Tuple[int, Optional[int]]:
    """(required, max|None-for-varargs) positional arity."""
    a = node.args
    params = list(a.posonlyargs) + list(a.args)
    if drop_self and params and params[0].arg in ("self", "cls"):
        params = params[1:]
    required = len(params) - len(a.defaults)
    return required, (None if a.vararg is not None else len(params))


def _return_arity(node: ast.AST) -> Optional[int]:
    """Length of the function's returned tuple, when EVERY return is an
    explicit tuple literal of one consistent length; else None (a
    single-expression return may still be a tuple-valued variable)."""
    lens: Set[int] = set()
    stack: List[ast.AST] = list(node.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Return) and n.value is not None:
            if isinstance(n.value, ast.Tuple):
                lens.add(len(n.value.elts))
            else:
                return None
        stack.extend(ast.iter_child_nodes(n))
    return lens.pop() if len(lens) == 1 else None


def check(root: str) -> List[Violation]:
    env = axis_environment(root)
    out: List[Violation] = []
    supp_cache: Dict[str, Dict[int, set]] = {}

    def flag(path: str, line: int, msg: str) -> None:
        if path not in supp_cache:
            supp_cache[path] = parse_module(os.path.join(root, path)).supp
        if not suppressed(supp_cache[path], line, CHECKER):
            out.append(Violation(CHECKER, path, line, msg))

    vocab = env.vocabulary
    #: P-call nodes already checked precisely against a specific mesh
    precise: Set[int] = set()

    def check_spec(func, call: ast.Call,
                   mesh_axes: Optional[frozenset],
                   where: str) -> None:
        seen: Set[str] = set()
        for arg, axes in _spec_entries(env, func, call):
            if axes is None:
                continue
            for a in axes:
                if a is None:
                    continue  # unconstrained dim
                if a in seen:
                    flag(func.path, call.lineno,
                         f"PartitionSpec{where} names axis {a!r} twice — "
                         f"one mesh axis cannot shard two dimensions")
                seen.add(a)
                if mesh_axes is not None and a not in mesh_axes:
                    flag(func.path, call.lineno,
                         f"PartitionSpec{where} names axis {a!r}, but the "
                         f"mesh that reaches it declares only "
                         f"{{{', '.join(sorted(mesh_axes))}}}")
                elif mesh_axes is None and a not in vocab:
                    flag(func.path, call.lineno,
                         f"PartitionSpec{where} names axis {a!r}, which no "
                         f"Mesh/pmap in the tree declares (known axes: "
                         f"{sorted(vocab)})")

    # -- pass 1: shard_map sites — precise mesh + arity -------------------
    alias_cache: Dict[str, Set[str]] = {}

    classes = _spec_classes(root)

    def aliases_for(rel: str) -> Set[str]:
        if rel not in alias_cache:
            tree = parse_module(os.path.join(root, rel)).tree
            alias_cache[rel] = (
                _pspec_aliases(tree) | _port_aliases(
                    tree, _module_of(root, os.path.join(root, rel)), classes)
                if tree is not None else {"PartitionSpec"})
        return alias_cache[rel]

    for site in env.shard_sites:
        func = site.func
        if any(func.path.startswith(p) for p in _SKIP_PREFIXES):
            continue
        aliases = aliases_for(func.path)
        for spec_expr, which in ((site.in_specs, "in_specs"),
                                 (site.out_specs, "out_specs")):
            if spec_expr is None:
                continue
            for node in ast.walk(spec_expr):
                if isinstance(node, ast.Call) \
                        and terminal_name(node.func) in aliases:
                    precise.add(id(node))
                    check_spec(func, node, site.axes, f" in {which}")
        # arity: in_specs literal tuple vs mapped signature
        if isinstance(site.in_specs, ast.Tuple) and site.targets:
            n = len(site.in_specs.elts)
            bad = []
            for t in site.targets:
                # drop_self only fires when the first param is literally
                # named self/cls — a bound `shard_map(self._body, ...)`
                # must diff against the CALLED arity, not the def's
                req, mx = _positional_params(t.node, drop_self=True)
                if n < req or (mx is not None and n > mx):
                    bad.append((t, req, mx))
            if bad and len(bad) == len(site.targets):
                t, req, mx = bad[0]
                want = (f"{req}" if mx == req
                        else f"{req}..{mx if mx is not None else '*'}")
                flag(func.path, site.node.lineno,
                     f"shard_map in_specs has {n} entr"
                     f"{'y' if n == 1 else 'ies'} but mapped function "
                     f"`{t.name}` takes {want} positional parameter(s) — "
                     f"this raises at trace time")
        # arity: out_specs literal tuple vs explicit tuple returns
        if isinstance(site.out_specs, ast.Tuple) and site.targets:
            n = len(site.out_specs.elts)
            arities = {_return_arity(t.node) for t in site.targets}
            arities.discard(None)
            if arities and all(a != n for a in arities):
                flag(func.path, site.node.lineno,
                     f"shard_map out_specs has {n} entr"
                     f"{'y' if n == 1 else 'ies'} but the mapped function "
                     f"returns a {sorted(arities)[0]}-tuple — this raises "
                     f"at trace time")

    # -- pass 2: every other PartitionSpec in the tree --------------------
    funcs_by_path: Dict[str, list] = {}
    for f in env.graph.functions:
        funcs_by_path.setdefault(f.path, []).append(f)
    for path in iter_py_files(root):
        rel = relpath(root, path)
        if any(rel.startswith(p) for p in _SKIP_PREFIXES):
            continue
        mod = parse_module(path)
        if mod.tree is None:
            continue
        aliases = aliases_for(rel)
        # map each P call to its enclosing function (for local consts
        # and NamedSharding mesh resolution)
        funcs = funcs_by_path.get(rel, [])

        def enclosing(node: ast.AST):
            best = None
            for f in funcs:
                fn = f.node
                if fn.lineno <= node.lineno <= max(
                        getattr(fn, "end_lineno", fn.lineno), fn.lineno):
                    if best is None or fn.lineno > best.node.lineno:
                        best = f
            return best

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if terminal_name(node.func) == "NamedSharding" and node.args:
                func = enclosing(node)
                if func is None:
                    continue
                mesh_axes = env.mesh_axes(func, node.args[0])
                if mesh_axes is None or len(node.args) < 2:
                    continue
                for sub in ast.walk(node.args[1]):
                    if isinstance(sub, ast.Call) \
                            and terminal_name(sub.func) in aliases \
                            and id(sub) not in precise:
                        precise.add(id(sub))
                        check_spec(func, sub, mesh_axes,
                                   " in NamedSharding")
            elif terminal_name(node.func) in aliases \
                    and id(node) not in precise:
                func = enclosing(node)
                if func is None:
                    # module-level spec: module consts still resolve
                    from kungfu_tpu_torch.analysis.callgraph import FuncInfo

                    func = FuncInfo(module=_module_of(root, path), cls=None,
                                    name="<module>", path=rel, node=node,
                                    lineno=node.lineno)
                precise.add(id(node))
                check_spec(func, node, None, "")

    return sorted(out, key=lambda v: (v.path, v.line, v.message))
