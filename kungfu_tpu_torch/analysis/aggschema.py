"""agg-schema checker: aggregator snapshot/view fields come from the schema.

Port of ``kungfu_tpu/analysis/aggschema.py``: the same rule over the
port's tree.

The live cluster plane (:mod:`kungfu_tpu_torch.monitor.aggregator`) moves
plain JSON dicts between ranks, the aggregator, and ``kftop``.  A typo'd
field name at any hop would not error — the value would simply vanish
from every ``kftop`` column and ``/cluster`` consumer, the same silent
failure mode the ``trace-vocab`` rule exists to kill for event kinds.
So: every read goes through ``aggregator.field(obj, "<name>")`` and
every producer through ``aggregator.make_snapshot(<name>=...)``, and
this rule requires the names at those call sites to be **string literals
/ literal keywords** that appear in the ``SNAPSHOT_FIELDS`` /
``VIEW_FIELDS`` declarations (parsed straight from aggregator.py, so
the schema cannot drift from the enforcement).

Recognized call shapes (per-file import tracking, same conservatism as
``trace-vocab``):

* ``from kungfu_tpu_torch.monitor import aggregator [as A]`` →
  ``A.field(...)`` / ``A.make_snapshot(...)``
* ``from kungfu_tpu_torch.monitor.aggregator import field [as f],
  make_snapshot [as ms]`` → ``f(...)`` / ``ms(...)``
* ``import kungfu_tpu_torch.monitor.aggregator`` → full-path attribute calls

Unrelated ``.field()``/``.make_snapshot()`` methods on other objects are
not flagged (their receiver does not resolve to the aggregator module).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_py_files,
    parse_module,
    relpath,
    suppressed,
)

CHECKER = "agg-schema"

AGG_PATH = os.path.join("kungfu_tpu_torch", "monitor", "aggregator.py")
AGG_MODULE = "kungfu_tpu_torch.monitor.aggregator"
_FUNCS = ("field", "make_snapshot")
_SCHEMA_NAMES = ("SNAPSHOT_FIELDS", "VIEW_FIELDS")


def _schemas(root: str) -> Dict[str, Set[str]]:
    """``{declaration name: fields}`` parsed from aggregator.py.
    Kept separate: ``field()`` reads snapshots AND views (union), but
    ``make_snapshot()`` accepts SNAPSHOT_FIELDS only at runtime — a
    union check there would lint-pass a call that raises."""
    path = os.path.join(root, AGG_PATH)
    if not os.path.isfile(path):
        return {}
    tree = parse_module(path).tree
    out: Dict[str, Set[str]] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in _SCHEMA_NAMES
        ):
            fields: Set[str] = set()
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    fields.add(sub.value)
            out[node.targets[0].id] = fields
    return out


def _agg_aliases(tree: ast.Module) -> tuple:
    """``(module_aliases, func_aliases)``: names bound to the aggregator
    module, and names bound directly to field/make_snapshot."""
    mod_aliases: Set[str] = set()
    func_aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "kungfu_tpu_torch.monitor":
                for a in node.names:
                    if a.name == "aggregator":
                        mod_aliases.add(a.asname or a.name)
            elif node.module == AGG_MODULE:
                for a in node.names:
                    if a.name in _FUNCS:
                        func_aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == AGG_MODULE and a.asname:
                    mod_aliases.add(a.asname)
    return mod_aliases, func_aliases


def _full_path(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _agg_call(node: ast.Call, mod_aliases: Set[str],
              func_aliases: Dict[str, str]) -> Optional[str]:
    """"field"/"make_snapshot" when the call resolves to the module."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in func_aliases:
        return func_aliases[f.id]
    if isinstance(f, ast.Attribute) and f.attr in _FUNCS:
        if isinstance(f.value, ast.Name) and f.value.id in mod_aliases:
            return f.attr
        if _full_path(f.value) == AGG_MODULE:
            return f.attr
    return None


def _check_field(node: ast.Call, schema: Set[str], rel: str,
                 out: List[Violation]) -> None:
    name_arg = None
    if len(node.args) >= 2:
        name_arg = node.args[1]
    else:
        for kw in node.keywords:
            if kw.arg == "name":
                name_arg = kw.value
    if name_arg is None:
        out.append(Violation(
            CHECKER, rel, node.lineno,
            "aggregator.field() called without a field name",
        ))
        return
    if not (isinstance(name_arg, ast.Constant)
            and isinstance(name_arg.value, str)):
        out.append(Violation(
            CHECKER, rel, node.lineno,
            "aggregator.field() name must be a string literal from the "
            "declared schema (a dynamic field cannot be checked and a "
            "typo would silently empty a kftop column)",
        ))
    elif name_arg.value not in schema:
        out.append(Violation(
            CHECKER, rel, node.lineno,
            f"aggregator.field() name {name_arg.value!r} is not in "
            f"SNAPSHOT_FIELDS/VIEW_FIELDS "
            f"(kungfu_tpu_torch/monitor/aggregator.py) — add it there first "
            f"or fix the typo",
        ))


def _check_make_snapshot(node: ast.Call, schema: Set[str], rel: str,
                         out: List[Violation]) -> None:
    for kw in node.keywords:
        if kw.arg is None:
            out.append(Violation(
                CHECKER, rel, node.lineno,
                "make_snapshot(**dynamic) cannot be schema-checked — "
                "pass literal keyword fields",
            ))
        elif kw.arg not in schema:
            out.append(Violation(
                CHECKER, rel, node.lineno,
                f"make_snapshot() field {kw.arg!r} is not in "
                f"SNAPSHOT_FIELDS "
                f"(kungfu_tpu_torch/monitor/aggregator.py) — "
                f"add it there first or fix the typo",
            ))


def check(root: str) -> List[Violation]:
    schemas = _schemas(root)
    schema = set().union(*schemas.values()) if schemas else set()
    snap_schema = schemas.get("SNAPSHOT_FIELDS", schema)
    if not schema:
        return []  # no aggregator module in this tree — nothing to enforce
    out: List[Violation] = []
    for path in iter_py_files(root):
        # the schema owner builds/reads snapshots structurally
        if os.path.abspath(path) == os.path.abspath(
                os.path.join(root, AGG_PATH)):
            continue
        mod = parse_module(path)
        if mod.tree is None or "aggregator" not in mod.source:
            continue
        tree = mod.tree
        mod_aliases, func_aliases = _agg_aliases(tree)
        if not mod_aliases and not func_aliases:
            continue
        supp = mod.supp
        rel = relpath(root, path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = _agg_call(node, mod_aliases, func_aliases)
            if fn is None or suppressed(supp, node.lineno, CHECKER):
                continue
            if fn == "field":
                _check_field(node, schema, rel, out)
            else:
                _check_make_snapshot(node, snap_schema, rel, out)
    return sorted(out, key=lambda v: (v.path, v.line))
