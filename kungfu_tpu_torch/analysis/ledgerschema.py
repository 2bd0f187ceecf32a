"""ledger-schema checker: decision-ledger fields come from the schema.

Port of ``kungfu_tpu/analysis/ledgerschema.py``: the same rule over the
port's tree.

The decision ledger (:mod:`kungfu_tpu_torch.monitor.ledger`) is the durable
record joining every adaptive actor's knob move to its measured effect;
``kfhist --decisions`` replays those records byte-identically offline.
A typo'd field name would not error — the decision would simply replay
without its evidence (or the offline join would silently miss), the
exact failure mode ``agg-schema`` kills for the live snapshot plane.
So: every producer goes through ``ledger.ledger_record(<name>=...)`` /
``ledger.record_decision(actor, knob, old, new, <name>=...)`` and every
reader through ``ledger.lfield(obj, "<name>")``, and this rule requires
the names at those call sites to be **string literals / literal
keywords** that appear in the ``LEDGER_FIELDS`` declaration (parsed
straight from ledger.py, so the schema cannot drift from the
enforcement).

Recognized call shapes (per-file import tracking, same conservatism as
``agg-schema``/``trace-vocab``):

* ``from kungfu_tpu_torch.monitor import ledger [as L]`` →
  ``L.ledger_record(...)`` / ``L.lfield(...)`` /
  ``L.record_decision(...)``
* ``from kungfu_tpu_torch.monitor.ledger import ledger_record [as r],
  lfield [as f], record_decision [as d]`` → direct calls
* ``import kungfu_tpu_torch.monitor.ledger`` → full-path attribute calls

Unrelated methods of the same names on other objects are not flagged
(their receiver does not resolve to the ledger module).
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

CHECKER = "ledger-schema"

LEDGER_PATH = os.path.join("kungfu_tpu_torch", "monitor", "ledger.py")
LEDGER_MODULE = "kungfu_tpu_torch.monitor.ledger"
_FUNCS = ("ledger_record", "lfield", "record_decision")
_SCHEMA_NAME = "LEDGER_FIELDS"
#: record_decision's positional/named parameters — keywords that bind
#: them are checked as fields too (they ARE fields), but a caller may
#: also pass them positionally
_DECISION_PARAMS = ("actor", "knob", "old", "new")


def _schema(root: str) -> Set[str]:
    """``LEDGER_FIELDS`` parsed from ledger.py (string constants inside
    the declaration — the same structural read agg-schema does)."""
    path = os.path.join(root, LEDGER_PATH)
    if not os.path.isfile(path):
        return set()
    tree = parse_module(path).tree
    if tree is None:
        return set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == _SCHEMA_NAME
        ):
            return {
                sub.value
                for sub in ast.walk(node.value)
                if isinstance(sub, ast.Constant)
                and isinstance(sub.value, str)
            }
    return set()


def _ledger_aliases(tree: ast.Module) -> tuple:
    """``(module_aliases, func_aliases)``: names bound to the ledger
    module, and names bound directly to the checked functions."""
    mod_aliases: Set[str] = set()
    func_aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "kungfu_tpu_torch.monitor":
                for a in node.names:
                    if a.name == "ledger":
                        mod_aliases.add(a.asname or a.name)
            elif node.module == LEDGER_MODULE:
                for a in node.names:
                    if a.name in _FUNCS:
                        func_aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == LEDGER_MODULE and a.asname:
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


def _ledger_call(node: ast.Call, mod_aliases: Set[str],
                 func_aliases: Dict[str, str]) -> Optional[str]:
    """The checked function's name when the call resolves to the
    ledger module, else None."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in func_aliases:
        return func_aliases[f.id]
    if isinstance(f, ast.Attribute) and f.attr in _FUNCS:
        if isinstance(f.value, ast.Name) and f.value.id in mod_aliases:
            return f.attr
        if _full_path(f.value) == LEDGER_MODULE:
            return f.attr
    return None


def _check_lfield(node: ast.Call, schema: Set[str], rel: str,
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
            "ledger.lfield() called without a field name",
        ))
        return
    if not (isinstance(name_arg, ast.Constant)
            and isinstance(name_arg.value, str)):
        out.append(Violation(
            CHECKER, rel, node.lineno,
            "ledger.lfield() name must be a string literal from "
            "LEDGER_FIELDS (a dynamic field cannot be checked and a "
            "typo would silently drop the decision's evidence)",
        ))
    elif name_arg.value not in schema:
        out.append(Violation(
            CHECKER, rel, node.lineno,
            f"ledger.lfield() name {name_arg.value!r} is not in "
            f"LEDGER_FIELDS (kungfu_tpu_torch/monitor/ledger.py) — add it "
            f"there first or fix the typo",
        ))


def _check_record(node: ast.Call, fn: str, schema: Set[str], rel: str,
                  out: List[Violation]) -> None:
    for kw in node.keywords:
        if kw.arg is None:
            out.append(Violation(
                CHECKER, rel, node.lineno,
                f"{fn}(**dynamic) cannot be schema-checked — pass "
                f"literal keyword fields",
            ))
        elif kw.arg not in schema:
            out.append(Violation(
                CHECKER, rel, node.lineno,
                f"{fn}() field {kw.arg!r} is not in LEDGER_FIELDS "
                f"(kungfu_tpu_torch/monitor/ledger.py) — add it there first "
                f"or fix the typo",
            ))


def check(root: str) -> List[Violation]:
    schema = _schema(root)
    if not schema:
        return []  # no ledger module in this tree — nothing to enforce
    out: List[Violation] = []
    for path in iter_py_files(root):
        # the schema owner builds/validates records structurally
        if os.path.abspath(path) == os.path.abspath(
                os.path.join(root, LEDGER_PATH)):
            continue
        mod = parse_module(path)
        if mod.tree is None or "ledger" not in mod.source:
            continue
        tree = mod.tree
        mod_aliases, func_aliases = _ledger_aliases(tree)
        if not mod_aliases and not func_aliases:
            continue
        supp = mod.supp
        rel = relpath(root, path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = _ledger_call(node, mod_aliases, func_aliases)
            if fn is None or suppressed(supp, node.lineno, CHECKER):
                continue
            if fn == "lfield":
                _check_lfield(node, schema, rel, out)
            else:
                _check_record(node, fn, schema, rel, out)
    return sorted(out, key=lambda v: (v.path, v.line))
