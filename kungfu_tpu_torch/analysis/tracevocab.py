"""trace-vocab checker: timeline event kinds come from the vocabulary.

Port of ``kungfu_tpu/analysis/tracevocab.py``: the same rule over the
port's tree.

The flight recorder (:mod:`kungfu_tpu_torch.monitor.timeline`) filters, counts,
and renders events by their ``kind`` string; ``kftrace`` groups its
straggler analysis by the same strings.  A typo'd kind at one call site
would not error — the event would simply vanish from every filter and
counter, which is precisely the failure mode an observability layer must
not have.  So: every ``span()``/``event()`` call whose callee resolves to
the timeline module must pass a **string literal** kind that appears in
the ``EVENT_KINDS`` declaration (parsed straight from timeline.py, so
the vocabulary cannot drift from the enforcement).

Recognized call shapes (per-file import tracking, same conservatism as
the rest of the suite):

* ``from kungfu_tpu_torch.monitor import timeline [as T]`` → ``T.span(...)``
* ``from kungfu_tpu_torch.monitor.timeline import span [as s], event``
  → ``s(...)``
* ``import kungfu_tpu_torch.monitor.timeline`` → full-path attribute calls

Unrelated ``.span()``/``.event()`` methods on other objects are not
flagged (their receiver does not resolve to the timeline module).
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

CHECKER = "trace-vocab"

TIMELINE_PATH = os.path.join("kungfu_tpu_torch", "monitor", "timeline.py")
TIMELINE_MODULE = "kungfu_tpu_torch.monitor.timeline"
_FUNCS = ("span", "event")


def _vocabulary(root: str) -> Set[str]:
    """The EVENT_KINDS declaration parsed from timeline.py."""
    path = os.path.join(root, TIMELINE_PATH)
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
            and node.targets[0].id == "EVENT_KINDS"
        ):
            out: Set[str] = set()
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    out.add(sub.value)
            return out
    return set()


def _timeline_aliases(tree: ast.Module) -> tuple:
    """``(module_aliases, func_aliases)`` for this file: names bound to
    the timeline module, and names bound directly to span/event."""
    mod_aliases: Set[str] = set()
    func_aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "kungfu_tpu_torch.monitor":
                for a in node.names:
                    if a.name == "timeline":
                        mod_aliases.add(a.asname or a.name)
            elif node.module == TIMELINE_MODULE:
                for a in node.names:
                    if a.name in _FUNCS:
                        func_aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == TIMELINE_MODULE and a.asname:
                    mod_aliases.add(a.asname)
    return mod_aliases, func_aliases


def _full_path(node: ast.AST) -> Optional[str]:
    """Dotted path of a Name/Attribute chain, or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _timeline_call(node: ast.Call, mod_aliases: Set[str],
                   func_aliases: Dict[str, str]) -> Optional[str]:
    """"span"/"event" when this call resolves to the timeline API."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in func_aliases:
        return func_aliases[f.id]
    if isinstance(f, ast.Attribute) and f.attr in _FUNCS:
        if isinstance(f.value, ast.Name) and f.value.id in mod_aliases:
            return f.attr
        if _full_path(f.value) == TIMELINE_MODULE:
            return f.attr
    return None


def check(root: str) -> List[Violation]:
    vocab = _vocabulary(root)
    if not vocab:
        return []  # no timeline module in this tree — nothing to enforce
    out: List[Violation] = []
    for path in iter_py_files(root):
        # the recorder's own internals reference kinds structurally
        if os.path.abspath(path) == os.path.abspath(
                os.path.join(root, TIMELINE_PATH)):
            continue
        mod = parse_module(path)
        if mod.tree is None or "timeline" not in mod.source:
            continue
        tree = mod.tree
        mod_aliases, func_aliases = _timeline_aliases(tree)
        if not mod_aliases and not func_aliases:
            continue
        supp = mod.supp
        rel = relpath(root, path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = _timeline_call(node, mod_aliases, func_aliases)
            if fn is None:
                continue
            if suppressed(supp, node.lineno, CHECKER):
                continue
            if not node.args:
                out.append(Violation(
                    CHECKER, rel, node.lineno,
                    f"timeline.{fn}() called without a kind argument",
                ))
                continue
            kind = node.args[0]
            if not (isinstance(kind, ast.Constant)
                    and isinstance(kind.value, str)):
                out.append(Violation(
                    CHECKER, rel, node.lineno,
                    f"timeline.{fn}() kind must be a string literal from "
                    f"the EVENT_KINDS vocabulary (a dynamic kind cannot be "
                    f"checked and a typo would silently vanish from every "
                    f"kftrace filter)",
                ))
            elif kind.value not in vocab:
                out.append(Violation(
                    CHECKER, rel, node.lineno,
                    f"timeline.{fn}() kind {kind.value!r} is not in the "
                    f"EVENT_KINDS vocabulary "
                    f"(kungfu_tpu_torch/monitor/timeline.py) — add it there "
                    f"first or fix the typo",
                ))
    return sorted(out, key=lambda v: (v.path, v.line))
