"""env-contract checker: the ``KF_*`` env-var registry cannot drift.

Port of ``kungfu_tpu/analysis/envcheck.py``: the same rule over the
port's tree.

Direction 1 (unregistered read): every ``KF_[A-Z0-9_]+`` token (and
every ``MEGASCALE_[A-Z0-9_]+`` token — the multislice contract the
platform adapter and slice topology read) that appears in Python in
scan scope (``kungfu_tpu_torch/``, ``chip_smoke.py``, the port's timing
scripts) or in ``native/*.cpp`` must appear in
:mod:`kungfu_tpu_torch.utils.envs` (docstring table or constant).
Direction 2 (dead registry entry): every ``KF_*``
token in the registry must have at least one reader — either the literal
elsewhere in the tree, or a reference to the envs.py constant bound to
it (``envs.SELF_SPEC`` style), including inside envs.py's own parsing
code.  Compile-time-only tokens (C macros such as ``KF_SIMD_CLONES``)
are registered in the docstring like everything else, with a note.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Set, Tuple

from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_cpp_files,
    iter_py_files,
    parse_module,
    read_lines,
    relpath,
    suppressed,
    suppressions,
)

CHECKER = "env-contract"
_TOKEN_RE = re.compile(r"\b(?:KF|MEGASCALE)_[A-Z0-9_]+\b")

REGISTRY_PATH = os.path.join("kungfu_tpu_torch", "utils", "envs.py")


def _registry_tokens(root: str) -> Dict[str, int]:
    """``{token: first line}`` for every token in envs.py."""
    out: Dict[str, int] = {}
    for i, line in enumerate(read_lines(os.path.join(root, REGISTRY_PATH)), 1):
        for tok in _TOKEN_RE.findall(line):
            out.setdefault(tok, i)
    return out


def _registry_constants(root: str) -> Dict[str, str]:
    """``{constant_name: token}`` for ``NAME = "KF_..."`` bindings."""
    tree = parse_module(os.path.join(root, REGISTRY_PATH)).tree
    out: Dict[str, str] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
            and node.value.value.startswith(("KF_", "MEGASCALE_"))
        ):
            out[node.targets[0].id] = node.value.value
    return out


def _tree_reads(root: str) -> Dict[str, List[Tuple[str, int]]]:
    """``{token: [(relpath, line), ...]}`` outside the registry,
    honoring per-line ``allow(env-contract)`` suppressions."""
    reads: Dict[str, List[Tuple[str, int]]] = {}
    files = list(iter_py_files(root)) + list(iter_cpp_files(root))
    reg_abs = os.path.join(root, REGISTRY_PATH)
    for path in files:
        if os.path.abspath(path) == os.path.abspath(reg_abs):
            continue
        # the linter's own sources *discuss* tokens, they don't read them
        if (f"kungfu_tpu_torch{os.sep}analysis{os.sep}"
                in os.path.abspath(path)):
            continue
        lines = read_lines(path)
        supp = suppressions(lines)
        for i, line in enumerate(lines, 1):
            for tok in _TOKEN_RE.findall(line):
                if suppressed(supp, i, CHECKER):
                    continue
                reads.setdefault(tok, []).append((relpath(root, path), i))
    return reads


def _constant_readers(root: str, constants: Dict[str, str]) -> Set[str]:
    """KF tokens whose envs.py constant is referenced as a *load* —
    in envs.py's own code or in any module importing the registry."""
    used: Set[str] = set()
    # loads inside envs.py itself (parse_config_from_env etc.)
    reg_tree = parse_module(os.path.join(root, REGISTRY_PATH)).tree
    for node in ast.walk(reg_tree) if reg_tree is not None else ():
        if (
            isinstance(node, ast.Name)
            and isinstance(node.ctx, ast.Load)
            and node.id in constants
        ):
            used.add(constants[node.id])
    # references from modules that import the registry
    name_re = re.compile(
        r"\b(" + "|".join(re.escape(n) for n in constants) + r")\b"
    ) if constants else None
    for path in iter_py_files(root):
        if os.path.abspath(path) == os.path.abspath(
            os.path.join(root, REGISTRY_PATH)
        ):
            continue
        src = parse_module(path).source
        if "utils.envs" not in src and "utils import envs" not in src:
            continue
        if name_re is not None:
            for m in name_re.finditer(src):
                used.add(constants[m.group(1)])
    return used


def check(root: str) -> List[Violation]:
    registry = _registry_tokens(root)
    reads = _tree_reads(root)
    constants = _registry_constants(root)
    out: List[Violation] = []

    for tok in sorted(reads):
        if tok not in registry:
            path, line = reads[tok][0]
            out.append(Violation(
                CHECKER, path, line,
                f"{tok} is read here but not registered in "
                f"kungfu_tpu_torch/utils/envs.py ({len(reads[tok])} read "
                f"site(s))",
            ))

    reg_lines = read_lines(os.path.join(root, REGISTRY_PATH))
    reg_supp = suppressions(reg_lines)
    const_readers = _constant_readers(root, constants)
    for tok, line in sorted(registry.items()):
        if tok in reads or tok in const_readers:
            continue
        if suppressed(reg_supp, line, CHECKER):
            continue
        out.append(Violation(
            CHECKER, relpath(root, os.path.join(root, REGISTRY_PATH)), line,
            f"{tok} is registered but nothing in the tree reads it",
        ))
    return out
