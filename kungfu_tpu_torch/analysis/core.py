"""Shared plumbing for the kf-lint checkers (port of
``kungfu_tpu/analysis/core.py``; the tree scanned is the port's).

A checker is a callable ``check(root) -> list[Violation]``.  Suppression
is per-line: a trailing ``# kflint: allow(<rule>)`` (Python) or
``// kflint: allow(<rule>)`` (C++) comment on the flagged line silences
that rule there — and ONLY there, so every waiver is visible in the diff
that introduces it.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: directories under the repo root that the tree-wide checkers scan
PY_SCAN_DIRS = ("kungfu_tpu_torch",)

#: single files in scan scope: the card's smoke run and the port's
#: timing scripts drive the package like any module and must obey the
#: same invariants
PY_SCAN_FILES = (
    "chip_smoke.py",
    "scripts/flash_timing.py",
    "scripts/lm_head_timing.py",
    "scripts/ring_timing.py",
    "scripts/host_engine_timing.py",
    "scripts/serve_threads_timing.py",
)

_SUPPRESS_RE = re.compile(r"(?:#|//)\s*kflint:\s*allow\(([a-z0-9_,\s-]+)\)")


@dataclass(frozen=True)
class Violation:
    checker: str
    path: str  # repo-root relative
    line: int  # 1-based
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


def repo_root(start: str = None) -> str:
    """The tree to lint: the directory holding the ``kungfu_tpu_torch``
    package (walks up from ``start`` / this file)."""
    d = os.path.abspath(start or os.path.dirname(__file__))
    while True:
        if os.path.isdir(os.path.join(d, "kungfu_tpu_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise RuntimeError(
                "cannot locate repo root (no kungfu_tpu_torch/)")
        d = parent


def iter_py_files(root: str, dirs: Iterable[str] = PY_SCAN_DIRS,
                  files: Optional[Iterable[str]] = None) -> Iterable[str]:
    if files is None:
        # top-level scan files ride the DEFAULT full-tree scan only — a
        # caller narrowing `dirs` (blocking-io scans just the package)
        # must not silently regain them
        files = PY_SCAN_FILES if dirs is PY_SCAN_DIRS else ()
    for base in dirs:
        top = os.path.join(root, base)
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)
    for fn in files:
        path = os.path.join(root, fn)
        if os.path.isfile(path):
            yield path


def iter_cpp_files(root: str) -> Iterable[str]:
    native = os.path.join(root, "kungfu_tpu_torch", "native")
    if not os.path.isdir(native):
        return
    for fn in sorted(os.listdir(native)):
        if fn.endswith((".cpp", ".cc", ".h", ".hpp")):
            yield os.path.join(native, fn)


@dataclass
class ParsedModule:
    """One source file, parsed once per run and shared by every rule.

    ``tree`` is None for non-Python sources and for files whose parse
    failed (``error`` then carries the SyntaxError).  ``supp`` is the
    per-line ``kflint: allow(...)`` map, computed once alongside.
    """

    path: str
    source: str
    lines: List[str]
    tree: Optional[ast.AST]
    error: Optional[SyntaxError]
    supp: Dict[int, Set[str]] = field(default_factory=dict)


#: abspath -> (stat key, ParsedModule).  The stat key (mtime_ns, size)
#: invalidates rewrites naturally — and ONE entry per path means a
#: rewritten file replaces its stale parse instead of accumulating
#: historical versions for the process lifetime.
_MODULE_CACHE: Dict[str, Tuple[Tuple[int, int], ParsedModule]] = {}

#: abspath -> number of real ast.parse() calls this process made for it;
#: the single-parse test asserts this stays at 1 per file per run
PARSE_COUNTS: Dict[str, int] = {}


def clear_parse_cache() -> None:
    """Tests that count parses (or rewrite files in place) call this.
    Cascades through the derived caches (call graph, axis environment)
    — they are built FROM these parses and would serve stale analysis
    otherwise."""
    _MODULE_CACHE.clear()
    PARSE_COUNTS.clear()
    from kungfu_tpu_torch.analysis import callgraph

    callgraph.invalidate_cache()


def parse_module(path: str) -> ParsedModule:
    """The cached (source, lines, AST, suppressions) view of ``path``.

    Every checker goes through here instead of open()+ast.parse() so a
    full kflint pass parses each file exactly once (the suite re-parsed
    per checker before; at thirteen rules that was the dominant cost).
    """
    abspath = os.path.abspath(path)
    st = os.stat(abspath)
    key = (st.st_mtime_ns, st.st_size)
    hit = _MODULE_CACHE.get(abspath)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(abspath, "r", encoding="utf-8", errors="replace") as f:
        source = f.read()
    lines = source.splitlines()
    tree = error = None
    if abspath.endswith(".py"):
        PARSE_COUNTS[abspath] = PARSE_COUNTS.get(abspath, 0) + 1
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            error = e
    mod = ParsedModule(
        path=abspath, source=source, lines=lines, tree=tree, error=error,
        supp=suppressions(lines),
    )
    _MODULE_CACHE[abspath] = (key, mod)
    return mod


def read_lines(path: str) -> List[str]:
    return parse_module(path).lines


def suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    """``{1-based line: {rule, ...}}`` for every kflint allow comment."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, 1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def suppressed(supp: Dict[int, Set[str]], line: int, rule: str) -> bool:
    rules = supp.get(line)
    return bool(rules) and (rule in rules or "all" in rules)


def relpath(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def terminal_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of a Name/Attribute chain:
    ``torch.distributed.all_reduce`` -> "all_reduce", ``send`` ->
    "send", else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None
