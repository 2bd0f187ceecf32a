"""lock-discipline checker for the native C++ transport.

Port of ``kungfu_tpu/analysis/lockcheck.py``: the same rule over the
port's tree.

Fields annotated ``// guarded_by(<mutex>)`` at their declaration may
only be *written* in a scope that holds that mutex via
``std::lock_guard`` / ``std::unique_lock``.  This is a structural
checker, not a compiler: it tracks brace depth line by line, records
lock acquisitions for the lifetime of their enclosing block, and flags
writes (assignment, compound assignment, increment/decrement,
``operator[]``, and mutating container calls) to annotated fields made
while the declared mutex is not among the held set.

Explicit ``lk.unlock()`` / ``lk.lock()`` windows on a ``unique_lock``
ARE tracked (line granularity): a write between an unlock and the
relock is flagged.

Known limits (by design — keep the checker simple and the code honest):

* writes through iterators/pointers into a container are invisible;
* an ``if { unlock(); }`` branch that falls through (rather than
  returning) is treated as re-locked after the brace;
* a scope whose safety comes from declaration *order* (RAII guard
  destructors running while another unique_lock is still alive), from
  single ownership (a buffer provably unreachable by other threads
  during an unlock window), or from being provably single-threaded
  (constructors, join points) carries an explicit
  ``// kflint: allow(lock-discipline)`` with a comment, so the
  invariant is documented exactly where it is subtle.

Mutex and field references are normalized to their terminal component:
``ch->q_mu_`` and ``q_mu_`` are the same lock, ``entry->fd_mu`` and
``e->fd_mu`` likewise — the transport never holds two instances' locks
of the same name simultaneously except PoolEntry handoffs, which take
only their own.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from kungfu_tpu_torch.analysis.core import (
    Violation,
    iter_cpp_files,
    read_lines,
    relpath,
    suppressed,
    suppressions,
)

CHECKER = "lock-discipline"

_ANNOT_RE = re.compile(r"//\s*guarded_by\((\w+)\)")
_DECL_RE = re.compile(r"\b([A-Za-z_]\w*)\s*(?:=[^=;]*|\{[^}]*\})?\s*;")
_LOCK_RE = re.compile(
    r"\b(?:std::)?(?:lock_guard|unique_lock)\s*<[^>]*>\s*(\w+)\s*[({]\s*"
    r"([\w.>:\-]+?)\s*[)}]"
)
_UNLOCK_RE = re.compile(r"\b(\w+)\s*\.\s*unlock\s*\(\s*\)")
_RELOCK_RE = re.compile(r"\b(\w+)\s*\.\s*lock\s*\(\s*\)")
_MUTATORS = (
    "push_back|pop_front|pop_back|clear|erase|emplace|emplace_back|"
    "insert|resize|swap|assign"
)


def _strip_comment(line: str) -> str:
    # good enough for this tree: no multi-line /* */ in statement position
    i = line.find("//")
    return line if i < 0 else line[:i]


def _terminal(expr: str) -> str:
    return re.split(r"->|\.", expr)[-1].strip()


def _field_annotations(lines: List[str]) -> Dict[str, Tuple[str, int]]:
    """``{field: (mutex, decl line)}`` from guarded_by comments."""
    out: Dict[str, Tuple[str, int]] = {}
    for i, line in enumerate(lines, 1):
        m = _ANNOT_RE.search(line)
        if not m:
            continue
        decl = _strip_comment(line)
        d = _DECL_RE.search(decl)
        if d:
            out[d.group(1)] = (m.group(1), i)
    return out


def _write_patterns(field: str) -> List[re.Pattern]:
    f = re.escape(field)
    return [
        re.compile(r"\b" + f + r"\s*=(?!=)"),           # assignment
        re.compile(r"\b" + f + r"\s*(\+=|-=|\|=|&=|\^=)"),
        re.compile(r"\b" + f + r"\s*(\+\+|--)"),
        re.compile(r"(\+\+|--)\s*(\w+\s*->\s*)?" + f + r"\b"),
        re.compile(r"\b" + f + r"\s*\["),               # map operator[]
        re.compile(r"\b" + f + r"\s*\.\s*(?:" + _MUTATORS + r")\b"),
    ]


def _scan_file(root: str, path: str) -> List[Violation]:
    lines = read_lines(path)
    annots = _field_annotations(lines)
    if not annots:
        return []
    supp = suppressions(lines)
    patterns = {f: _write_patterns(f) for f in annots}
    decl_lines = {line for _, line in annots.values()}
    out: List[Violation] = []

    depth = 0
    # (decl depth, mutex, guard var, active) — `lk.unlock()` deactivates
    # an entry, `lk.lock()` reactivates it, scope exit drops it
    held: List[List] = []
    for i, raw in enumerate(lines, 1):
        code = _strip_comment(raw)
        # locks declared on this line are active from here to the end of
        # the enclosing block (RAII); the declaration depth counts any
        # `{` earlier on the same line, so `{ lock_guard lk(mu); ... }`
        # one-liners expire at their own closing brace
        for m in _LOCK_RE.finditer(code):
            decl_depth = depth + code[:m.start()].count("{") \
                - code[:m.start()].count("}")
            held.append([decl_depth, _terminal(m.group(2)), m.group(1), True])
        # explicit unlock/relock windows on a unique_lock: applied before
        # the write checks, so `lk.unlock(); x_ = 1;` on one line flags
        # (the conservative direction for a gate).  The deactivation is
        # scoped to the block it happens in: when that block exits the
        # lock is considered re-held — an `unlock(); return;` branch is
        # gone on the fall-through path (an `if { unlock } fallthrough`
        # that does NOT return is the one shape this misses; see module
        # docstring limits)
        for m in _UNLOCK_RE.finditer(code):
            unlock_depth = depth + code[:m.start()].count("{") \
                - code[:m.start()].count("}")
            for entry in held:
                if entry[2] == m.group(1):
                    entry[3] = False
                    entry.append(unlock_depth)  # -> entry[4]
        for m in _RELOCK_RE.finditer(code):
            for entry in held:
                if entry[2] == m.group(1):
                    entry[3] = True
                    del entry[4:]
        if i not in decl_lines:
            held_set = {e[1] for e in held if e[3]}
            for field, (mutex, _) in annots.items():
                if suppressed(supp, i, CHECKER):
                    continue
                for pat in patterns[field]:
                    if pat.search(code):
                        if mutex not in held_set:
                            out.append(Violation(
                                CHECKER, relpath(root, path), i,
                                f"write to `{field}` (guarded_by {mutex}) "
                                f"without {mutex} held "
                                f"(held: {sorted(held_set) or 'none'})",
                            ))
                        break
        # update depth AFTER checking the line; a lock declared at depth
        # d dies when depth drops below d (its enclosing block closed)
        depth += code.count("{") - code.count("}")
        held = [e for e in held if depth >= e[0]]
        for e in held:
            if not e[3] and len(e) > 4 and depth < e[4]:
                e[3] = True  # the unlocking block exited
                del e[4:]
    return out


def check(root: str) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_cpp_files(root):
        out.extend(_scan_file(root, path))
    return out
