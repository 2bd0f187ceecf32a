"""collective-consistency checker: SPMD protocol divergence at lint time.

Port of ``kungfu_tpu/analysis/collectives.py``: the same rule over the
port's tree.

Every peer must issue the same host-plane collectives under the same
rendezvous names in the same order — the adaptation paths (resize,
set_tree, shrink) are exactly where one rank's extra/missing collective
turns into a cluster-wide hang that no single-process unit test can see
(MLPerf-scale TPU work reports collective mismatch as the dominant
at-scale failure mode; arXiv:1909.09756, arXiv:2011.03641).  Built on
the shared :mod:`kungfu_tpu_torch.analysis.callgraph`, three divergence shapes
are flagged:

* **rank-conditional collective** — a collective call lexically under an
  ``if`` whose test reads a rank (``peer.rank()``, ``me == 0``, ...),
  with no matching same-(op, name) call elsewhere in the function to
  balance the other side.  The symmetric split
  (``if rank == 0: broadcast(x) ... else: broadcast(None)``) has two
  matching sites and passes; the asymmetric one hangs every other rank.
  The same check runs **interprocedurally**: a helper that issues
  collectives and is *called* only under rank-conditional branches is
  flagged at its call sites.
* **rendezvous name reuse** — two distinct call sites issuing the same
  op under the same *constant* name.  Two concurrent paths that both hit
  ``barrier(peers, name="sync")`` alias each other's messages; names
  must be versioned or site-unique (the tree's idiom:
  ``f"...v{cluster_version}"``).
* **divergent name expression** — a rendezvous name built from
  local-only state (``time.time()``, ``random``, ``uuid``, ``getpid``,
  ``rank()``): peers compute different names and the collective never
  rendezvouses.  Names must derive from cluster-agreed state (version
  counters, consensus payload digests).

``kungfu_tpu_torch/comm/`` is out of scope — it *implements* the collectives,
so its internal rank branching is the protocol, not a violation.
Suppress a deliberate exception with
``# kflint: allow(collective-consistency)`` on the call line.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from kungfu_tpu_torch.analysis.callgraph import (
    CallSite,
    FuncInfo,
    project_graph,
)
from kungfu_tpu_torch.analysis.core import (
    Violation,
    parse_module,
    suppressed,
)

CHECKER = "collective-consistency"

#: host-plane collective primitives (every peer must call in lockstep)
COLLECTIVE_OPS = {
    "barrier", "world_barrier", "consensus_bytes",
    "gather_bytes", "broadcast_bytes", "allgather_bytes",
}

#: positional index of the rendezvous-name argument per op (call-site
#: args, receiver excluded); kwarg ``name=`` always wins
_NAME_POS = {
    "gather_bytes": 2, "broadcast_bytes": 2, "allgather_bytes": 2,
    "consensus_bytes": 2, "barrier": 1, "world_barrier": 0,
}

#: modules whose paths start with these prefixes implement the ops
_IMPL_PREFIXES = ("kungfu_tpu_torch/comm/", "kungfu_tpu_torch/analysis/")

#: call terminals inside a name expression that diverge across peers
_DIVERGENT_CALLS = {
    "time", "monotonic", "perf_counter", "time_ns", "random", "randint",
    "randrange", "uniform", "urandom", "uuid1", "uuid4", "getpid",
    "gethostname", "id", "rank", "local_rank",
}

#: identifiers in an ``if`` test that read a rank
_RANK_CALLS = {"rank", "local_rank", "chaos_rank"}
_RANK_NAMES = {"me", "my_rank", "self_rank"}


def _is_rank_test(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if name in _RANK_CALLS or (name or "").startswith("_rank"):
                return True
        elif isinstance(n, ast.Name):
            if n.id in _RANK_NAMES or "rank" in n.id.lower():
                return True
        elif isinstance(n, ast.Attribute):
            if "rank" in n.attr.lower():
                return True
    return False


def _name_expr(site: CallSite) -> Optional[ast.AST]:
    for kw in site.node.keywords:
        if kw.arg == "name":
            return kw.value
    pos = _NAME_POS.get(site.callee)
    if pos is not None and len(site.node.args) > pos:
        return site.node.args[pos]
    # peer-level consensus_bytes(data, name) has the name one slot early
    if site.callee == "consensus_bytes" and len(site.node.args) == 2:
        return site.node.args[1]
    return None


def _name_key(expr: Optional[ast.AST]) -> str:
    return ast.dump(expr) if expr is not None else ""


def _const_name(expr: Optional[ast.AST]) -> Optional[str]:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    return None


def _collective_sites(func: FuncInfo) -> List[CallSite]:
    return [s for s in func.calls if s.callee in COLLECTIVE_OPS]


def _rank_conditional(site: CallSite) -> Optional[int]:
    """Line of the innermost rank-dependent enclosing branch, else None."""
    for b in reversed(site.branches):
        if _is_rank_test(b.test):
            return b.line
    return None


def _in_scope(func: FuncInfo) -> bool:
    return not any(func.path.startswith(p) for p in _IMPL_PREFIXES)


def check(root: str) -> List[Violation]:
    graph = project_graph(root)
    out: List[Violation] = []
    supp_cache: Dict[str, Dict[int, set]] = {}

    def supp_for(path: str) -> Dict[int, set]:
        if path not in supp_cache:
            import os

            supp_cache[path] = parse_module(os.path.join(root, path)).supp
        return supp_cache[path]

    def flag(path: str, line: int, msg: str) -> None:
        if not suppressed(supp_for(path), line, CHECKER):
            out.append(Violation(CHECKER, path, line, msg))

    # -- rank-conditional collectives (intra-function) --------------------
    for func in graph.functions:
        if not _in_scope(func):
            continue
        sites = _collective_sites(func)
        if not sites:
            continue
        # multiset of (op, name) occurrences in this function: a pair of
        # matching sites across the two sides of a rank split is the
        # symmetric root/leaf idiom and passes
        counts: Dict[Tuple[str, str], int] = {}
        for s in sites:
            key = (s.callee, _name_key(_name_expr(s)))
            counts[key] = counts.get(key, 0) + 1
        for s in sites:
            cond_line = _rank_conditional(s)
            if cond_line is None:
                continue
            if counts[(s.callee, _name_key(_name_expr(s)))] >= 2:
                continue
            flag(func.path, s.line,
                 f"collective `{s.callee}` issued only under the "
                 f"rank-conditional branch at line {cond_line} — peers on "
                 f"the other side never rendezvous (SPMD divergence hang)")

    # -- rank-conditional collectives (interprocedural) -------------------
    # a helper that issues collectives, reached ONLY through
    # rank-conditional call sites, diverges exactly like the inline form
    for func in graph.functions:
        if not _in_scope(func) or not _collective_sites(func):
            continue
        callers = graph.callers_of(func)
        if not callers:
            continue
        cond = [(f, s, _rank_conditional(s)) for f, s in callers]
        if any(line is None for _, _, line in cond):
            continue  # at least one unconditional path balances it
        # a caller with >= 2 call sites to this helper is the symmetric
        # root/leaf split (every branch of the rank test calls it) —
        # same balancing logic as the intra-function rule
        per_caller: Dict[str, int] = {}
        for caller, _, _ in cond:
            per_caller[caller.qualname] = per_caller.get(
                caller.qualname, 0) + 1
        for caller, site, line in cond:
            if not _in_scope(caller):
                continue
            if per_caller[caller.qualname] >= 2:
                continue
            flag(caller.path, site.line,
                 f"`{func.name}` issues collectives but is called only "
                 f"under rank-conditional branches (this one at line "
                 f"{line}) — non-matching ranks never issue them")

    # -- constant-name reuse across sites ---------------------------------
    # same-FUNCTION repeats are the symmetric root/leaf split (the
    # rank-conditional rule's balanced pair) and are exempt; reuse is
    # flagged across functions, where the paths really are concurrent
    seen: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for func in graph.functions:
        if not _in_scope(func):
            continue
        for s in _collective_sites(func):
            cname = _const_name(_name_expr(s))
            if cname is None:
                continue
            key = (s.callee, cname)
            prev = seen.get(key)
            if prev is None:
                seen[key] = (func.path, s.line, func.qualname)
            elif prev[2] != func.qualname:
                flag(func.path, s.line,
                     f"rendezvous name {cname!r} for `{s.callee}` is "
                     f"reused from {prev[0]}:{prev[1]} — concurrent paths "
                     f"would alias each other's messages; version the "
                     f"name or make it site-unique")

    # -- divergent name expressions ---------------------------------------
    for func in graph.functions:
        if not _in_scope(func):
            continue
        for s in _collective_sites(func):
            expr = _name_expr(s)
            if expr is None or isinstance(expr, ast.Constant):
                continue
            for n in ast.walk(expr):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                t = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None
                )
                if t in _DIVERGENT_CALLS:
                    flag(func.path, s.line,
                         f"rendezvous name for `{s.callee}` is built from "
                         f"`{t}()` — a local-only value that diverges "
                         f"across peers, so the collective never "
                         f"rendezvouses; derive names from cluster-agreed "
                         f"state (version counters, payload digests)")
                    break

    return sorted(out, key=lambda v: (v.path, v.line))
