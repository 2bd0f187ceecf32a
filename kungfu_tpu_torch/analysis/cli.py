"""kflint entry point for the port: run the project checkers over
``kungfu_tpu_torch/``, print, exit nonzero.

Usage (``python -m kungfu_tpu_torch.analysis``, or ``scripts/kflint_torch``
where neither torch nor numpy is installed)::

    kflint                  # all checkers over the repo
    kflint --checker lock-order --checker env-contract
    kflint --proto          # just the kf-verify protocol verifier
    kflint --changed        # only report findings in files changed vs git
    kflint --root /path/to/tree
    kflint --list
    kflint --json                          # machine-readable findings
    kflint --baseline baseline.json
    kflint --write-baseline baseline.json
    kflint --timing                        # each checker's findings, seconds

``--changed`` keeps the *analysis* whole-tree (the interprocedural
rules — proto-verify, collective-consistency, lock-order — are
properties of paths through the tree, and the shared stat-keyed parse
cache in ``core.parse_module`` means every pass reuses one AST per
file) but *reports* only findings whose path changed relative to git
(worktree vs HEAD, plus untracked files).  With no relevant changes it
exits 0 without building the call graph at all.

A **baseline** is a JSON list of ``{"checker", "path", "message"}``
fingerprints (line numbers deliberately excluded — they drift with every
edit above a finding).  Findings matching a baseline entry are reported
as suppressed instead of failing the run, so a new rule can land
tree-wide on day one and ratchet the legacy findings down over time
instead of blocking on them.  ``--write-baseline`` snapshots the current
findings into that format.

Exit code 0 = clean (or fully baselined), 1 = violations, 2 =
usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from kungfu_tpu_torch.analysis import (
    aggschema,
    blockingio,
    collectives,
    detrules,
    envcheck,
    handlecheck,
    jitpurity,
    ledgerschema,
    lockcheck,
    protoverify,
    pylockorder,
    recompilehazard,
    retrydiscipline,
    shardaxis,
    shardspec,
    tracevocab,
    wirecontract,
)
from kungfu_tpu_torch.analysis.core import Violation, repo_root

CHECKERS: Dict[str, object] = {
    envcheck.CHECKER: envcheck.check,
    jitpurity.CHECKER: jitpurity.check,
    blockingio.CHECKER: blockingio.check,
    lockcheck.CHECKER: lockcheck.check,
    retrydiscipline.CHECKER: retrydiscipline.check,
    handlecheck.CHECKER: handlecheck.check,
    collectives.CHECKER: collectives.check,
    wirecontract.CHECKER: wirecontract.check,
    pylockorder.CHECKER: pylockorder.check,
    tracevocab.CHECKER: tracevocab.check,
    aggschema.CHECKER: aggschema.check,
    ledgerschema.CHECKER: ledgerschema.check,
    shardaxis.CHECKER: shardaxis.check,
    shardspec.CHECKER: shardspec.check,
    recompilehazard.CHECKER: recompilehazard.check,
    protoverify.CHECKER: protoverify.check,
    detrules.CHECKER_TAINT: detrules.check_replay_taint,
    detrules.CHECKER_RNG: detrules.check_rng_discipline,
    detrules.CHECKER_RED: detrules.check_reduction_order,
}

#: the kf-verify subset: the interprocedural rules built on the shared
#: call graph (the set also documents which rules a baseline most
#: plausibly covers while a tree is brought clean)
VERIFY_CHECKERS = (collectives.CHECKER, wirecontract.CHECKER,
                   pylockorder.CHECKER)

#: the kf-shard subset: the axis-environment rules
SHARD_CHECKERS = (shardaxis.CHECKER, shardspec.CHECKER,
                  recompilehazard.CHECKER)

#: the protocol verifier (``--proto``): gates with an EMPTY baseline —
#: a collective-ordering divergence, an orphan p2p tag, or a wait-for
#: cycle can never land as "legacy debt"
PROTO_CHECKERS = (protoverify.CHECKER,)

#: the kf-det subset: the replay-determinism rules over the taint
#: engine (a determinism finding never ratchets)
DET_CHECKERS = (detrules.CHECKER_TAINT, detrules.CHECKER_RNG,
                detrules.CHECKER_RED)

#: cross-language rule contracts: a change to EITHER side must surface
#: the findings the rule reports on the other side — ``--changed``
#: expands the filter set through these couples (a transport.cpp-only
#: diff still shows the wire-contract finding anchored on host.py)
COUPLED_PATHS: Tuple[Tuple[str, ...], ...] = (
    (wirecontract.HOST_PATH.replace("\\", "/"),
     wirecontract.CPP_PATH.replace("\\", "/")),
)


def expand_coupled(changed: Sequence[str]) -> set:
    """The changed-path filter set, closed over the cross-language
    couples."""
    out = set(changed)
    for couple in COUPLED_PATHS:
        if out & set(couple):
            out.update(couple)
    return out


def _git_changed_files(root: str) -> Optional[List[str]]:
    """Repo-relative paths changed vs HEAD (staged + worktree) plus
    untracked files; None when git is unavailable (fall back to a full
    report rather than silently reporting nothing)."""
    import subprocess

    try:
        diff = subprocess.run(
            ["git", "-C", root, "diff", "--name-only", "HEAD"],
            capture_output=True, text=True, timeout=30, check=True)
        untracked = subprocess.run(
            ["git", "-C", root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, timeout=30, check=True)
    except Exception:  # noqa: BLE001 - any git failure: no filter
        return None
    return sorted({p for p in (diff.stdout + untracked.stdout).split("\n")
                   if p.strip()})


def run_checkers(root: Optional[str] = None,
                 names: Optional[Sequence[str]] = None,
                 timings: Optional[Dict[str, Tuple[int, float]]] = None
                 ) -> List[Violation]:
    """All violations from the selected checkers (default: all).  With
    ``timings``, each checker's ``(findings, seconds)`` lands there (the
    first checker to run pays the shared parse)."""
    root = root or repo_root()
    out: List[Violation] = []
    for name in names or CHECKERS:
        t0 = time.perf_counter()
        found = CHECKERS[name](root)
        if timings is not None:
            timings[name] = (len(found), time.perf_counter() - t0)
        out.extend(found)
    return sorted(out, key=lambda v: (v.path, v.line, v.checker))


def _fingerprint(v: Violation) -> Tuple[str, str, str]:
    return (v.checker, v.path, v.message)


def load_baseline(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    if not isinstance(entries, list) or not all(
            isinstance(e, dict) and {"checker", "path", "message"} <= set(e)
            for e in entries):
        raise ValueError(
            f"{path}: baseline must be a JSON list of "
            f'{{"checker", "path", "message"}} entries')
    return entries


def apply_baseline(violations: List[Violation],
                   entries: List[dict]) -> Tuple[List[Violation], int]:
    """(unbaselined violations, suppressed count)."""
    allowed = {(e["checker"], e["path"], e["message"]) for e in entries}
    fresh = [v for v in violations if _fingerprint(v) not in allowed]
    return fresh, len(violations) - len(fresh)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kflint", description="kungfu-tpu project-invariant linter "
        "(the PyTorch/CUDA port's tree)")
    p.add_argument("--root", default=None,
                   help="tree to lint (default: auto-detected repo root)")
    p.add_argument("--checker", action="append", choices=sorted(CHECKERS),
                   help="run only this checker (repeatable)")
    p.add_argument("--proto", action="store_true",
                   help="run only the kf-verify protocol verifier "
                        "(proto-verify)")
    p.add_argument("--changed", action="store_true",
                   help="report only findings in files changed vs git "
                        "(analysis stays whole-tree; exits 0 fast when "
                        "nothing changed)")
    p.add_argument("--list", action="store_true",
                   help="list available checkers and exit")
    p.add_argument("--json", action="store_true",
                   help="emit findings as a JSON list on stdout")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="suppress findings whose (checker, path, message) "
                        "fingerprint appears in this JSON baseline")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write the current findings as a baseline and exit 0")
    p.add_argument("--timing", action="store_true",
                   help="print each checker's findings and seconds on "
                        "stderr")
    args = p.parse_args(argv)
    if args.list:
        for name in sorted(CHECKERS):
            print(name)
        return 0
    names = args.checker
    if args.proto:
        names = list(names or []) + [c for c in PROTO_CHECKERS
                                     if c not in (names or [])]
    try:
        root = args.root or repo_root()
        changed: Optional[List[str]] = None
        if args.changed:
            changed = _git_changed_files(root)
            if changed is not None and not any(
                    p.endswith((".py", ".cc", ".cpp", ".h"))
                    for p in changed):
                print("kflint: 0 violation(s) (no relevant changes)",
                      file=sys.stderr)
                return 0
        timings: Dict[str, Tuple[int, float]] = {}
        violations = run_checkers(root, names, timings)
        if args.timing:
            for name, (n, secs) in timings.items():
                print(f"kflint: {name} {n} finding(s) in {secs:.3f} s",
                      file=sys.stderr)
        if changed is not None:
            changed_set = expand_coupled(changed)
            violations = [v for v in violations if v.path in changed_set]
        suppressed = 0
        if args.baseline:
            violations, suppressed = apply_baseline(
                violations, load_baseline(args.baseline))
    except Exception as e:  # noqa: BLE001 - CLI surface
        print(f"kflint: internal error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        entries = [
            {"checker": v.checker, "path": v.path, "message": v.message}
            for v in violations
        ]
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"kflint: wrote {len(entries)} baseline entr"
              f"{'y' if len(entries) == 1 else 'ies'} to "
              f"{args.write_baseline}", file=sys.stderr)
        return 0

    if args.json:
        print(json.dumps([
            {"checker": v.checker, "path": v.path, "line": v.line,
             "message": v.message}
            for v in violations
        ], indent=2))
    else:
        for v in violations:
            print(v.render())
    n = len(violations)
    checkers = names or sorted(CHECKERS)
    note = f" ({suppressed} baselined)" if suppressed else ""
    print(f"kflint: {n} violation(s){note} [{', '.join(checkers)}]",
          file=sys.stderr)
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
