"""kf-verify: static SPMD protocol verifier (the ``proto-verify`` rule;
port of ``kungfu_tpu/analysis/protoverify.py`` over the port's tree —
the tags it proves are the reference's wire tags, which the port keeps).

Proves three properties of the comm plane over *every* valid
``ParallelPlan`` geometry up to ``KF_VERIFY_MAX_RANKS`` ranks, without
importing or running any of it:

1. **ordering consistency** — all members of a group issue the same
   collective sequence; an ``if`` guard reading rank-like state that
   feeds a collective on one side only is flagged, as is a bucket loop
   whose tag index runs against canonical order (``reversed(...)`` /
   ``b{N - 1 - i}`` — a *uniform* swap is invisible to cross-rank
   comparison, so this is a static rule, not a simulation rule);
2. **tag pairing** — within a self-contained entrypoint every p2p send
   skeleton is matched by a recv skeleton and vice versa (no orphans),
   no duplicate in-flight tags in any simulated geometry, and the
   prefetch window stays below the engine async pool;
3. **deadlock freedom** — symmetric blocking-recv-before-send is
   flagged statically; rank-guarded mirror arms (two sides of an ``if``
   that exchange with each other) are 2-rank simulated including
   ``drain_async``-style fences; and every enumerated geometry of the
   pipeline step, the ZeRO bucket loops, both recarve protocols, the
   ring mirrors and the serve replay path is run through an
   event-driven multi-rank simulator that must terminate with an empty
   wire.

The front half (site extraction, tag templates, branch/loop context)
lives in :mod:`kungfu_tpu_torch.analysis.commgraph`.  The geometry layer does
not re-model the schedule math: ``build_schedule``, ``stage_partition``,
``_chunk_splits``, ``reshard_plan`` etc. are *executed from the parsed
source* of ``parallel/pp.py`` / ``parallel/zero.py`` (they are pure,
torch-free functions by construction), so the verifier cannot drift from
the shipped schedules.  ``EXPECTED_BINDINGS`` pins the simulator's tag
model to extracted sites the same way — if a protocol's tags change
shape, the verifier fails loudly instead of proving the wrong thing.

Knobs (read directly from the environment — this module must not
import ``utils/envs.py``, whose package import pulls in torch; the
registry entries live there, see ``verify_knobs()``):

* ``KF_VERIFY_MAX_RANKS`` (default 16) — geometry world-size ceiling;
* ``KF_VERIFY_GEOMETRY_CAP`` (default 0 = uncapped) — max geometries;
* ``KF_VERIFY_TIMEOUT_S`` (default 60) — wall-clock budget for the
  simulation sweep; on expiry remaining geometries are skipped
  (coverage shrinks, the build does not flake red).
"""

from __future__ import annotations

import ast
import math
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from kungfu_tpu_torch.analysis import commgraph
from kungfu_tpu_torch.analysis.callgraph import project_graph
from kungfu_tpu_torch.analysis.commgraph import (
    CommSite,
    EntryProtocol,
    FALLBACK_SPECS,
    TagTemplate,
    Hole,
    engine_specs,
    entry_protocols,
)
from kungfu_tpu_torch.analysis.core import Violation, parse_module

CHECKER = "proto-verify"

DEFAULT_MAX_RANKS = 16
DEFAULT_GEOMETRY_CAP = 0
DEFAULT_TIMEOUT_S = 60.0

PP_RELPATH = "kungfu_tpu_torch/parallel/pp.py"
ZERO_RELPATH = "kungfu_tpu_torch/parallel/zero.py"

#: the simulator's tag model, pinned to extraction: each (entry suffix,
#: op, skeleton) must match at least one extracted site of the shipped
#: tree, else the protocol drifted out from under the model
EXPECTED_BINDINGS: Tuple[Tuple[str, str, str], ...] = (
    ("zero::host_bucket_pipeline", "reduce_scatter", "{}.b{}"),
    ("zero::host_bucket_pipeline", "reduce_scatter_async", "{}.b{}"),
    ("zero::host_bucket_all_gather", "all_gather", "{}.b{}"),
    ("zero::host_bucket_all_gather", "all_gather_async", "{}.b{}"),
    ("HostPipeline.train_step", "send_async", "{}.t{}.rs.c{}.b{}.o{}"),
    ("HostPipeline.train_step", "recv_async", "{}.b{}.o{}"),
    ("HostPipeline.train_step", "send_async", "{}.t{}.{}.c{}.o{}"),
    ("HostPipeline.train_step", "recv_async", "{}.t{}.{}.c{}.o{}"),
    ("StageBoundary.replicate_ring", "channel.send", "kf.ppbuddy.{}"),
    ("StageBoundary.replicate_ring", "_recv_or_fail", "kf.ppbuddy.{}"),
    ("StageBoundary.recarve", "channel.send", "kf.pprc.{}.{}{}"),
    ("StageBoundary.recarve", "_recv_or_fail", "kf.pprc.{}.{}{}"),
    ("StageBoundary.recarve", "channel.send", "kf.pprc.{}.{}{}.{}"),
    ("StageBoundary.recarve", "_recv_or_fail", "kf.pprc.{}.{}{}.{}"),
    ("ZeroBoundary.replicate_ring", "channel.send", "kf.zbuddy.{}"),
    ("ZeroBoundary.replicate_ring", "_recv_or_fail", "kf.zbuddy.{}"),
    ("ZeroBoundary._recarve_channel", "channel.send",
     "kf.zrc.{}.l{}.o{}"),
    ("ZeroBoundary._recarve_channel", "_recv_or_fail",
     "kf.zrc.{}.l{}.o{}"),
    ("ZeroBoundary._recarve_channel", "channel.send",
     "kf.zrc.{}.scalars"),
    ("ZeroBoundary._recarve_channel", "_recv_or_fail",
     "kf.zrc.{}.scalars"),
    ("PersistPlane.agree_manifest", "channel.send",
     "kf.persist.agree.v{}"),
    ("PersistPlane.agree_manifest", "_recv_or_fail",
     "kf.persist.agree.v{}"),
)


def _knobs() -> Tuple[int, int, float]:
    def _int(name: str, dflt: int) -> int:
        try:
            return int(os.environ.get(name, "") or dflt)
        except ValueError:
            return dflt

    try:
        timeout = float(os.environ.get("KF_VERIFY_TIMEOUT_S", "")
                        or DEFAULT_TIMEOUT_S)
    except ValueError:
        timeout = DEFAULT_TIMEOUT_S
    return (_int("KF_VERIFY_MAX_RANKS", DEFAULT_MAX_RANKS),
            _int("KF_VERIFY_GEOMETRY_CAP", DEFAULT_GEOMETRY_CAP),
            timeout)


# -- entry point -------------------------------------------------------------
_CACHE: Dict[str, Tuple[object, List[Violation]]] = {}


def check(root: str) -> List[Violation]:
    """All proto-verify findings for ``root`` (cached per call graph —
    the CLI and the tests drive this repeatedly over one tree)."""
    key = os.path.abspath(root)
    graph = project_graph(key)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is graph:
        return list(hit[1])
    specs, entries, out = entry_protocols(key)
    out = list(out)
    for entry in entries:
        out.extend(_check_order_divergence(entry))
        out.extend(_check_canonical_order(entry))
        out.extend(_check_tag_pairing(entry))
        out.extend(_check_recv_before_send(entry))
        out.extend(_check_mirror_arms(entry))
    out.extend(_check_window_bound(key))
    out.extend(_check_bindings(entries))
    out.extend(_geometry_checks(key, entries))
    _CACHE[key] = (graph, list(out))
    return out


# -- rule A: collective ordering consistency ---------------------------------
def _skel(site: CommSite) -> Optional[str]:
    return site.tag.skeleton() if site.tag is not None else None


def _check_order_divergence(entry: EntryProtocol) -> List[Violation]:
    """A collective issued under a rank-dependent guard with no
    balancing issue of the same (op, tag skeleton) outside that guard
    side: group members diverge on the collective sequence."""
    out: List[Violation] = []
    colls = entry.collective_sites()
    for site in colls:
        guard = site.rank_guard()
        if guard is None:
            continue
        balanced = False
        for other in colls:
            if other is site:
                continue
            if other.op != site.op or _skel(other) != _skel(site):
                continue
            # balancing = same collective reachable when this guard
            # resolves the other way (other side, or not under it)
            sides = {b.side for b in other.branches
                     if b.key[0] == guard.key[0]}
            if guard.side not in sides:
                balanced = True
                break
        if not balanced:
            out.append(Violation(
                CHECKER, site.path, site.line,
                f"collective `{site.op}` issued under rank-dependent "
                f"guard (line {guard.line}, {guard.side}) with no "
                "matching issue on the other side — group members "
                "diverge on the collective sequence"))
    return out


# -- rule B: canonical bucket order ------------------------------------------
def _hole_names(hole: Hole) -> Set[str]:
    if hole.node is None:
        return set()
    return {n.id for n in ast.walk(hole.node) if isinstance(n, ast.Name)}


def _sub_right_names(expr: ast.AST) -> Set[str]:
    """Names appearing in the right operand of any ``-`` inside
    ``expr`` (the ``b{N - 1 - i}`` shape)."""
    out: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub):
            out |= {m.id for m in ast.walk(n.right)
                    if isinstance(m, ast.Name)}
    return out


def _check_canonical_order(entry: EntryProtocol) -> List[Violation]:
    """Bucket/segment tags must be issued in canonical (ascending)
    order on every rank: a *uniform* reversal passes the cross-rank
    rendezvous (all ranks swap identically) yet breaks the documented
    dp member-order reduction contract and every mixed-version
    rollout, so iteration direction is checked statically."""
    out: List[Violation] = []
    for site in entry.sites:
        if site.tag is None:
            continue
        loop_vars: Set[str] = set()
        rev_vars: Set[str] = set()
        for lp in site.loops:
            loop_vars |= set(lp.targets)
            if lp.reversed_iter:
                rev_vars |= set(lp.targets)
        for hole in site.tag.holes():
            names = _hole_names(hole)
            if not (names & loop_vars):
                continue
            if names & rev_vars:
                out.append(Violation(
                    CHECKER, site.path, site.line,
                    f"`{site.op}` tag index `{hole.src}` is driven by a "
                    "reversed loop — bucket tags must be issued in "
                    "canonical ascending order on every rank"))
                break
            if hole.node is not None \
                    and (_sub_right_names(hole.node) & loop_vars):
                out.append(Violation(
                    CHECKER, site.path, site.line,
                    f"`{site.op}` tag index `{hole.src}` subtracts the "
                    "loop variable — bucket tags must be issued in "
                    "canonical ascending order on every rank"))
                break
    return out


# -- rule C: tag pairing -----------------------------------------------------
def _check_tag_pairing(entry: EntryProtocol) -> List[Violation]:
    """Within a self-contained entrypoint, every p2p send skeleton must
    appear as a recv skeleton and vice versa.  Skipped when any tag is
    dynamic (the geometry simulation covers those) or when the entry's
    recvs live in another process (``pair_scope is None``)."""
    if entry.pair_scope != "local" or not entry.resolvable:
        return []
    sends = [s for s in entry.p2p_sites() if s.kind == "p2p-send"]
    recvs = [s for s in entry.p2p_sites() if s.kind == "p2p-recv"]
    if not sends and not recvs:
        return []
    send_sk = {_skel(s) for s in sends}
    recv_sk = {_skel(s) for s in recvs}
    out: List[Violation] = []
    for s in sends:
        if _skel(s) not in recv_sk:
            out.append(Violation(
                CHECKER, s.path, s.line,
                f"p2p send tag `{s.tag.skeleton()}` has no matching "
                "recv anywhere in this protocol — orphan send (the "
                "peer's recv window will starve or overflow)"))
    for s in recvs:
        if _skel(s) not in send_sk:
            out.append(Violation(
                CHECKER, s.path, s.line,
                f"p2p recv tag `{s.tag.skeleton()}` has no matching "
                "send anywhere in this protocol — orphan recv (every "
                "rank reaching it blocks until the peer deadline)"))
    return out


# -- rule D: deadlock freedom (static part) ----------------------------------
def _same_context(a: CommSite, b: CommSite) -> bool:
    return [x.key for x in a.branches] == [x.key for x in b.branches]


def _check_recv_before_send(entry: EntryProtocol) -> List[Violation]:
    """In a symmetric protocol (same guards on both sites), a BLOCKING
    recv of tag T ordered before every send of T deadlocks all ranks:
    each blocks receiving what its peer only sends later.  The shipped
    mirrors all send-before-recv; serve/client splits (different guard
    arms) are exempt — the 2-arm simulation covers those."""
    if entry.pair_scope != "local" or not entry.resolvable:
        return []
    out: List[Violation] = []
    sends = [s for s in entry.p2p_sites() if s.kind == "p2p-send"]
    for r in entry.p2p_sites():
        if r.kind != "p2p-recv" or not r.blocking:
            continue
        peers = [s for s in sends if _skel(s) == _skel(r)
                 and _same_context(r, s)]
        if peers and all(r.order < s.order for s in peers):
            out.append(Violation(
                CHECKER, r.path, r.line,
                f"blocking recv of `{r.tag.skeleton()}` precedes every "
                "send of the same tag in this symmetric protocol — all "
                "ranks block on a frame no rank has sent yet "
                "(serve-all-then-assemble: sends must go first)"))
    return out


def _check_mirror_arms(entry: EntryProtocol) -> List[Violation]:
    """2-rank simulation of rank-guarded mirror arms: when both sides
    of a rank-dependent ``if`` hold p2p traffic and each side's sends
    are exactly the other side's recvs (a self-contained exchange), run
    one rank down each arm — posted recvs, fences (``drain_async``)
    and blocking recvs must settle.  Catches the
    handle-across-fence cycle: post recv, fence on it, and only then
    send what the peer's fence is waiting for."""
    out: List[Violation] = []
    guards: Dict[int, Dict[str, List[CommSite]]] = {}
    for site in entry.sites:
        g = site.rank_guard()
        if g is None or site.kind == "collective":
            continue
        guards.setdefault(g.line, {}).setdefault(g.side, []).append(site)
    for line, arms in guards.items():
        body, orelse = arms.get("body", []), arms.get("orelse", [])
        if not body or not orelse:
            continue
        if any(s.tag is None for s in body + orelse):
            continue

        def skels(sites: List[CommSite], kind: str) -> Set[str]:
            return {_skel(s) for s in sites if s.kind == kind}

        if skels(body, "p2p-send") != skels(orelse, "p2p-recv") \
                or skels(orelse, "p2p-send") != skels(body, "p2p-recv"):
            continue  # not a self-contained mirror — sim layer's job
        fences = [(f.order, f.line) for f in entry.fences]

        def arm_events(sites: List[CommSite]):
            """(order-merged) sim events for one arm, one peer."""
            evs = []
            for s in sorted(sites, key=lambda s: s.order):
                for fo, _fl in fences:
                    if evs and evs[-1][0] < fo < s.order:
                        evs.append((fo, ("fence",)))
                tag = _skel(s)
                if s.kind == "p2p-send":
                    evs.append((s.order, ("send", "peer", tag)))
                elif s.blocking:
                    evs.append((s.order, ("recv", "peer", tag)))
                else:
                    evs.append((s.order,
                                ("arecv", "peer", tag, f"k{s.order}",
                                 None)))
            # a fence after the last site still gates nothing — but a
            # fence between arecv and send is the cycle, keep interior
            return [e for _, e in evs]

        def prog(events):
            for ev in events:
                if ev[0] == "fence":
                    yield ("fence",)
                else:
                    yield ev

        findings, _ = _simulate(
            {"r0": prog(arm_events(body)),
             "r1": prog(arm_events(orelse))},
            peers={"r0": "r1", "r1": "r0"})
        if findings:
            detail = findings[0]
            if detail.startswith("deadlock: "):
                detail = detail[len("deadlock: "):]
            out.append(Violation(
                CHECKER, entry.func.path, line,
                f"rank-guarded mirror arms deadlock: {detail} — a "
                "fence between posting a recv and sending the peer's "
                "frame cycles the wait-for graph"))
    return out


# -- rule F: static window bound ---------------------------------------------
def _module_int(root: str, rel: str, name: str) -> Tuple[Optional[int],
                                                         int]:
    path = os.path.join(root, rel)
    if not os.path.isfile(path):
        return None, 1
    mod = parse_module(path)
    if mod.tree is None:
        return None, 1
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)):
            return node.value.value, node.lineno
    return None, 1


def _check_window_bound(root: str) -> List[Violation]:
    """The pipeline's static handle window (prefetch + bounded sends +
    warmup slack) must fit the engine async pool, the invariant
    ``HostPipeline.__init__`` now asserts at plan-validation time."""
    pool, _ = _module_int(root, commgraph.ENGINE_RELPATH,
                          "ASYNC_POOL_WORKERS")
    pf, pf_line = _module_int(root, PP_RELPATH, "_PREFETCH")
    mi, _ = _module_int(root, PP_RELPATH, "_MAX_INFLIGHT_SENDS")
    if pool is None or pf is None or mi is None:
        return []
    if pf + mi + 2 > pool:
        return [Violation(
            CHECKER, PP_RELPATH, pf_line,
            f"pipeline handle window _PREFETCH({pf}) + "
            f"_MAX_INFLIGHT_SENDS({mi}) + 2 = {pf + mi + 2} exceeds the "
            f"engine async pool ({pool}) — queued recv tasks never "
            "post and the per-peer deadline reads peers as dead")]
    return []


# -- model drift pin ---------------------------------------------------------
def _check_bindings(entries: List[EntryProtocol]) -> List[Violation]:
    out: List[Violation] = []
    for suffix, op, skeleton in EXPECTED_BINDINGS:
        entry = next((e for e in entries if e.name.endswith(suffix)),
                     None)
        if entry is None:
            continue  # subset tree (fixtures): nothing to pin
        if not any(s.op == op and _skel(s) == skeleton
                   for s in entry.sites):
            out.append(Violation(
                CHECKER, entry.func.path, entry.func.lineno,
                f"protocol model drift: expected a `{op}` site with tag "
                f"skeleton `{skeleton}` in {suffix} — the simulator's "
                "tag model no longer matches the shipped protocol; "
                "update EXPECTED_BINDINGS and the geometry models "
                "together"))
    return out


# -- the event-driven multi-rank simulator -----------------------------------
def _simulate(programs: Dict[object, Iterable],
              peers: Optional[Dict[object, object]] = None,
              deadline: Optional[float] = None
              ) -> Tuple[List[str], Dict[str, int]]:
    """Run rank programs (generators of comm events) to completion.

    Events::

        ("send",  dst, tag)              buffered, never blocks
        ("recv",  src, tag)              blocks on matching send
        ("arecv", src, tag, key, win)    posts; ("wait", key) blocks
        ("wait",  key)                   recv handle or acoll handle
        ("fence",)                       blocks until all posted recvs
                                         of this rank are matchable
        ("coll",  group, op, tag)        blocking rendezvous on tag
        ("acoll", group, op, tag, key)   arrival now, block at wait
        ("die",)                         rank stops; its wire clears

    Returns (findings, max window occupancy per label).  Findings cover
    deadlock (with per-rank blocked-state dump), duplicate in-flight
    tags, orphan sends/posted recvs at exit, and collective stragglers.
    ``peers`` maps the literal dst/src token "peer" per rank (the 2-arm
    mirror sim).
    """
    findings: List[str] = []
    gens = {r: iter(p) for r, p in programs.items()}
    wire: Dict[Tuple[object, object, str], int] = {}
    posted: Dict[object, Dict[str, Tuple[object, str]]] = \
        {r: {} for r in gens}
    acoll_keys: Dict[object, Dict[str, Tuple[tuple, str]]] = \
        {r: {} for r in gens}
    arrivals: Dict[Tuple[tuple, str], Dict[object, str]] = {}
    released: Dict[Tuple[tuple, str], int] = {}
    windows: Dict[Tuple[object, object], int] = {}
    maxwin: Dict[str, int] = {}
    pending: Dict[object, tuple] = {}
    dead: Set[object] = set()
    done: Set[object] = set()

    def _peer(rank: object, token: object) -> object:
        if token == "peer" and peers is not None:
            return peers[rank]
        return token

    def _try(rank: object, ev: tuple) -> bool:
        """True when ``ev`` completed (non-blocking or satisfied)."""
        op = ev[0]
        if op == "send":
            dst, tag = _peer(rank, ev[1]), ev[2]
            if dst in dead:
                return True
            k = (rank, dst, tag)
            wire[k] = wire.get(k, 0) + 1
            if wire[k] > 1:
                findings.append(
                    f"duplicate in-flight tag `{tag}` {rank}->{dst} — "
                    "a recv can match either frame (double-match)")
            return True
        if op == "recv":
            src, tag = _peer(rank, ev[1]), ev[2]
            k = (src, rank, tag)
            if wire.get(k, 0) > 0:
                wire[k] -= 1
                if not wire[k]:
                    del wire[k]
                return True
            return False
        if op == "arecv":
            src, tag, key, win = \
                _peer(rank, ev[1]), ev[2], ev[3], ev[4]
            posted[rank][key] = (src, tag)
            if win is not None:
                wk = (rank, win)
                windows[wk] = windows.get(wk, 0) + 1
                maxwin[win] = max(maxwin.get(win, 0), windows[wk])
            return True
        if op == "wait":
            key = ev[1]
            if key in posted[rank]:
                src, tag = posted[rank][key]
                if _try(rank, ("recv", src, tag)):
                    del posted[rank][key]
                    for (wr, wl), _n in list(windows.items()):
                        pass
                    # window release: key prefixes map 1:1 to labels
                    for wl in list(maxwin):
                        wk = (rank, wl)
                        if key.startswith(wl) and windows.get(wk, 0) > 0:
                            windows[wk] -= 1
                            break
                    return True
                return False
            if key in acoll_keys[rank]:
                ck = acoll_keys[rank][key]
                group = ck[0]
                if len(arrivals.get(ck, {})) == len(group) \
                        or released.get(ck, 0) > 0:
                    if ck not in released:
                        _validate_coll(ck)
                        released[ck] = len(group)
                    released[ck] -= 1
                    if not released[ck]:
                        released.pop(ck)
                        arrivals.pop(ck, None)
                    del acoll_keys[rank][key]
                    return True
                return False
            return True  # unknown handle: treat settled
        if op == "fence":
            for key, (src, tag) in list(posted[rank].items()):
                if _try(rank, ("recv", src, tag)):
                    del posted[rank][key]
            return not posted[rank]
        if op == "coll":
            group, cop, tag = tuple(ev[1]), ev[2], ev[3]
            ck = (group, tag)
            arrivals.setdefault(ck, {})[rank] = cop
            if len(arrivals[ck]) == len(group) \
                    or released.get(ck, 0) > 0:
                if ck not in released:
                    _validate_coll(ck)
                    released[ck] = len(group)
                released[ck] -= 1
                if not released[ck]:
                    released.pop(ck)
                    arrivals.pop(ck, None)
                return True
            return False
        if op == "acoll":
            group, cop, tag, key = tuple(ev[1]), ev[2], ev[3], ev[4]
            ck = (group, tag)
            arrivals.setdefault(ck, {})[rank] = cop
            acoll_keys[rank][key] = ck
            return True
        if op == "die":
            dead.add(rank)
            # frames already handed to the channel still deliver
            # (buffered); only undelivered frames TO the dead rank void
            for k in [k for k in wire if k[1] == rank]:
                del wire[k]
            posted[rank].clear()
            return True
        raise AssertionError(f"unknown sim event {ev!r}")

    def _validate_coll(ck: Tuple[tuple, str]) -> None:
        ops = set(arrivals[ck].values())
        if len(ops) > 1:
            findings.append(
                f"collective divergence on tag `{ck[1]}`: members "
                f"issued {sorted(ops)}")

    def _advance(rank: object) -> bool:
        progressed = False
        if rank in pending:
            if not _try(rank, pending[rank]):
                return False
            del pending[rank]
            progressed = True
        gen = gens.get(rank)
        while gen is not None:
            try:
                ev = next(gen)
            except StopIteration:
                done.add(rank)
                del gens[rank]
                return True
            if ev[0] == "die":
                _try(rank, ev)
                done.add(rank)
                del gens[rank]
                return True
            if _try(rank, ev):
                progressed = True
                continue
            pending[rank] = ev
            return progressed
        return progressed

    while gens:
        if deadline is not None and time.monotonic() > deadline:
            return findings, maxwin  # budget hit: partial, not red
        progress = False
        for rank in list(gens):
            if _advance(rank):
                progress = True
        if not progress:
            def _dump(r: object) -> str:
                ev = pending.get(r, ("?",))
                if len(ev) > 1:
                    return f"{r} blocked on {ev[0]} `{ev[-1]}`"
                return f"{r} blocked on {ev[0]}"
            findings.append("deadlock: " + "; ".join(
                _dump(r) for r in sorted(gens, key=str)))
            return findings, maxwin

    leftover = sorted({k[2] for k, n in wire.items()
                       if n > 0 and k[1] not in dead})
    if leftover:
        findings.append(
            "orphan sends never received: "
            + ", ".join(f"`{t}`" for t in leftover[:5]))
    for rank, ps in posted.items():
        if ps and rank not in dead:
            tags = sorted({t for _, t in ps.values()})
            findings.append(
                f"rank {rank} exited with posted recvs never matched: "
                + ", ".join(f"`{t}`" for t in tags[:5]))
            break
    if arrivals:
        ck = next(iter(arrivals))
        findings.append(
            f"collective straggler: tag `{ck[1]}` reached only "
            f"{len(arrivals[ck])}/{len(ck[0])} members")
    return findings, maxwin


# -- pure schedule math, executed from source --------------------------------
_PP_PURE = ("SCHEDULES", "_MAX_INFLIGHT_SENDS", "_PREFETCH",
            "_UNIT_EMBED", "_UNIT_FINAL", "stage_partition",
            "interleaved_partition", "schedule_1f1b",
            "schedule_sequential", "schedule_interleaved",
            "build_schedule", "stage_recarve_plan", "_chunk_splits")
_ZERO_PURE = ("reshard_plan", "host_bucket_spans")


def _pure_namespace(root: str, rel: str,
                    names: Sequence[str]) -> Optional[dict]:
    """Exec the named top-level defs/constants of ``rel`` (pure,
    torch-free schedule math by construction) into a fresh namespace —
    the simulator runs the SHIPPED schedules, not a re-model."""
    path = os.path.join(root, rel)
    if not os.path.isfile(path):
        return None
    mod = parse_module(path)
    if mod.tree is None:
        return None
    import typing
    ns: dict = {"math": math, "typing": typing}
    for t in ("List", "Tuple", "Optional", "Sequence", "Dict", "Set",
              "Iterable"):
        ns[t] = getattr(typing, t)
    wanted = set(names)
    body = []
    for node in mod.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in wanted:
            body.append(node)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id in wanted):
            body.append(node)
    try:
        code = compile(ast.Module(body=body, type_ignores=[]),
                       path, "exec")
        exec(code, ns)  # noqa: S102 - parsed project source, not input
    except Exception:  # noqa: BLE001 - reported as a finding upstream
        return None
    if not wanted.issubset(ns):
        return None
    return ns


# -- geometry models ---------------------------------------------------------
def _pipeline_program(stage: int, d: int, S: int, dp: int, v: int,
                      schedule: str, m: int, zero: int, prefetch: int,
                      ops: list, nb: int = 2):
    """One rank of ``HostPipeline.train_step``: the extracted schedule's
    op list driven through the prefetch window, bounded act/grad sends,
    per-chunk dp reduce-scatter begin/finish, and the zero-dependent
    exchange — tags shaped exactly like the extracted sites (see
    EXPECTED_BINDINGS)."""
    V = S * v
    pf_on = schedule != "sequential"
    me = stage * dp + d

    def peer(stg: int) -> int:
        return stg * dp + d

    def op_dep(op):
        kind, mb, c = op
        vs = c * S + stage
        if kind == "F":
            if vs == 0:
                return None
            return (f"f{mb}.v{vs}", peer((vs - 1) % S))
        if vs == V - 1:
            return None
        return (f"b{mb}.v{vs}", peer((vs + 1) % S))

    recvs: Dict[str, str] = {}
    nkey = [0]

    def ensure(idx: int):
        for op in ops[idx: idx + 1 + prefetch]:
            dep = op_dep(op)
            if dep is None or dep[0] in recvs:
                continue
            tag, src = dep
            key = f"prefetch{nkey[0]}"
            nkey[0] += 1
            recvs[tag] = key
            yield ("arecv", src, tag, key, "prefetch")

    b_done = [0] * v
    pend: List[int] = []
    if pf_on:
        yield from ensure(0)
    for idx, op in enumerate(ops):
        if pf_on:
            yield from ensure(idx + 1)
        kind, mb, c = op
        vs = c * S + stage
        dep = op_dep(op)
        if dep is not None:
            tag, src = dep
            if tag in recvs:
                yield ("wait", recvs.pop(tag))
            else:
                yield ("recv", src, tag)
        if kind == "F":
            if vs < V - 1:
                yield ("send", peer((vs + 1) % S), f"f{mb}.v{vs + 1}")
            continue
        if vs > 0:
            yield ("send", peer((vs - 1) % S), f"b{mb}.v{vs - 1}")
        b_done[c] += 1
        if b_done[c] == m and dp > 1:
            for b in range(nb):
                for j in range(dp):
                    if j != d:
                        yield ("send", stage * dp + j,
                               f"rs.c{c}.b{b}.o{d}")
            pend.append(c)
    if dp > 1:
        for c in pend:
            hb: Dict[Tuple[int, int], str] = {}

            def post(b: int):
                if b >= nb:
                    return
                for j in range(dp):
                    if j != d:
                        key = f"dpc{c}b{b}j{j}"
                        hb[(b, j)] = key
                        yield ("arecv", stage * dp + j,
                               f"rs.c{c}.b{b}.o{j}", key, "dpbucket")

            yield from post(0)
            for b in range(nb):
                yield from post(b + 1)
                for j in range(dp):
                    if j != d:
                        yield ("wait", hb.pop((b, j)))
            what = "ag" if zero == 2 else "gg"
            hs: List[str] = []
            for j in range(dp):
                if j == d:
                    continue
                yield ("send", stage * dp + j, f"{what}.c{c}.o{d}")
                key = f"exc{c}j{j}"
                hs.append(key)
                yield ("arecv", stage * dp + j, f"{what}.c{c}.o{j}",
                       key, None)
            for key in hs:
                yield ("wait", key)
    assert me == stage * dp + d  # addressing invariant


def _bucket_program(r: int, world: int, nb: int, depth: int, op: str):
    """zero.host_bucket_pipeline / _all_gather: serial rendezvous per
    bucket, or the depth-k async pipeline (issue-ahead then wait)."""
    group = tuple(range(world))
    if depth <= 0:
        for i in range(nb):
            yield ("coll", group, op, f"z.b{i}")
        return
    q: List[Tuple[int, str]] = []
    for i in range(min(depth, nb)):
        yield ("acoll", group, op, f"z.b{i}", f"h{i}")
        q.append((i, f"h{i}"))
    while q:
        i, h = q.pop(0)
        nxt = i + depth
        if nxt < nb:
            yield ("acoll", group, op, f"z.b{nxt}", f"h{nxt}")
            q.append((nxt, f"h{nxt}"))
        yield ("wait", h)


def _ring_program(r: int, n: int, prefix: str):
    """StageBoundary/ZeroBoundary.replicate_ring: send the mirror to
    the predecessor BEFORE receiving from the successor."""
    yield ("send", (r - 1) % n, f"{prefix}.state")
    yield ("recv", (r + 1) % n, f"{prefix}.state")


def _zero_recarve_programs(old_n: int, new_n: int, stride: int,
                           dead: Set[int], plan: list):
    """ZeroBoundary._recarve_channel over a membership change: serve
    phase (buddy-predecessor serves dead ranks, lowest survivor serves
    scalars to pure joiners), then assemble phase."""
    alive = [o for o in range(old_n) if o not in dead]
    stayers = alive[:new_n]
    joiners = [f"j{k}" for k in range(max(0, new_n - len(stayers)))]
    old_addr = {o: f"w{o}" for o in range(old_n)}
    new_workers = [old_addr[o] for o in stayers] + joiners
    old_of_addr = {old_addr[o]: o for o in alive}
    new_of_addr = {a: r for r, a in enumerate(new_workers)}
    serving_scal = min(alive)

    def server_of(o: int) -> Optional[int]:
        if o in dead:
            p = (o - stride) % old_n
            return None if p in dead else p
        return o

    def prog(me: str):
        my_old = old_of_addr.get(me)
        my_new = new_of_addr.get(me)
        if my_old is not None:
            for (o, r, s, ln) in plan:
                if server_of(o) != my_old:
                    continue
                dst = new_workers[r]
                if dst == me:
                    continue
                for i in (0, 1):
                    yield ("send", dst, f"zrc.l{i}.o{s}")
            if my_old == serving_scal:
                for w in joiners:
                    yield ("send", w, "zrc.scalars")
        if my_new is None:
            return  # leaver: served, detaches
        if my_old is None:
            yield ("recv", old_addr[serving_scal], "zrc.scalars")
        for (o, r, s, ln) in plan:
            if r != my_new:
                continue
            serv = server_of(o)
            if my_old is not None and serv == my_old:
                continue  # local copy
            for i in (0, 1):
                yield ("recv", old_addr[serv], f"zrc.l{i}.o{s}")

    participants = [old_addr[o] for o in alive] + joiners
    return {a: prog(a) for a in participants}


def _pp_recarve_programs(ns_pure: dict, old_n: int, staying: List[int],
                         dead: Set[int], dp: int, zero: int,
                         n_layers: int = 8):
    """StageBoundary.recarve at layer-unit granularity: synthesize the
    flat segment list from the SHIPPED stage_partition (embed on stage
    0, final on the last), then run the exact two-phase serve/assemble
    pairing with the shipped _chunk_splits for ZeRO-2 opt chunks."""
    stage_partition = ns_pure["stage_partition"]
    _chunk_splits = ns_pure["_chunk_splits"]
    new_n = len(staying)
    lw, ew, fw = 5, 3, 2  # synthetic per-unit flat widths

    def totals(parts, n):
        t = []
        for s, (lo, hi) in enumerate(parts):
            w = (hi - lo) * lw
            if s == 0:
                w += ew
            if s == n - 1:
                w += fw
            t.append(max(1, w))
        return t

    old_parts = stage_partition(n_layers, old_n)
    new_parts = stage_partition(n_layers, new_n)
    old_totals = totals(old_parts, old_n)
    new_totals = totals(new_parts, new_n)

    def starts(tot):
        out, off = [], 0
        for w in tot:
            out.append(off)
            off += w
        return out, off

    old_start, g1 = starts(old_totals)
    new_start, g2 = starts(new_totals)
    assert g1 == g2, "stage flat layouts must cover the same vector"
    segs = []
    for os_ in range(old_n):
        for ns in range(new_n):
            lo = max(old_start[os_], new_start[ns])
            hi = min(old_start[os_] + old_totals[os_],
                     new_start[ns] + new_totals[ns])
            if lo < hi:
                segs.append((os_, lo - old_start[os_], ns,
                             lo - new_start[ns], hi - lo))
    new_of_old = {os_: ns for ns, os_ in enumerate(staying)}
    oc = {s: max(1, math.ceil(old_totals[s] / dp))
          for s in range(old_n)}
    nc = {s: max(1, math.ceil(new_totals[s] / dp))
          for s in range(new_n)}

    def server_stage(os_: int) -> int:
        return (os_ - 1) % old_n if os_ in dead else os_

    def addr(stage: int, lane: int) -> str:
        return f"s{stage}d{lane}"

    def prog(my_stage: int, my_dp: int):
        me = addr(my_stage, my_dp)
        my_new_stage = new_of_old.get(my_stage)
        # PHASE 1 — serve every span this rank hosts
        for i, (os_, ooff, ns, noff, ln) in enumerate(segs):
            serv = server_stage(os_)
            if serv == my_stage:
                if not (my_new_stage is not None
                        and ns == my_new_stage):
                    dst = addr(staying[ns], my_dp)
                    if dst != me:
                        yield ("send", dst, f"pprc.p{i}")
            if zero == 2:
                for (jo, jn, oo, no, l) in _chunk_splits(
                        ooff, noff, ln, oc[os_], nc[ns]):
                    if not (serv == my_stage and jo == my_dp):
                        continue
                    dst_is_me = (my_new_stage is not None
                                 and ns == my_new_stage
                                 and jn == my_dp)
                    if not dst_is_me:
                        dst = addr(staying[ns], jn)
                        for k in (0, 1):
                            yield ("send", dst, f"pprc.z{k}.{i}.{oo}")
        # PHASE 2 — assemble my new stage
        for i, (os_, ooff, ns, noff, ln) in enumerate(segs):
            serv = server_stage(os_)
            if my_new_stage is not None and ns == my_new_stage \
                    and serv != my_stage:
                yield ("recv", addr(serv, my_dp), f"pprc.p{i}")
            if zero == 2:
                for (jo, jn, oo, no, l) in _chunk_splits(
                        ooff, noff, ln, oc[os_], nc[ns]):
                    dst_is_me = (my_new_stage is not None
                                 and ns == my_new_stage
                                 and jn == my_dp)
                    if not dst_is_me \
                            or (serv == my_stage and jo == my_dp):
                        continue
                    for k in (0, 1):
                        yield ("recv", addr(serv, jo),
                               f"pprc.z{k}.{i}.{oo}")

    return {addr(s, j): prog(s, j)
            for s in range(old_n) if s not in dead
            for j in range(dp)}


def _serve_replay_programs():
    """The serve dispatch/replay protocol: a worker death mid-request
    clears its wire; the router replays the committed request to a
    live worker exactly once — no double-delivery to live ranks."""
    def router():
        yield ("send", "w0", "req.srv.r1")
        # w0 dies before serving; the undelivered frame voids with it
        # and the deadline path replays to w1 (a recv-from-dead is the
        # deadline recovery branch — deadline expiry is not a wire
        # event, so the model takes the replay leg directly)
        yield ("send", "w1", "req.srv.r1")
        yield ("recv", "w1", "req.srvc.r1")

    def w0():
        yield ("die",)

    def w1():
        yield ("recv", "rt", "req.srv.r1")
        yield ("send", "rt", "req.srvc.r1")

    return {"rt": router(), "w0": w0(), "w1": w1()}


def _persist_agree_programs(n: int):
    """The kf-persist restore-time agreement (elastic/persist.py
    ``agree_manifest``): rank 0 fans its manifest choice to every other
    rank in ascending order; each non-zero rank blocks on exactly that
    one frame.  n=1 degenerates to no wire traffic at all."""
    def prog(r: int):
        if r == 0:
            for k in range(1, n):
                yield ("send", k, "persist.agree")
        else:
            yield ("recv", 0, "persist.agree")

    return {r: prog(r) for r in range(n)}


# -- geometry enumeration ----------------------------------------------------
def _geometry_checks(root: str,
                     entries: List[EntryProtocol]) -> List[Violation]:
    """Enumerate every valid geometry ≤ max_ranks and simulate each
    protocol; any finding names its geometry.  Runs only on trees that
    ship the real pipeline (fixture trees carry proto_entry_* functions
    and are covered purely statically)."""
    train = next((e for e in entries
                  if e.name.endswith("HostPipeline.train_step")), None)
    if train is None:
        return []
    max_ranks, cap, timeout = _knobs()
    deadline = time.monotonic() + timeout
    pp_ns = _pure_namespace(root, PP_RELPATH, _PP_PURE)
    zero_ns = _pure_namespace(root, ZERO_RELPATH, _ZERO_PURE)
    if pp_ns is None or zero_ns is None:
        which = PP_RELPATH if pp_ns is None else ZERO_RELPATH
        return [Violation(
            CHECKER, which, 1,
            "could not extract the pure schedule math for geometry "
            "simulation — keep build_schedule/stage_partition/"
            "reshard_plan free of torch/numpy (the verifier executes "
            "them from source)")]
    pool, _ = _module_int(root, commgraph.ENGINE_RELPATH,
                          "ASYNC_POOL_WORKERS")
    pool = pool or 8
    out: List[Violation] = []
    count = [0]

    def budget() -> bool:
        count[0] += 1
        if cap and count[0] > cap:
            return _trunc("KF_VERIFY_GEOMETRY_CAP")
        if time.monotonic() >= deadline:
            return _trunc("KF_VERIFY_TIMEOUT_S")
        return True

    def _trunc(knob: str) -> bool:
        # never truncate silently: shrunk coverage must be visible in
        # the gate log even though it does not fail the build
        print(f"kflint: proto-verify geometry sweep truncated by {knob} "
              f"after {count[0] - 1} geometries — raise the knob for "
              f"full coverage", file=sys.stderr)
        return False

    def report(label: str, findings: List[str], path: str,
               line: int) -> None:
        for f in findings[:2]:
            out.append(Violation(
                CHECKER, path, line, f"[{label}] {f}"))

    # 1) pipeline train_step over every (pp, dp, schedule, zero, m)
    build_schedule = pp_ns["build_schedule"]
    prefetch = pp_ns["_PREFETCH"]
    tpath, tline = train.func.path, train.func.lineno
    for S in range(2, max_ranks + 1):
        for dp in range(1, max_ranks // S + 1):
            for schedule in pp_ns["SCHEDULES"]:
                v = 2 if schedule == "interleaved" else 1
                for m in (S, 2 * S):
                    try:
                        ops = {s: build_schedule(schedule, m, S, s, v)
                               for s in range(S)}
                    except (ValueError, AssertionError):
                        continue  # invalid geometry, not a finding
                    for zero in (0, 2):
                        if not budget():
                            return out
                        label = (f"pp={S} dp={dp} sched={schedule} "
                                 f"m={m} zero={zero}")
                        programs = {
                            s * dp + d: _pipeline_program(
                                s, d, S, dp, v, schedule, m, zero,
                                prefetch, ops[s])
                            for s in range(S) for d in range(dp)}
                        findings, maxwin = _simulate(
                            programs, deadline=deadline)
                        if maxwin.get("prefetch", 0) >= pool:
                            findings.append(
                                f"prefetch window reaches "
                                f"{maxwin['prefetch']} outstanding "
                                f"recvs — must stay below the async "
                                f"pool ({pool})")
                        report(label, findings, tpath, tline)
                        if out:
                            return out  # fail fast: first geometry

    # 2) zero host bucket loops
    for world in (2, 3, 4, min(8, max_ranks)):
        for nb in (1, 2, 3):
            for depth in (0, 1, 2):
                for op in ("rs", "ag"):
                    if not budget():
                        return out
                    findings, _ = _simulate(
                        {r: _bucket_program(r, world, nb, depth, op)
                         for r in range(world)}, deadline=deadline)
                    report(f"bucket world={world} nb={nb} "
                           f"depth={depth} op={op}",
                           findings, ZERO_RELPATH, 1)

    # 3) ring mirrors
    for n in (2, 3, 4, 6):
        if not budget():
            return out
        findings, _ = _simulate(
            {r: _ring_program(r, n, "ring") for r in range(n)},
            deadline=deadline)
        report(f"ring n={n}", findings, PP_RELPATH, 1)

    # 4) zero recarve over membership changes
    reshard_plan = zero_ns["reshard_plan"]
    zr_geoms = [
        (4, 4, 1, set()), (4, 3, 1, set()), (4, 3, 1, {1}),
        (4, 5, 1, set()), (4, 5, 1, {2}), (3, 4, 1, {0}),
        (5, 3, 2, {1}), (4, 2, 1, {1, 3}), (2, 4, 1, set()),
        (6, 4, 1, {5}), (4, 4, 1, {2}), (4, 4, 2, {1}),
        (3, 6, 1, set()), (8, 4, 1, {6}), (4, 8, 1, set()),
        (5, 5, 1, {0}), (2, 2, 1, {1}), (6, 6, 1, {3}),
        (4, 6, 2, {0}),
    ]
    for (old_n, new_n, stride, dead) in zr_geoms:
        if old_n > max_ranks or new_n > max_ranks:
            continue
        if not budget():
            return out
        alive = [o for o in range(old_n) if o not in dead]
        if any((o - stride) % old_n in dead for o in dead):
            continue  # double failure domain: protocol refuses upfront
        total = 48
        plan = reshard_plan(total, old_n, new_n)
        findings, _ = _simulate(
            _zero_recarve_programs(old_n, new_n, stride, dead, plan),
            deadline=deadline)
        report(f"zero-recarve {old_n}->{new_n} stride={stride} "
               f"dead={sorted(dead)}",
               findings, "kungfu_tpu_torch/elastic/reshard.py", 1)

    # 5) pp stage recarve
    pr_geoms = [
        (2, [0, 1], set(), 1), (3, [0, 1, 2], set(), 1),
        (3, [0, 2], {1}, 1), (4, [0, 1, 2], {3}, 1),
        (4, [0, 1, 2, 3], set(), 2), (4, [1, 2, 3], {0}, 2),
        (3, [0, 1], set(), 2), (4, [0, 1], {2, 3}, 1),
    ]
    for (old_n, staying, dead, dp) in pr_geoms:
        if old_n * dp > max_ranks:
            continue
        if any((s - 1) % old_n in dead for s in dead):
            continue
        for zero in (0, 2):
            if not budget():
                return out
            findings, _ = _simulate(
                _pp_recarve_programs(pp_ns, old_n, staying, dead, dp,
                                     zero),
                deadline=deadline)
            report(f"pp-recarve {old_n}->{len(staying)} dp={dp} "
                   f"dead={sorted(dead)} zero={zero}",
                   findings, PP_RELPATH, 1)

    # 6) serve dispatch/replay
    if budget():
        findings, _ = _simulate(_serve_replay_programs(),
                                deadline=deadline)
        report("serve-replay", findings,
               "kungfu_tpu_torch/serve/router.py", 1)

    # 7) persist restore-time manifest agreement (kf-persist): rank 0
    # fans the chosen manifest out, everyone else blocks on rank 0 —
    # including the 1-rank degenerate world (no frames at all)
    for n in sorted({1, 2, 3, 4, min(8, max_ranks), max_ranks}):
        if n < 1 or n > max_ranks:
            continue
        if not budget():
            return out
        findings, _ = _simulate(
            _persist_agree_programs(n), deadline=deadline)
        report(f"persist-agree n={n}", findings,
               "kungfu_tpu_torch/elastic/persist.py", 1)
    return out
