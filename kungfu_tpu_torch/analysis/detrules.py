"""kf-det: the three replay-determinism rules over the taint engine
(port of ``kungfu_tpu/analysis/detrules.py``).

The port's RNG idiom is a seeded ``torch.Generator`` (ROADMAP C5), not a
key value, so ``rng-discipline`` checks there: (c) a process-global
draw (``torch.randn`` and friends with no ``generator=``, or a numpy /
stdlib draw) inside capture scope
(:mod:`~kungfu_tpu_torch.analysis.axisenv`), and (d) ``manual_seed``
seed material derived from entropy (``torch.manual_seed``,
``g.manual_seed``, ``torch.cuda.manual_seed[_all]``).  (a) split-key
reuse and (b) ``fold_in`` have no torch counterpart: they are kept for
jax code.  ``replay-taint`` and ``reduction-order`` are the reference's,
over the port's paths (the pinned directories are the port's
``parallel/``, ``ops/``, ``elastic/``, ``models/`` and
``optimizers/``).

``replay-taint``
    An entropy-tainted value (see :mod:`kungfu_tpu_torch.analysis.taint` for
    the source table) reaches a **replay-critical sink**: consensus
    proposal/digest construction, a rendezvous/tag name headed for the
    engine collectives or a ``req.srv*`` frame, a
    ``StepSnapshot``/``ZeroBoundary`` commit payload, a
    ``PersistPlane`` manifest record, or a chaos-deterministic matcher.
    Findings carry the full source→sink hop chain, so a ``time.time()``
    two helpers upstream reads as a path, not a mystery.

``rng-discipline``
    JAX PRNG keys are values, not state — the four ways this tree can
    get that wrong: (a) a key is *used again* after ``jax.random.split``
    consumed it (duplicate streams across ranks/replays), (b)
    ``fold_in`` mixes rank-local entropy into a key (streams diverge on
    replay), (c) a process-global ``np.random``/``random`` draw runs
    inside traced/jitted code (bakes one draw into the compiled
    artifact), (d) seed material for ``PRNGKey``/``default_rng`` is
    derived from entropy instead of agreed values like
    ``(cluster_version, step)``.

``reduction-order``
    Float accumulation is not associative; bitwise-pinned paths
    (``parallel/``, ``ops/``, ``elastic/``, ``models/``,
    ``optimizers/``) must not fold values in an order the runtime does
    not pin.  Flagged: accumulation (``+=`` / ``.append`` into an
    ordered container / ``sum()``) over ``set``/``frozenset`` iteration
    anywhere, and over dict ``.keys()/.values()/.items()`` iteration in
    the pinned dirs (insertion order is deterministic per run but
    *geometry-varying* across restart shapes).  The ``sorted(...)``
    canonical-order escape hatch is recognized — checked, not assumed.

Sink groups are **named** so future protocol surfaces inherit coverage
the day they land: the ROADMAP item 1–3 groups (``kv-migration``,
``moe-dispatch``, ``reshard-record``) are pre-registered below with the
terminal names those PRs will introduce.

All three gate with an EMPTY baseline (scripts/check.sh): a
determinism finding can never land as legacy debt — the replay
contract (docs/determinism.md) is all-or-nothing.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from kungfu_tpu_torch.analysis.callgraph import (FuncInfo,
                                            _terminal_and_receiver)
from kungfu_tpu_torch.analysis.collectives import _NAME_POS
from kungfu_tpu_torch.analysis.core import (
    Violation,
    parse_module,
    suppressed,
)
from kungfu_tpu_torch.analysis.taint import (
    _RNG_CTORS,
    _source_taint,
    CallRecord,
    ORDER_KINDS,
    TORCH_SEEDERS,
    TV,
    taint_engine,
)

CHECKER_TAINT = "replay-taint"
CHECKER_RNG = "rng-discipline"
CHECKER_RED = "reduction-order"

#: the linter's own modules name every source/sink as string tables and
#: fixtures; they are not protocol code
_EXEMPT_PREFIXES = ("kungfu_tpu_torch/analysis/",)

ANY = "any"
NAME = "name"

#: terminal -> (group, selector).  Selector ANY = every argument is
#: replay-critical; NAME = only the rendezvous-name argument (payloads
#: of gather/broadcast legitimately carry rank-local data — the *name*
#: must rendezvous).
SINKS: Dict[str, Tuple[str, object]] = {}

for _t in ("consensus_bytes", "_propose", "_slice_consensus",
           "agree_manifest"):
    SINKS[_t] = ("consensus", ANY)
for _t in ("barrier", "world_barrier", "gather_bytes", "broadcast_bytes",
           "allgather_bytes"):
    SINKS[_t] = ("rendezvous", NAME)
#: host-channel frame tag: chan.send(dst, name, payload)
SINKS["send"] = ("rendezvous", 1)
for _t in ("commit", "commit_local"):
    SINKS[_t] = ("commit", ANY)
for _t in ("persist_async", "_atomic_write", "manifest_name"):
    SINKS[_t] = ("manifest", ANY)
SINKS["parse_spec"] = ("chaos", ANY)
# -- pre-registered sink groups for the ROADMAP item 1-3 surfaces -------
# (KV-block migration frames, MoE all-to-all dispatch tags, restore-time
# resharding records).  The terminals match nothing today; the PRs that
# introduce them inherit kf-det coverage on day one.
for _t in ("migrate_kv_blocks", "kv_block_frame", "send_kv_block",
           "kv_migration_tag"):
    SINKS[_t] = ("kv-migration", ANY)
for _t in ("dispatch_all_to_all", "moe_dispatch_tag", "all_to_all_tag"):
    SINKS[_t] = ("moe-dispatch", ANY)
for _t in ("reshard_record", "stage_restore_plan", "restore_plan_record"):
    SINKS[_t] = ("reshard-record", ANY)


def _exempt(path: str) -> bool:
    return path.startswith(_EXEMPT_PREFIXES)


class _Flagger:
    """Dedup + suppression-aware violation collector."""

    def __init__(self, root: str, checker: str):
        self.root = root
        self.checker = checker
        self.out: List[Violation] = []
        self._seen: Set[Tuple[str, int, str]] = set()

    def flag(self, path: str, line: int, message: str) -> None:
        key = (path, line, message)
        if key in self._seen:
            return
        self._seen.add(key)
        mod = parse_module(os.path.join(self.root, path))
        if suppressed(mod.supp, line, self.checker):
            return
        self.out.append(Violation(self.checker, path, line, message))

    def done(self) -> List[Violation]:
        return sorted(self.out, key=lambda v: (v.path, v.line, v.message))


# ---------------------------------------------------------------------------
# replay-taint

def _sink_args(rec: CallRecord, selector) -> List[Tuple[str, TV]]:
    """(description, value) pairs of the replay-critical arguments."""
    if selector == ANY:
        pairs = [(f"arg {i}", tv) for i, tv in enumerate(rec.arg_tv)]
        pairs += [(f"{k}=", tv) for k, tv in sorted(rec.kw_tv.items())]
        return pairs
    if selector == NAME:
        if "name" in rec.kw_tv:
            return [("name=", rec.kw_tv["name"])]
        pos = _NAME_POS.get(rec.terminal)
        if pos is not None and pos < len(rec.arg_tv):
            return [(f"name (arg {pos})", rec.arg_tv[pos])]
        # peer-level consensus_bytes(data, name): name one slot early
        if rec.terminal == "consensus_bytes" and len(rec.arg_tv) == 2:
            return [("name (arg 1)", rec.arg_tv[1])]
        return []
    if isinstance(selector, int):
        if "name" in rec.kw_tv:
            return [("name=", rec.kw_tv["name"])]
        if selector < len(rec.arg_tv):
            return [(f"arg {selector}", rec.arg_tv[selector])]
    return []


def check_replay_taint(root: str) -> List[Violation]:
    eng = taint_engine(root)
    fl = _Flagger(root, CHECKER_TAINT)
    for func in eng.graph.functions:
        if _exempt(func.path):
            continue
        for rec in eng.result_of(func).calls:
            spec = SINKS.get(rec.terminal)
            if spec is None:
                continue
            group, selector = spec
            for desc, tv in _sink_args(rec, selector):
                for t in sorted(tv.taints,
                                key=lambda t: (t.path, t.line, t.desc)):
                    fl.flag(func.path, rec.line,
                            f"{group} sink `{rec.terminal}(...)` {desc} "
                            f"carries entropy: {t.render()} — derive it "
                            f"from agreed state or run it through an "
                            f"agreement op (docs/determinism.md)")
    return fl.done()


# ---------------------------------------------------------------------------
# rng-discipline

#: jax.random functions that consume a key as their first argument
_KEY_CONSUMERS = {
    "split", "fold_in", "normal", "uniform", "bernoulli", "permutation",
    "categorical", "gumbel", "truncated_normal", "randint", "bits",
    "choice", "dirichlet", "exponential", "gamma", "laplace", "poisson",
    "shuffle", "dropout",
}

_KEY_CTORS = {"PRNGKey", "key"}


def _is_jax_random(receiver: Tuple[str, ...]) -> bool:
    """``jax.random.*`` under any alias (``jax.random``, ``jrandom``,
    ``jr``); the stdlib ``random`` module is excluded by its lack of
    ``split``/``fold_in``/``PRNGKey`` at the call sites we match."""
    return bool(receiver) and "random" in receiver[-1].lower() \
        or receiver[-2:] == ("jax", "random")


def _scope_stmts(func_node: ast.AST):
    """Every node of this function body, nested defs excluded, in
    source order."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(func_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return sorted((n for n in out if hasattr(n, "lineno")),
                  key=lambda n: (n.lineno, n.col_offset))


def _target_names(target: ast.expr) -> Set[str]:
    names: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            names.add(n.id)
    return names


def _split_reuse(func: FuncInfo, fl: _Flagger) -> None:
    """A key passed to ``jax.random.split`` and not rebound by the same
    assignment is dead; any later keyed use duplicates a stream."""
    consumed: Dict[str, int] = {}
    handled_calls: Set[int] = set()
    for n in _scope_stmts(func.node):
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            value = n.value
            call = value
            if isinstance(call, ast.Subscript):
                call = call.value
            targets = set()
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    targets |= _target_names(t)
            elif n.target is not None:
                targets |= _target_names(n.target)
            if isinstance(call, ast.Call):
                f = call.func
                term = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                recv_ok = (isinstance(f, ast.Attribute)
                           and _is_jax_random(
                               tuple(_recv_chain(f))) or
                           isinstance(f, ast.Name))
                if term == "split" and recv_ok and call.args \
                        and isinstance(call.args[0], ast.Name):
                    handled_calls.add(id(call))
                    key_name = call.args[0].id
                    if key_name in consumed:
                        fl.flag(func.path, call.lineno,
                                f"PRNG key `{key_name}` split again after "
                                f"jax.random.split consumed it at line "
                                f"{consumed[key_name]} — duplicate "
                                f"streams; thread the returned keys "
                                f"(docs/determinism.md)")
                    if key_name not in targets:
                        consumed[key_name] = call.lineno
            # any rebinding discharges the consumed mark
            for name in targets:
                consumed.pop(name, None)
        elif isinstance(n, ast.Call):
            if id(n) in handled_calls:
                continue
            f = n.func
            if not isinstance(f, ast.Attribute):
                continue
            term = f.attr
            if term not in _KEY_CONSUMERS:
                continue
            if not _is_jax_random(tuple(_recv_chain(f))):
                continue
            if n.args and isinstance(n.args[0], ast.Name):
                key_name = n.args[0].id
                if key_name in consumed:
                    fl.flag(func.path, n.lineno,
                            f"PRNG key `{key_name}` reused after "
                            f"jax.random.split consumed it at line "
                            f"{consumed[key_name]} — the stream "
                            f"duplicates; use a key returned by the "
                            f"split (docs/determinism.md)")
        elif isinstance(n, ast.For):
            for name in _target_names(n.target):
                consumed.pop(name, None)


def _recv_chain(attr: ast.Attribute) -> List[str]:
    chain: List[str] = []
    n: ast.expr = attr.value
    while isinstance(n, ast.Attribute):
        chain.append(n.attr)
        n = n.value
    if isinstance(n, ast.Name):
        chain.append(n.id)
    chain.reverse()
    return chain


def check_rng_discipline(root: str) -> List[Violation]:
    from kungfu_tpu_torch.analysis.axisenv import axis_environment, fkey

    eng = taint_engine(root)
    env = axis_environment(root)
    fl = _Flagger(root, CHECKER_RNG)
    for func in eng.graph.functions:
        if _exempt(func.path):
            continue
        _split_reuse(func, fl)
        # (c) process-global RNG draw inside traced code — call-site
        # syntactic, so it needs no taint records
        jit_roots = env.jit_roots.get(fkey(func))
        if jit_roots:
            for site in func.calls:
                src = _source_taint(site.callee, site.receiver,
                                    site.node, func.path)
                if src is not None and src.kind == "rng":
                    roots = ", ".join(sorted(jit_roots))
                    fl.flag(func.path, site.line,
                            f"{src.desc} inside traced code (jit roots: "
                            f"{roots}) — the draw is baked into the "
                            f"compiled artifact; thread a jax.random "
                            f"key instead (docs/determinism.md)")
        _capture_draws(env, func, fl)
        for rec in eng.result_of(func).calls:
            # (b) fold_in with entropy-derived data
            if rec.terminal == "fold_in" and _is_jax_random(rec.receiver):
                data_tv = rec.kw_tv.get("data")
                if data_tv is None and len(rec.arg_tv) >= 2:
                    data_tv = rec.arg_tv[1]
                for t in _value_taints(data_tv):
                    fl.flag(func.path, rec.line,
                            f"jax.random.fold_in mixes entropy into the "
                            f"key: {t.render()} — fold in agreed values "
                            f"(step, cluster_version, layer index) "
                            f"instead (docs/determinism.md)")
            # (d) seed material derived from entropy
            seed_tv: Optional[TV] = None
            if rec.terminal in _KEY_CTORS and _is_jax_random(rec.receiver):
                seed_tv = rec.kw_tv.get("seed") or (
                    rec.arg_tv[0] if rec.arg_tv else None)
            elif rec.terminal in _RNG_CTORS or rec.terminal in TORCH_SEEDERS:
                seed_tv = rec.kw_tv.get("seed") or (
                    rec.arg_tv[0] if rec.arg_tv else None)
            if seed_tv is not None:
                for t in _value_taints(seed_tv):
                    fl.flag(func.path, rec.line,
                            f"`{rec.terminal}` seed material derives "
                            f"from entropy: {t.render()} — seed from "
                            f"agreed values like (cluster_version, "
                            f"step) (docs/determinism.md)")
    for func, block, prov in env.capture_regions:
        if not _exempt(func.path):
            _draws_in(func, [n for stmt in block.body for n in ast.walk(stmt)
                             if isinstance(n, ast.Call)], prov, fl)
    for func, lam, prov in env.capture_lambdas:
        if not _exempt(func.path):
            _draws_in(func, [n for n in ast.walk(lam.body)
                             if isinstance(n, ast.Call)],
                      f"passed to {prov}", fl)
    return fl.done()


def _capture_draws(env, func: FuncInfo, fl: _Flagger) -> None:
    """(c) on the port: a process-global draw in capture scope."""
    from kungfu_tpu_torch.analysis.axisenv import fkey

    roots = env.capture_roots.get(fkey(func))
    if roots:
        _draws_in(func, [s.node for s in func.calls],
                  f"capture roots: {', '.join(sorted(roots))}", fl)


def _draws_in(func: FuncInfo, calls: List[ast.Call], where: str,
              fl: _Flagger) -> None:
    for call in calls:
        term, recv = _terminal_and_receiver(call.func)
        if term is None:
            continue
        src = _source_taint(term, recv, call, func.path)
        if src is not None and src.kind == "rng":
            fl.flag(func.path, call.lineno,
                    f"{src.desc} inside captured code ({where}) — the "
                    f"process-global stream advances with every other "
                    f"consumer, so replays and ranks draw differently; "
                    f"pass a seeded torch.Generator (docs/determinism.md)")


def _value_taints(tv: Optional[TV]):
    if tv is None:
        return []
    return sorted((t for t in tv.taints if t.kind not in ORDER_KINDS),
                  key=lambda t: (t.path, t.line, t.desc))


# ---------------------------------------------------------------------------
# reduction-order

#: dirs whose numerics are bitwise-pinned by the replay contract —
#: dict-iteration order (geometry-varying insertion) is a hazard HERE;
#: set iteration is a hazard everywhere
PINNED_PREFIXES = (
    "kungfu_tpu_torch/parallel/", "kungfu_tpu_torch/ops/",
    "kungfu_tpu_torch/elastic/", "kungfu_tpu_torch/models/",
    "kungfu_tpu_torch/optimizers/",
)

#: ordered-container mutators: appending under an unordered iteration
#: builds an ordered artifact from an unordered order
_ORDERED_APPENDS = {"append", "extend", "insert", "appendleft"}

_DICT_ITERS = {"keys", "values", "items"}


def _call_terminal(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
    return None


def _unordered_iter(node: ast.expr, order_tainted_names: Set[str],
                    pinned: bool) -> Optional[str]:
    """Why iterating ``node`` has no pinned order, or None if it does."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "a set literal"
    term = _call_terminal(node)
    if term == "sorted":
        return None  # the canonical-order escape hatch
    if term in ("set", "frozenset"):
        return f"{term}(...)"
    if term in ("list", "tuple", "reversed"):
        # ordered wrapper: order comes from the inner iterable
        inner = node.args[0] if isinstance(node, ast.Call) and node.args \
            else None
        return _unordered_iter(inner, order_tainted_names, pinned) \
            if inner is not None else None
    if pinned and term in _DICT_ITERS and isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute):
        return f".{term}() of a dict (insertion order is geometry-shaped)"
    if isinstance(node, ast.Name) and node.id in order_tainted_names:
        return f"`{node.id}` (carries set iteration order)"
    return None


def _accumulations(body: List[ast.stmt]) -> List[Tuple[int, str]]:
    """(line, description) of order-sensitive accumulations in a loop
    body (nested loops included — they run under the outer order)."""
    out: List[Tuple[int, str]] = []
    stack: List[ast.AST] = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.AugAssign) and isinstance(
                n.op, (ast.Add, ast.Mult, ast.Sub)):
            tgt = n.target
            name = tgt.id if isinstance(tgt, ast.Name) else (
                tgt.attr if isinstance(tgt, ast.Attribute) else "?")
            out.append((n.lineno, f"`{name} {_op_sym(n.op)}= ...`"))
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _ORDERED_APPENDS:
            recv = _recv_chain(n.func)
            out.append((n.lineno,
                        f"`{'.'.join(recv) or '?'}.{n.func.attr}(...)`"))
        stack.extend(ast.iter_child_nodes(n))
    return sorted(out)


def _op_sym(op: ast.operator) -> str:
    return {"Add": "+", "Mult": "*", "Sub": "-"}.get(
        type(op).__name__, "?")


def check_reduction_order(root: str) -> List[Violation]:
    eng = taint_engine(root)
    fl = _Flagger(root, CHECKER_RED)
    for func in eng.graph.functions:
        if _exempt(func.path):
            continue
        pinned = func.path.startswith(PINNED_PREFIXES)
        res = eng.result_of(func)
        order_names = {
            name for name, tv in res.env.items()
            if any(t.kind in ORDER_KINDS for t in tv.taints)
        }
        for n in _scope_stmts(func.node):
            if isinstance(n, (ast.For, ast.AsyncFor)):
                why = _unordered_iter(n.iter, order_names, pinned)
                if why is None:
                    continue
                accs = _accumulations(n.body)
                for line, desc in accs:
                    fl.flag(func.path, line,
                            f"order-sensitive accumulation {desc} under "
                            f"iteration over {why} — the fold order is "
                            f"not pinned, so bitwise replay diverges; "
                            f"iterate sorted(...) "
                            f"(docs/determinism.md)")
            elif isinstance(n, ast.Call):
                # bare sum()/prod() and math.fsum fold in Python
                # iteration order; jnp.sum/np.sum reduce arrays and are
                # pinned by the runtime, not by iteration
                if isinstance(n.func, ast.Name):
                    term = n.func.id
                    if term not in ("sum", "prod"):
                        continue
                elif isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "fsum":
                    term = "fsum"
                else:
                    continue
                if not n.args:
                    continue
                arg = n.args[0]
                why = None
                if isinstance(arg, (ast.ListComp, ast.GeneratorExp,
                                    ast.SetComp)):
                    for gen in arg.generators:
                        why = _unordered_iter(gen.iter, order_names,
                                              pinned)
                        if why:
                            break
                else:
                    why = _unordered_iter(arg, order_names, pinned)
                if why:
                    fl.flag(func.path, n.lineno,
                            f"`{term}(...)` folds floats over {why} — "
                            f"unordered reduction in a bitwise-pinned "
                            f"path; sort the operands first "
                            f"(docs/determinism.md)")
    return fl.done()
