"""Interprocedural entropy-taint engine — the kf-det substrate (port of
``kungfu_tpu/analysis/taint.py``).

The port's entropy sources join the reference's: a ``torch`` global-RNG
draw with no ``generator=`` (``torch.rand``, ``randn``, ``randint``,
``randperm``, ``bernoulli``, ``multinomial``, ``normal``),
``torch.seed()`` / ``torch.cuda.seed()``, and a ``torch.Generator()``
that is never ``manual_seed``-ed: the constructor taints its binding
and ``g.manual_seed(s)`` replaces that taint with the seed's (strongly:
``manual_seed`` on both branches cleans, on one branch the union
keeps the other's), so a draw with ``generator=g`` carries whatever
seeded ``g``.  Sinks and sanitizers are the reference's, by terminal
name (:mod:`~kungfu_tpu_torch.analysis.detrules`).

Every recovery rung in this repo (shrink replay from a
``StepSnapshot``, ``ZeroBoundary`` recarve, kf-persist cold restart,
serve replay-from-committed, bandit lockstep installs) rests on one
invariant: re-executing from an agreed boundary is *bitwise
deterministic* and *cross-rank consistent*.  The ways that invariant
breaks are all *data-flow* facts — a wall-clock read, an unseeded RNG
draw, or an unordered-iteration artifact flows, possibly through
several calls and an f-string, into a consensus digest, a rendezvous
tag, or a persisted manifest record.  The existing
``collective-consistency`` heuristic only sees a divergent call
*syntactically inside* a name expression; ``x = time.time()`` two
functions upstream escapes it.  This module closes that gap with a
forward taint analysis over the shared project call graph
(:mod:`kungfu_tpu_torch.analysis.callgraph`) and parse cache
(:mod:`kungfu_tpu_torch.analysis.core`):

* **Sources** introduce taint: wall-clock reads (``time.time`` /
  ``monotonic`` / ``perf_counter`` and their ``_ns`` variants,
  ``datetime.now``), unseeded RNG (module-level ``random.*`` /
  ``np.random.*`` draws, ``default_rng()`` / ``Random()`` /
  ``RandomState()`` with no seed), ``uuid1``/``uuid4``,
  ``os.urandom`` / ``secrets`` tokens, process identity
  (``getpid``/``gethostname``/``getnode``), CPython object identity
  (``id()``), and — as a separate *order* kind — ``set`` /
  ``frozenset`` iteration order.  A rank read is deliberately NOT a
  source: rank is replay-stable, and rank-*divergent* collectives are
  ``collective-consistency``'s existing domain.
* **Propagation** is a flow-sensitive walk per function: assignments
  (incl. tuple unpack, ``self.attr``, augmented and walrus forms),
  f-strings, containers and comprehensions, BinOp/BoolOp arithmetic,
  subscripts, and calls — an unknown call propagates the union of its
  receiver-object and argument taints (``hashlib.blake2b(t).hexdigest()``
  stays tainted); ``if``/``else`` branches analyze on forked
  environments and merge by union, so a sanitizer on ONE branch never
  launders the other.
* **Interprocedural** flow uses per-function summaries (return taint +
  which params flow to the return) computed to fixpoint over the call
  graph, so a source two calls deep and a helper that formats its
  argument into a tag both carry taint to the caller — with the hop
  chain preserved for source→sink path reporting.
* **Sanitizers** terminate taint: a value returned by an agreement op
  (``consensus_bytes`` / ``broadcast_bytes`` / ``allgather_bytes`` /
  ``agree_manifest``) is the *agreed* value on every rank; ``sorted()``
  cancels order taint (not value taint); order-insensitive reductions
  (``len``/``min``/``max``) cancel order taint; ``chaos_rank()`` and
  declared launch knobs (``utils.envs`` reads) are replay-stable and
  never tainted to begin with.

What the engine deliberately does NOT do (precision over recall — the
kf-det rules gate tier-1 with an empty baseline, so a false finding is
a red build): ``self`` attribute taint stays within the method that
wrote it (``self._last_done_t = time.monotonic()`` in a checkpoint
writer must not condemn every other method of the class — local gauges
are sanctioned); dict iteration order is left to the
``reduction-order`` rule's pinned-path scopes (insertion order is
deterministic per run; only geometry-varying insertion is a hazard);
unresolved calls propagate their *arguments'* taint but never invent
new taint.

The rules themselves live in :mod:`kungfu_tpu_torch.analysis.detrules`; this
module knows nothing about sinks.  Like the call graph and the axis
environment, the engine is built once per root per process and
invalidated through the same cascade
(``core.clear_parse_cache`` → ``callgraph.invalidate_cache`` → here).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from kungfu_tpu_torch.analysis.callgraph import (
    CallGraph,
    CallSite,
    FuncInfo,
    _terminal_and_receiver,
    project_graph,
)

# ---------------------------------------------------------------------------
# taint values

#: taint kinds whose hazard is *iteration order*, not the value itself —
#: ``sorted()`` and order-insensitive reductions cancel exactly these
ORDER_KINDS = frozenset({"set-order"})


@dataclass(frozen=True)
class Taint:
    """One entropy source, with the interprocedural path it traveled."""

    kind: str  #: "time" | "rng" | "uuid" | "os-entropy" | "object-id" | "set-order"
    desc: str  #: source expression, e.g. "time.time()"
    path: str  #: repo-relative path of the source
    line: int
    #: interprocedural hops, source-first: "returned by _token() (x.py:8)"
    chain: Tuple[str, ...] = ()

    def via(self, hop: str) -> "Taint":
        if len(self.chain) >= 8:  # recursion guard; depth 8 is plenty
            return self
        return Taint(self.kind, self.desc, self.path, self.line,
                     self.chain + (hop,))

    def render(self) -> str:
        trail = "".join(f", {h}" for h in self.chain)
        return f"{self.desc} [{self.kind}] at {self.path}:{self.line}{trail}"


@dataclass(frozen=True)
class TV:
    """Abstract value: the taints it may carry + the formal params of the
    enclosing function it may alias (for summary building)."""

    taints: FrozenSet[Taint] = frozenset()
    params: FrozenSet[int] = frozenset()

    def __or__(self, other: "TV") -> "TV":
        if not other.taints and not other.params:
            return self
        if not self.taints and not self.params:
            return other
        return TV(self.taints | other.taints, self.params | other.params)

    def drop_order(self) -> "TV":
        if not any(t.kind in ORDER_KINDS for t in self.taints):
            return self
        return TV(frozenset(t for t in self.taints
                            if t.kind not in ORDER_KINDS), self.params)

    @property
    def tainted(self) -> bool:
        return bool(self.taints)


EMPTY = TV()


@dataclass(frozen=True)
class Summary:
    """What a call to this function contributes to the caller."""

    ret: FrozenSet[Taint] = frozenset()
    #: formal param indices whose taint flows into the return value
    param_flows: FrozenSet[int] = frozenset()


@dataclass
class CallRecord:
    """One call site with the abstract value of every argument at the
    point of the call — the raw material the sink rules consume."""

    node: ast.Call
    terminal: str
    receiver: Tuple[str, ...]
    line: int
    arg_tv: List[TV]
    kw_tv: Dict[str, TV]
    #: taint of the receiver *expression* (``obj`` in ``obj.m(...)``) —
    #: distinguishes a tainted payload calling .encode() from a tainted
    #: argument
    obj_tv: TV


@dataclass
class FuncResult:
    env: Dict[str, TV]
    calls: List[CallRecord] = field(default_factory=list)


# ---------------------------------------------------------------------------
# source / sanitizer tables (docs/determinism.md mirrors these)

_TIME_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns", "process_time"}
_DATETIME_FNS = {"now", "utcnow", "today"}
#: module-level draws on the process-global (OS-seeded) RNG state
_RNG_DRAWS = {"random", "randint", "randrange", "uniform", "normal",
              "choice", "choices", "shuffle", "sample", "getrandbits",
              "rand", "randn", "standard_normal", "permutation",
              "integers", "bytes"}
#: RNG constructors: entropy when called with NO seed argument
_RNG_CTORS = {"default_rng", "Random", "RandomState", "SystemRandom"}

#: torch draws on the process-global generator unless given
#: ``generator=`` (receiver ``torch``)
TORCH_RNG_DRAWS = frozenset({"rand", "randn", "randint", "randperm",
                             "bernoulli", "multinomial", "normal"})
#: torch calls that draw a non-deterministic seed
_TORCH_SEEDS = frozenset({"seed", "seed_all"})
#: seeders of a torch generator: their result (and the generator they
#: seed) carries the seed's taint, nothing else
TORCH_SEEDERS = frozenset({"manual_seed", "manual_seed_all"})
_UUID_FNS = {"uuid1", "uuid4"}
_OS_ENTROPY_FNS = {"urandom", "getpid", "getppid", "gethostname",
                   "getnode", "token_hex", "token_bytes"}

#: receiver chains that denote the stdlib/numpy RNG module (``random.``,
#: ``np.random.``) — NOT jax.random, whose draws are keyed and pure
_RNG_MODULES = {("random",), ("np", "random"), ("numpy", "random")}

#: ops whose *result* is the agreed value on every rank — taint dies here
AGREEMENT_OPS = frozenset({"consensus_bytes", "broadcast_bytes",
                           "allgather_bytes", "agree_manifest"})

#: calls whose result is insensitive to input *order* (value taint of the
#: inputs still flows; ``sum`` is deliberately absent — float accumulation
#: order is exactly the reduction-order hazard)
_ORDER_INSENSITIVE = frozenset({"sorted", "len", "min", "max"})

#: replay-stable identity reads — sanctioned, never sources
_STABLE_CALLS = frozenset({"chaos_rank"})

#: in-place container mutators: ``parts.append(tainted)`` taints the
#: container binding itself (weak update)
_MUTATORS = frozenset({"append", "add", "extend", "insert", "update",
                       "setdefault", "appendleft", "push"})


def _source_taint(terminal: str, receiver: Tuple[str, ...],
                  node: ast.Call, path: str) -> Optional[Taint]:
    """The taint a call introduces by itself, if any."""
    def t(kind: str, desc: str) -> Taint:
        return Taint(kind, desc, path, node.lineno)

    recv_mod = receiver[-1] if receiver else ""
    if terminal in _TIME_FNS and (not receiver or recv_mod == "time"):
        return t("time", f"time.{terminal}()")
    if terminal in _DATETIME_FNS and recv_mod in ("datetime", "date"):
        return t("time", f"datetime.{terminal}()")
    if terminal in _RNG_DRAWS and tuple(receiver[-2:]) in _RNG_MODULES:
        return t("rng", f"{'.'.join(receiver)}.{terminal}() "
                        f"(process-global RNG)")
    if terminal in _RNG_CTORS and not node.args and not node.keywords:
        return t("rng", f"{terminal}() with no seed (OS entropy)")
    if receiver[:1] == ("torch",):
        if terminal in TORCH_RNG_DRAWS and receiver == ("torch",) and not any(
                kw.arg == "generator" for kw in node.keywords):
            return t("rng", f"torch.{terminal}() (process-global RNG)")
        if terminal in _TORCH_SEEDS and receiver in (("torch",),
                                                      ("torch", "cuda")):
            return t("rng", f"{'.'.join(receiver)}.{terminal}() "
                            f"(non-deterministic seed)")
        if terminal == "Generator":
            return t("rng", "torch.Generator() never manual_seed-ed")
    if terminal in _UUID_FNS:
        return t("uuid", f"{terminal}()")
    if terminal in _OS_ENTROPY_FNS:
        return t("os-entropy", f"{terminal}()")
    if terminal == "id" and not receiver:
        return t("object-id", "id() (CPython address)")
    return None


# ---------------------------------------------------------------------------
# per-function abstract interpretation

class _FuncWalk:
    """One flow-sensitive walk of a function body.

    ``record=True`` (the final pass) additionally captures a
    :class:`CallRecord` per call site for the sink rules.
    """

    def __init__(self, engine: "TaintEngine", func: FuncInfo,
                 record: bool = False):
        self.eng = engine
        self.func = func
        self.record = record
        self.calls: List[CallRecord] = []
        self.ret = EMPTY

    # -- statements ------------------------------------------------------

    def run(self) -> Dict[str, TV]:
        env: Dict[str, TV] = {}
        node = self.func.node
        args = getattr(node, "args", None)
        if args is not None:
            formals = [a.arg for a in
                       args.posonlyargs + args.args + args.kwonlyargs]
            for i, name in enumerate(formals):
                env[name] = TV(params=frozenset({i}))
        self._stmts(node.body, env)
        return env

    def _stmts(self, body: List[ast.stmt], env: Dict[str, TV]) -> None:
        for stmt in body:
            self._stmt(stmt, env)

    def _stmt(self, stmt: ast.stmt, env: Dict[str, TV]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested scopes have their own FuncInfo / walk
        if isinstance(stmt, ast.Assign):
            tv = self._eval(stmt.value, env)
            for tgt in stmt.targets:
                self._bind(tgt, tv, env)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self._eval(stmt.value, env), env)
        elif isinstance(stmt, ast.AugAssign):
            tv = self._eval(stmt.value, env)
            key = self._target_key(stmt.target)
            if key is not None:
                env[key] = env.get(key, EMPTY) | tv
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.ret = self.ret | self._eval(stmt.value, env)
        elif isinstance(stmt, ast.If):
            self._eval(stmt.test, env)
            env_b = dict(env)
            self._stmts(stmt.body, env_b)
            env_o = dict(env)
            self._stmts(stmt.orelse, env_o)
            # union merge: a sanitizer on one branch must not launder
            # the taint the other branch keeps
            for k in set(env_b) | set(env_o):
                env[k] = env_b.get(k, EMPTY) | env_o.get(k, EMPTY)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            iter_tv = self._eval(stmt.iter, env)
            self._bind(stmt.target, iter_tv, env)
            # two passes for loop-carried bindings; record only once
            rec, self.record = self.record, False
            self._stmts(stmt.body, dict(env))
            self.record = rec
            self._bind(stmt.target, self._eval_quiet(stmt.iter, env), env)
            self._stmts(stmt.body, env)
            self._stmts(stmt.orelse, env)
        elif isinstance(stmt, ast.While):
            self._eval(stmt.test, env)
            rec, self.record = self.record, False
            self._stmts(stmt.body, dict(env))
            self.record = rec
            self._stmts(stmt.body, env)
            self._stmts(stmt.orelse, env)
        elif isinstance(stmt, ast.With) or isinstance(stmt, ast.AsyncWith):
            for item in stmt.items:
                tv = self._eval(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, tv, env)
            self._stmts(stmt.body, env)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body, env)
            for h in stmt.handlers:
                self._stmts(h.body, env)
            self._stmts(stmt.orelse, env)
            self._stmts(stmt.finalbody, env)
        elif isinstance(stmt, ast.Expr):
            self._eval(stmt.value, env)
        elif isinstance(stmt, (ast.Assert, ast.Raise)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._eval(child, env)
        # Pass/Import/Global/Nonlocal/Delete/Break/Continue: no flow

    def _bind(self, target: ast.expr, tv: TV, env: Dict[str, TV]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tv, env)
            return
        if isinstance(target, ast.Starred):
            self._bind(target.value, tv, env)
            return
        if isinstance(target, ast.Subscript):
            # d["k"] = tainted taints the container (weak update — a
            # later clean store must not launder the tainted element)
            key = self._target_key(target.value)
            if key is not None:
                env[key] = env.get(key, EMPTY) | tv
            return
        key = self._target_key(target)
        if key is not None:
            env[key] = tv

    @staticmethod
    def _target_key(target: ast.expr) -> Optional[str]:
        """Name -> "x"; dotted Name/Attribute chain -> "self.x"; else None
        (subscript stores keep the container's existing binding)."""
        if isinstance(target, ast.Name):
            return target.id
        if isinstance(target, ast.Attribute):
            chain: List[str] = []
            n: ast.expr = target
            while isinstance(n, ast.Attribute):
                chain.append(n.attr)
                n = n.value
            if isinstance(n, ast.Name):
                chain.append(n.id)
                return ".".join(reversed(chain))
        return None

    # -- expressions -----------------------------------------------------

    def _eval_quiet(self, node: ast.expr, env: Dict[str, TV]) -> TV:
        rec, self.record = self.record, False
        try:
            return self._eval(node, env)
        finally:
            self.record = rec

    def _eval(self, node: ast.expr, env: Dict[str, TV]) -> TV:  # noqa: C901
        if isinstance(node, ast.Name):
            return env.get(node.id, EMPTY)
        if isinstance(node, ast.Constant):
            return EMPTY
        if isinstance(node, ast.Attribute):
            key = self._target_key(node)
            if key is not None and key in env:
                return env[key]
            return self._eval(node.value, env)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env)
        if isinstance(node, ast.JoinedStr):
            tv = EMPTY
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    tv = tv | self._eval(v.value, env)
            return tv
        if isinstance(node, ast.FormattedValue):
            return self._eval(node.value, env)
        if isinstance(node, (ast.Set,)):
            tv = EMPTY
            for elt in node.elts:
                tv = tv | self._eval(elt, env)
            return tv | TV(taints=frozenset({Taint(
                "set-order", "set literal iteration order",
                self.func.path, node.lineno)}))
        if isinstance(node, (ast.List, ast.Tuple)):
            tv = EMPTY
            for elt in node.elts:
                tv = tv | self._eval(elt, env)
            return tv
        if isinstance(node, ast.Dict):
            tv = EMPTY
            for k in node.keys:
                if k is not None:
                    tv = tv | self._eval(k, env)
            for v in node.values:
                tv = tv | self._eval(v, env)
            return tv
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            tv = self._comp(node.generators, [node.elt], env)
            if isinstance(node, ast.SetComp):
                tv = tv | TV(taints=frozenset({Taint(
                    "set-order", "set comprehension iteration order",
                    self.func.path, node.lineno)}))
            return tv
        if isinstance(node, ast.DictComp):
            return self._comp(node.generators, [node.key, node.value], env)
        if isinstance(node, ast.BinOp):
            return self._eval(node.left, env) | self._eval(node.right, env)
        if isinstance(node, ast.BoolOp):
            tv = EMPTY
            for v in node.values:
                tv = tv | self._eval(v, env)
            return tv
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand, env)
        if isinstance(node, ast.Compare):
            tv = self._eval(node.left, env)
            for c in node.comparators:
                tv = tv | self._eval(c, env)
            # a membership/equality result is order-insensitive
            return tv.drop_order()
        if isinstance(node, ast.IfExp):
            self._eval(node.test, env)
            return self._eval(node.body, env) | self._eval(node.orelse, env)
        if isinstance(node, ast.Subscript):
            return self._eval(node.value, env) | self._eval(node.slice, env)
        if isinstance(node, ast.Slice):
            tv = EMPTY
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    tv = tv | self._eval(part, env)
            return tv
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env)
        if isinstance(node, ast.Await):
            return self._eval(node.value, env)
        if isinstance(node, ast.NamedExpr):
            tv = self._eval(node.value, env)
            self._bind(node.target, tv, env)
            return tv
        if isinstance(node, ast.Lambda):
            return EMPTY
        return EMPTY

    def _comp(self, generators, elts, env: Dict[str, TV]) -> TV:
        scope = dict(env)
        tv = EMPTY
        for gen in generators:
            iter_tv = self._eval(gen.iter, scope)
            tv = tv | iter_tv
            self._bind(gen.target, iter_tv, scope)
            for cond in gen.ifs:
                self._eval(cond, scope)
        for elt in elts:
            tv = tv | self._eval(elt, scope)
        return tv

    # -- calls -----------------------------------------------------------

    def _eval_call(self, node: ast.Call, env: Dict[str, TV]) -> TV:
        terminal, receiver = _terminal_and_receiver(node.func)
        obj_tv = EMPTY
        if isinstance(node.func, ast.Attribute):
            obj_tv = self._eval(node.func.value, env)
        arg_tv = [self._eval(a.value if isinstance(a, ast.Starred) else a,
                             env) for a in node.args]
        kw_tv = {kw.arg: self._eval(kw.value, env)
                 for kw in node.keywords if kw.arg is not None}
        for kw in node.keywords:  # **kwargs splat
            if kw.arg is None:
                obj_tv = obj_tv | self._eval(kw.value, env)

        if self.record and terminal is not None:
            self.calls.append(CallRecord(
                node=node, terminal=terminal, receiver=receiver,
                line=node.lineno, arg_tv=arg_tv, kw_tv=kw_tv,
                obj_tv=obj_tv))

        if terminal in _MUTATORS and receiver:
            arg_union = EMPTY
            for t in arg_tv:
                arg_union = arg_union | t
            for t in kw_tv.values():
                arg_union = arg_union | t
            if arg_union.tainted or arg_union.params:
                key = ".".join(receiver)
                env[key] = env.get(key, EMPTY) | arg_union

        if terminal is None:
            tv = obj_tv
            for t in arg_tv:
                tv = tv | t
            for t in kw_tv.values():
                tv = tv | t
            return tv

        if terminal in TORCH_SEEDERS:
            # g.manual_seed(s) reseeds g: g (and the generator returned)
            # carry the seed's taint only
            seed = kw_tv.get("seed") or (arg_tv[0] if arg_tv else EMPTY)
            if receiver and receiver[0] != "torch":
                env[".".join(receiver)] = seed
            return seed

        # sources / sanitizers first — they beat generic propagation
        src = _source_taint(terminal, receiver, node, self.func.path)
        if src is not None:
            return TV(taints=frozenset({src}))
        if terminal in AGREEMENT_OPS:
            return EMPTY  # the result IS the agreed value
        if terminal in _STABLE_CALLS:
            return EMPTY
        combined = obj_tv
        for t in arg_tv:
            combined = combined | t
        for t in kw_tv.values():
            combined = combined | t
        if terminal in _ORDER_INSENSITIVE:
            return combined.drop_order()
        if terminal in ("set", "frozenset") and not receiver:
            return combined | TV(taints=frozenset({Taint(
                "set-order", f"{terminal}() iteration order",
                self.func.path, node.lineno)}))

        # project-resolved call: use the callee summary (precise) instead
        # of blanket arg propagation
        site = CallSite(callee=terminal, node=node, line=node.lineno,
                        receiver=receiver, branches=())
        cands = self.eng.graph.resolve(self.func, site)
        if cands:
            tv = EMPTY
            for cand in cands:
                summ = self.eng.summary(cand)
                hop = (f"returned through {cand.name}() "
                       f"({cand.path}:{cand.lineno})")
                tv = tv | TV(taints=frozenset(
                    t.via(hop) for t in summ.ret))
                for i in summ.param_flows:
                    atv = self._arg_for_param(cand, i, node, arg_tv, kw_tv)
                    if atv is not None:
                        tv = tv | atv
            return tv

        # unknown call: taint in, taint out
        return combined

    @staticmethod
    def _arg_for_param(cand: FuncInfo, index: int, node: ast.Call,
                       arg_tv: List[TV],
                       kw_tv: Dict[str, TV]) -> Optional[TV]:
        """Map a callee formal index back to this call's argument TV."""
        args = getattr(cand.node, "args", None)
        if args is None:
            return None
        formals = [a.arg for a in
                   args.posonlyargs + args.args + args.kwonlyargs]
        if index >= len(formals):
            return None
        name = formals[index]
        if name in kw_tv:
            return kw_tv[name]
        pos = index
        if cand.cls is not None and formals and formals[0] in ("self", "cls"):
            pos = index - 1  # bound-method call: args exclude self
        if 0 <= pos < len(arg_tv):
            return arg_tv[pos]
        return None


# ---------------------------------------------------------------------------
# the engine

class TaintEngine:
    """Demand-driven summaries: each function is walked exactly once.

    ``summary(f)`` memoizes; a walk that needs a callee's summary
    recurses depth-first, so a source K calls deep resolves in the one
    pass (the transitive chain is computed bottom-up).  Mutual
    recursion is the only approximation: the back edge of a cycle reads
    an empty summary (taint through recursive self-calls is not
    tracked — none of the tree's protocol helpers recurse)."""

    def __init__(self, root: str):
        self.root = root
        self.graph: CallGraph = project_graph(root)
        self._summaries: Dict[int, Summary] = {}
        self._results: Dict[int, FuncResult] = {}
        self._in_flight: set = set()

    def summary(self, func: FuncInfo) -> Summary:
        fid = id(func)
        summ = self._summaries.get(fid)
        if summ is None:
            if fid in self._in_flight:
                return Summary()  # recursion back edge
            self._analyze(func)
            summ = self._summaries[fid]
        return summ

    def result_of(self, func: FuncInfo) -> FuncResult:
        fid = id(func)
        res = self._results.get(fid)
        if res is None:
            self._analyze(func)
            res = self._results[fid]
        return res

    def _analyze(self, func: FuncInfo) -> None:
        fid = id(func)
        self._in_flight.add(fid)
        try:
            walk = _FuncWalk(self, func, record=True)
            env = walk.run()
        finally:
            self._in_flight.discard(fid)
        self._summaries[fid] = Summary(ret=walk.ret.taints,
                                       param_flows=walk.ret.params)
        self._results[fid] = FuncResult(env=env, calls=walk.calls)


_ENGINE_CACHE: Dict[str, TaintEngine] = {}


def taint_engine(root: str) -> TaintEngine:
    """Build (or reuse) the engine for ``root`` — all three kf-det rules
    run over one tree in one CLI pass, so one build serves all."""
    key = os.path.abspath(root)
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = _ENGINE_CACHE[key] = TaintEngine(key)
    return eng


def invalidate_cache() -> None:
    """Cascaded from ``callgraph.invalidate_cache`` — the engine is
    derived from the call graph and goes stale with it."""
    _ENGINE_CACHE.clear()
