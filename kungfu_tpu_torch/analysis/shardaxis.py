"""shard-axis checker: every collective's axis name must be bound
(port of ``kungfu_tpu/analysis/shardaxis.py``).

The port's collectives are the rank-world wrappers of
``ops/collective.py`` (``all_reduce``, ``group_all_reduce``,
``all_gather``, ``broadcast``, ``barrier_value``, ``peer_rank``,
``peer_size``, ``axis_index``, ``ppermute``, ``all_to_all``),
``ops/schedules.py all_reduce_scheduled``, the ring collectives of
``ops/collectives.py`` and the ``Communicator`` methods of
``comm/device.py``.  Their vocabulary is every axis a rank world
declares (``Mesh.world()``, ``Communicator.world()``, a literal
``rank_world([...])``), and a call inside ``with <world>:`` is checked
against that world alone (:mod:`~kungfu_tpu_torch.analysis.axisenv`).
The jax primitives and wrappers below are kept for jax code.

A ``psum``/``ppermute``/``axis_index`` over a mesh-axis name that is
not bound where the code runs does not fail in review, in unit tests on
one device, or even on a small mesh that happens to bind the name — it
fails at trace time on the pod, or worse, silently reduces over the
wrong axis group (the dominant sharding-bug class of the multislice /
ZeRO arc; cf. arXiv:2004.13336, arXiv:1909.09756).  Built on the
:mod:`~kungfu_tpu_torch.analysis.axisenv` abstract interpretation, two layers:

* **vocabulary** — a literal axis name (string constant, or a constant
  resolving through the project constant table: ``AXIS_TP``,
  ``GLOBAL_AXES``, ...) passed to any collective — the ``jax.lax``
  primitives AND the project wrappers in ``ops/`` / ``comm/device.py``
  (and the reference's ``utils/jaxcompat.py``) —
  must be an axis some ``Mesh``/``pmap`` in the tree declares.  A
  one-token typo (``"tq"`` for ``"tp"``) is caught anywhere, even in a
  helper whose calling context is unknown.
* **environment** — where the function's axis environment is statically
  known (it is a ``shard_map``/``pmap`` body with a resolved mesh, or
  reached only from such bodies through the call graph), the axis must
  be bound in EVERY context the function can run under.  Contexts are
  per-path, so a helper called from two meshes with different axis sets
  is checked against each — an axis valid under mesh A is still flagged
  for the mesh-B path.  Unresolved meshes yield *open* contexts, which
  never prove absence: indirection loses recall, not precision.

String arguments that are reduce-op names (``"sum"``, ``"mean"``, ...)
are never axis names and are skipped — ``Communicator.all_reduce(x,
"max")`` shares a terminal name with the axis-taking ops wrapper.
Axis-parameter *defaults* (``def ring_attention(..., axis="sp")``) are
checked against the vocabulary only (each caller supplies the context).
Suppress a deliberate exception with ``# kflint: allow(shard-axis)``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from kungfu_tpu_torch.analysis.axisenv import axis_environment
from kungfu_tpu_torch.analysis.core import (
    Violation,
    parse_module,
    suppressed,
)

CHECKER = "shard-axis"

#: collective terminal name -> (positional axis-arg index, kwarg names).
#: Covers the jax.lax primitives and the project wrappers (ops/,
#: comm/device.py, utils/jaxcompat.py).  Values that evaluate to ints
#: (lax.all_gather's ``axis=0`` DIMENSION kwarg, Communicator.broadcast's
#: ``root``) are ignored — only string-valued arguments are axis names.
AXIS_ARGS: Dict[str, Tuple[int, Tuple[str, ...]]] = {
    # jax.lax primitives
    "psum": (1, ("axis_name",)),
    "pmean": (1, ("axis_name",)),
    "pmax": (1, ("axis_name",)),
    "pmin": (1, ("axis_name",)),
    "psum_scatter": (1, ("axis_name",)),
    "ppermute": (1, ("axis_name", "axis")),
    "pshuffle": (1, ("axis_name",)),
    "pbroadcast": (1, ("axis_name",)),
    "all_to_all": (1, ("axis_name", "axis")),
    "axis_index": (0, ("axis_name", "axis")),
    "axis_size": (0, ("axis_name",)),
    "all_gather": (1, ("axis_name", "axis")),
    # project wrappers (ops/collective.py, ops/schedules.py; the
    # reference's utils/jaxcompat.py)
    "all_reduce": (1, ("axis",)),
    "group_all_reduce": (1, ("axis",)),
    "all_reduce_scheduled": (1, ("axis",)),
    "broadcast": (1, ("axis",)),
    "barrier_value": (0, ("axis",)),
    "peer_rank": (0, ("axis",)),
    "peer_size": (0, ("axis",)),
    "pcast_varying": (1, ("axes",)),
    # the Pallas ICI ring collectives (ops/pallas/collectives.py): the
    # axis name threads through pallas_call kernels under shard_map —
    # a typo'd literal here fails at trace time on the pod exactly like
    # a lax primitive's would
    "ring_reduce_scatter": (1, ("axis",)),
    "ring_all_gather": (1, ("axis",)),
    "ring_all_reduce": (1, ("axis",)),
}

#: strings that are reduce-op selectors sharing call slots with axis
#: names — never axis names
_OP_NAMES = {"sum", "mean", "min", "max", "prod"}

#: the analysis suite itself names axes in its tables
_SKIP_PREFIXES = ("kungfu_tpu_torch/analysis/",)

#: parameter names whose string default is an axis name
_AXIS_PARAMS = {"axis", "axis_name", "axes"}


def _axis_exprs(site) -> List[ast.AST]:
    """Every argument that may carry the axis name.  all_gather takes
    BOTH an `axis_name` and an int `axis` DIMENSION kwarg — first-match
    would let `axis=0` shadow a typo'd positional name, so all
    candidates are checked (non-string values skip themselves)."""
    pos, kwargs = AXIS_ARGS[site.callee]
    out = [kw.value for kw in site.node.keywords if kw.arg in kwargs]
    if len(site.node.args) > pos:
        out.append(site.node.args[pos])
    return out


def check(root: str) -> List[Violation]:
    import os

    env = axis_environment(root)
    out: List[Violation] = []
    supp_cache: Dict[str, Dict[int, set]] = {}

    def flag(path: str, line: int, msg: str) -> None:
        if path not in supp_cache:
            supp_cache[path] = parse_module(os.path.join(root, path)).supp
        if not suppressed(supp_cache[path], line, CHECKER):
            out.append(Violation(CHECKER, path, line, msg))

    vocab = env.vocabulary

    def check_axes(func, node, line: int, callee: str,
                   axes: Tuple[str, ...]) -> None:
        for a in axes:
            if a in _OP_NAMES:
                continue
            if a not in vocab:
                flag(func.path, line,
                     f"collective `{callee}` names axis {a!r}, which no "
                     f"Mesh/pmap in the tree declares (known axes: "
                     f"{sorted(vocab)}) — this fails at trace time on "
                     f"the pod")
                continue
            for ctx, prov in env.contexts_at(func, node).items():
                if not ctx.open and a not in ctx.axes:
                    flag(func.path, line,
                         f"collective `{callee}` uses axis {a!r}, not "
                         f"bound in the axis environment "
                         f"{{{', '.join(sorted(ctx.axes)) or ''}}} this "
                         f"code runs under (entered via {prov})")
                    break

    for func in env.graph.functions:
        if any(func.path.startswith(p) for p in _SKIP_PREFIXES):
            continue
        # collective call sites
        for site in func.calls:
            if site.callee not in AXIS_ARGS:
                continue
            for expr in _axis_exprs(site):
                axes = env.axis_strings(func, expr)
                if not axes:
                    continue  # dynamic / non-string: callers carry it
                check_axes(func, site.node, site.line, site.callee, axes)
        # axis-parameter string defaults (vocabulary layer only)
        a = func.node.args
        params = list(a.posonlyargs) + list(a.args)
        defaults = list(a.defaults)
        for p, d in zip(params[len(params) - len(defaults):], defaults):
            if p.arg not in _AXIS_PARAMS:
                continue
            axes = env.axis_strings(func, d)
            if not axes:
                continue
            for ax in axes:
                if ax not in vocab and ax not in _OP_NAMES:
                    flag(func.path, d.lineno,
                         f"default axis {ax!r} of `{func.name}({p.arg}=...)`"
                         f" is not declared by any Mesh/pmap in the tree "
                         f"(known axes: {sorted(vocab)})")

    return sorted(out, key=lambda v: (v.path, v.line))
