"""Pipeline parallelism over the host plane: 1F1B microbatch schedules
driven by async collective handles, with elastic stage re-carving.

Port of ``kungfu_tpu/parallel/pp.py``.  The in-mesh pipeline
(:class:`~kungfu_tpu_torch.parallel.train.ShardedTrainer`) hops stages
inside one lockstep world of co-resident ranks; this module is the
cross-host pipeline axis, where each slice is its own process world:

* **stages** — contiguous layer ranges of the flagship transformer
  (:func:`stage_partition`); stage 0 owns the embedding, the last stage
  owns ``ln_f`` + the LM head and computes the loss
  (:class:`StageModule`);
* **activation hops** — point-to-point sends/recvs on the collective
  engine's async plane (:meth:`~kungfu_tpu_torch.comm.engine.
  CollectiveEngine.send_async` / ``recv_async``), each a
  :class:`~kungfu_tpu_torch.comm.engine.CollectiveHandle` whose tag is
  fixed at issue time; the prefetched recv hides the wire latency under
  stage compute;
* **schedule** — :func:`schedule_1f1b`, :func:`schedule_interleaved`
  (``v`` non-adjacent layer chunks a stage, ordered by a greedy
  dependency simulation) and :func:`schedule_sequential` (the naive
  baseline);
* **ZeRO composition** — a stage's gradients reduce-scatter over its dp
  group in buckets issued as async handles the moment its last backward
  retires, so the pipeline drain hides the dp wire; the sum runs in
  dp-member order, so the composition stays bitwise against the
  replicated :func:`reference_pipeline_step`;
* **elastic re-carve** — :class:`StageBoundary` commits the stage's
  params + ZeRO-2 optimizer chunks at the step boundary and mirrors them
  one stage back in the same dp lane (``stride = dp`` ranks: one slice
  back), so a whole dead slice's stage survives on its predecessor; the
  survivors re-balance layers over the remaining stages by the pure
  :func:`stage_recarve_plan` (recovery-ladder rung 10,
  :mod:`kungfu_tpu_torch.elastic.shrink`).

Where the port differs from the reference:

* a stage runs on a torch device (``device=``, default ``cuda``; the
  tests pass ``"cpu"``); its backward is a recompute: the stage re-runs
  under ``torch.enable_grad()`` on detached leaves and
  ``torch.autograd.grad`` gives ``(dparams, dx)``, so no graph is kept
  between a microbatch's F and its B (the 1F1B memory contract);
* attention is :func:`~kungfu_tpu_torch.models.transformer.
  pick_attention` (the flash kernels on the card), as
  ``Transformer.hidden`` takes it; the reference's stage hard-codes the
  plain softmax (ROADMAP C22).  Under ``KF_TPU_ATTN=xla`` the two are
  the same math;
* ``tp > 1`` holds a stage's layer shards stacked ``[tp, ...]`` on the
  stage's one device inside a :func:`~kungfu_tpu_torch.ops.collective.
  rank_world` of its own (co-resident ranks, as ``ShardedTrainer``
  holds them); the edge params (embedding, ``ln_f``, head) stay whole.
  Its gradient is the true one, equal to ``tp == 1``'s within rounding;
  the reference's ``shard_map`` with ``check_vma=False`` gives the
  sharded weights ``1/tp`` of theirs (ROADMAP C23);
* activations and their gradients cross the wire as CPU tensors in the
  compute dtype (bf16 as its 16-bit patterns); dp gradient buckets and
  parameter chunks as f32 numpy arrays, as the reference's;
* :func:`stage_param_shapes` gives ``meta`` tensors (jax's
  ``ShapeDtypeStruct`` has no counterpart); every flat layout walks the
  leaves in the sorted-key order of :func:`~kungfu_tpu_torch.utils.tree.
  tree_flatten_with_path`, as jax does, so the segment plans and the
  boundary blobs are the reference's;
* :meth:`StageBoundary.replicate_ring` returns the bytes it sent, as the
  port's ``ZeroBoundary.replicate_ring`` does, and
  :attr:`StageBoundary.last_recarve` records the last re-carve's seconds
  and bytes sent; :func:`pipeline_gradients` gives the gradient a step
  applies.
"""

from __future__ import annotations

import io
import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.models.transformer import Transformer, _rope, pick_attention
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.ops.xent import token_nll
from kungfu_tpu_torch.optimizers._transform import apply_updates, sgd
from kungfu_tpu_torch.parallel import tp as tpmod
from kungfu_tpu_torch.parallel.mesh import MeshPlan
from kungfu_tpu_torch.utils.device import resolve_device
from kungfu_tpu_torch.utils.log import get_logger
from kungfu_tpu_torch.utils.tree import (num_leaves, tree_flatten,
                                         tree_flatten_with_path, tree_leaves,
                                         tree_map, tree_unflatten)

_log = get_logger("pp")

#: schedule vocabulary (KF_PP_SCHEDULE / ParallelPlan.pp_schedule)
SCHEDULES = ("1f1b", "interleaved", "sequential")

#: outstanding async p2p handles the pipeline keeps in flight; must stay
#: below the engine async pool (8 workers) or queued sends could starve
#: behind blocked recvs (see CollectiveEngine.recv_async)
_MAX_INFLIGHT_SENDS = 4
_PREFETCH = 2


# -- pure stage / schedule math --------------------------------------------


def stage_partition(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` layer range per stage, balanced with the
    remainder spread over the EARLIEST stages (they do not carry the
    LM-head loss work).  Pure and deterministic — every rank computes
    the identical map, like ``reshard_plan``."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers < n_stages:
        raise ValueError(
            f"{n_layers} layers cannot fill {n_stages} stages "
            "(a stage with no layers would forward its input unchanged "
            "— shrink the stage count instead)")
    base, rem = divmod(n_layers, n_stages)
    out, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def interleaved_partition(n_layers: int, n_stages: int,
                          v: int) -> List[List[Tuple[int, int]]]:
    """Layer ranges for the interleaved schedule: ``n_stages * v``
    contiguous groups; stage ``s`` owns groups ``[s, s + S, s + 2S, …]``
    (chunk ``c`` of stage ``s`` is virtual stage ``c * S + s``).
    Returns ``[stage][chunk] -> (lo, hi)``."""
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    groups = stage_partition(n_layers, n_stages * v)
    return [[groups[c * n_stages + s] for c in range(v)]
            for s in range(n_stages)]


def schedule_1f1b(n_micro: int, n_stages: int, stage: int
                  ) -> List[Tuple[str, int, int]]:
    """The classic one-forward-one-backward op list for ``stage``:
    ``[(kind, microbatch, chunk=0)]`` with kinds ``"F"``/``"B"``.
    Warmup ``min(S - 1 - stage, m)`` forwards, steady-state F/B pairs,
    backward drain.  Backwards retire in microbatch order on every
    stage — the property that keeps gradient accumulation bitwise
    against the sequential reference."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} outside {n_stages} stages")
    warm = min(n_stages - 1 - stage, n_micro)
    ops: List[Tuple[str, int, int]] = []
    for m in range(warm):
        ops.append(("F", m, 0))
    for k in range(n_micro - warm):
        ops.append(("F", warm + k, 0))
        ops.append(("B", k, 0))
    for m in range(n_micro - warm, n_micro):
        ops.append(("B", m, 0))
    return ops


def schedule_sequential(n_micro: int, n_stages: int, stage: int
                        ) -> List[Tuple[str, int, int]]:
    """Naive sequential microbatching — each microbatch runs its full
    forward AND backward through the whole pipe before the next starts,
    so every DCN hop sits on the critical path.  The baseline the
    ``bench.py --pp`` gate measures 1F1B against."""
    del n_stages, stage
    ops: List[Tuple[str, int, int]] = []
    for m in range(n_micro):
        ops.append(("F", m, 0))
        ops.append(("B", m, 0))
    return ops


def schedule_interleaved(n_micro: int, n_stages: int, stage: int,
                         v: int) -> List[Tuple[str, int, int]]:
    """Interleaved (virtual-stage) schedule: stage ``s`` executes ops
    for its ``v`` chunks, ordered by a greedy global simulation of the
    ``S*v``-virtual-stage dependency DAG (each physical stage runs one
    ready op per tick, preferring backwards — the 1F1B shape emerges).
    Simulated, not formula'd: the op order is then consistent with a
    valid global schedule by construction, so the blocking recvs of a
    real run can never deadlock, for any ``(m, S, v)``."""
    if v == 1:
        return schedule_1f1b(n_micro, n_stages, stage)
    V = n_stages * v
    f_done = [[False] * n_micro for _ in range(V)]
    b_done = [[False] * n_micro for _ in range(V)]
    per_stage: List[List[Tuple[str, int, int]]] = [
        [] for _ in range(n_stages)]
    remaining = 2 * V * n_micro

    def ready(phys: int):
        """Best ready op for a physical stage: prefer B (drain memory),
        then the lowest (chunk, microbatch) F — deterministic.  Both
        kinds advance strictly in microbatch order per chunk, so
        gradient accumulation order matches the sequential reference
        (the bitwise contract)."""
        best = None
        for c in range(v):
            vs = c * n_stages + phys
            mb_b = next((m for m in range(n_micro)
                         if not b_done[vs][m]), None)
            if mb_b is not None and f_done[vs][mb_b] and (
                    vs == V - 1 or b_done[vs + 1][mb_b]):
                return ("B", mb_b, c)
            if best is None:
                mb_f = next((m for m in range(n_micro)
                             if not f_done[vs][m]), None)
                if mb_f is not None and (
                        vs == 0 or f_done[vs - 1][mb_f]):
                    best = ("F", mb_f, c)
        return best

    while remaining:
        progressed = False
        for phys in range(n_stages):
            op = ready(phys)
            if op is None:
                continue
            kind, m, c = op
            vs = c * n_stages + phys
            (f_done if kind == "F" else b_done)[vs][m] = True
            per_stage[phys].append(op)
            remaining -= 1
            progressed = True
        if not progressed:  # pragma: no cover - the DAG always has a root
            raise AssertionError("interleaved schedule wedged")
    return per_stage[stage]


def build_schedule(name: str, n_micro: int, n_stages: int, stage: int,
                   v: int = 1) -> List[Tuple[str, int, int]]:
    if name not in SCHEDULES:
        raise ValueError(f"unknown pp schedule {name!r}; one of {SCHEDULES}")
    if name == "interleaved":
        return schedule_interleaved(n_micro, n_stages, stage, v)
    if name == "sequential":
        return schedule_sequential(n_micro, n_stages, stage)
    if v != 1:
        raise ValueError("interleave > 1 requires the interleaved schedule")
    return schedule_1f1b(n_micro, n_stages, stage)


# -- pure re-carve planning -------------------------------------------------
#: pseudo-layer ids for the edge-owned params in recarve plans
_UNIT_EMBED = -1
_UNIT_FINAL = -2


def stage_recarve_plan(n_layers: int, old_n: int, new_n: int
                       ) -> List[Tuple[int, int, int]]:
    """Pure unit-move plan for an ``old_n -> new_n`` stage re-balance:
    ``[(unit, old_stage, new_stage)]`` where unit is a layer index, or
    ``-1`` (embedding block, stage 0's) / ``-2`` (ln_f + head, the last
    stage's).  Every rank computes the identical plan — the
    ``reshard_plan`` pattern at stage granularity.  Units whose owner
    does not change are omitted only when old and new stage indices
    AND maps coincide; callers move exactly what the plan lists."""
    old_map = stage_partition(n_layers, old_n)
    new_map = stage_partition(n_layers, new_n)

    def old_owner(layer: int) -> int:
        for s, (lo, hi) in enumerate(old_map):
            if lo <= layer < hi:
                return s
        raise AssertionError(layer)

    def new_owner(layer: int) -> int:
        for s, (lo, hi) in enumerate(new_map):
            if lo <= layer < hi:
                return s
        raise AssertionError(layer)

    plan = [(_UNIT_EMBED, 0, 0), (_UNIT_FINAL, old_n - 1, new_n - 1)]
    plan += [(l, old_owner(l), new_owner(l)) for l in range(n_layers)]
    return plan


def _chunk_splits(old_off: int, new_off: int, length: int,
                  oc: int, nc: int):
    """Split one contiguous flat segment by the chunk boundaries of BOTH
    the old geometry (chunk width ``oc``) and the new (``nc``):
    yields ``(old_member, new_member, old_off, new_off, len)``."""
    done = 0
    while done < length:
        oo, no = old_off + done, new_off + done
        jo, jn = oo // oc, no // nc
        lim = min(length - done,
                  (jo + 1) * oc - oo,
                  (jn + 1) * nc - no)
        yield (jo, jn, oo, no, lim)
        done += lim


# -- host buffers -----------------------------------------------------------
def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    """A tensor, or a copy of an array (a reference's may be read-only)."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.array(x))


def _flat_f32(leaves) -> np.ndarray:
    """Leaves concatenated in order as one host f32 vector."""
    if not leaves:
        return np.zeros(0, np.float32)
    return torch.cat([_tensor(l).detach().reshape(-1).float()
                      for l in leaves]).cpu().numpy()


def _unflatten_like(leaves, treedef, flat: torch.Tensor):
    """``flat`` cut into the shapes of ``leaves`` and rebuilt as the tree
    ``treedef`` (views of ``flat``)."""
    out, off = [], 0
    for l in leaves:
        sz = l.numel()
        out.append(flat[off:off + sz].reshape(l.shape))
        off += sz
    return tree_unflatten(treedef, out)


# -- per-stage transformer compute ------------------------------------------
def _stack_rows(*xs):
    return torch.stack(xs)


def stacked_from_transformer(cfg, tparams) -> dict:
    """Pack per-layer :meth:`Transformer.init` params into the stacked
    layout the pipeline carves stages from (the layout of
    :meth:`ShardedTrainer.from_transformer_params`, unsharded)."""
    L = cfg.n_layers
    layers = [tparams[f"layer_{i}"] for i in range(L)]
    stacked = {
        "embed": tparams["embed"],
        "layers": tree_map(_stack_rows, layers[0], *layers[1:]),
        "ln_f": tparams["ln_f"],
        "head": tparams["head"],
    }
    if cfg.pos == "learned":
        stacked["pos_embed"] = tparams["pos_embed"]
    return stacked


def init_stacked_params(cfg, generator: Optional[torch.Generator] = None,
                        device=None) -> dict:
    """Fresh stacked full-model params (flagship transformer init, drawn
    on the CPU from ``generator``, default seed 0, then moved to
    ``device``, default ``cuda``)."""
    return stacked_from_transformer(
        cfg, Transformer(cfg).init(generator, device=device))


def slice_stage_params(cfg, full_stacked, lo: int, hi: int,
                       first: bool, last: bool) -> dict:
    """This stage's param subtree out of the full stacked tree."""
    out = {"layers": tree_map(lambda a: a[lo:hi], full_stacked["layers"])}
    if first:
        out["embed"] = full_stacked["embed"]
        if cfg.pos == "learned":
            out["pos_embed"] = full_stacked["pos_embed"]
    if last:
        out["ln_f"] = full_stacked["ln_f"]
        out["head"] = full_stacked["head"]
    return out


def stage_param_shapes(cfg, lo: int, hi: int, first: bool,
                       last: bool) -> dict:
    """Shape/dtype skeleton of a stage's param subtree, as ``meta``
    tensors — pure (derived from the config alone), so EVERY rank can
    compute EVERY stage's flat layout for the re-carve plan without
    holding its data."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    n = hi - lo

    def s(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    layer = {
        "ln1": {"scale": s(n, D), "bias": s(n, D)},
        "ln2": {"scale": s(n, D), "bias": s(n, D)},
        "wq": {"w": s(n, D, D), "b": s(n, D)},
        "wk": {"w": s(n, D, D), "b": s(n, D)},
        "wv": {"w": s(n, D, D), "b": s(n, D)},
        "wo": {"w": s(n, D, D), "b": s(n, D)},
        "ffn_in": {"w": s(n, D, F), "b": s(n, F)},
        "ffn_out": {"w": s(n, F, D), "b": s(n, D)},
    }
    out = {"layers": layer}
    if first:
        out["embed"] = {"table": s(V, D)}
        if cfg.pos == "learned":
            out["pos_embed"] = {"table": s(cfg.max_seq, D)}
    if last:
        out["ln_f"] = {"scale": s(D), "bias": s(D)}
        out["head"] = {"w": s(D, V)}
    return out


def _flat_layout(shapes_tree, lo: int):
    """Flat-offset layout of a stage param tree in ``tree_flatten``
    order: ``[(key, global_row0, rows, rowsize, offset)]``.  ``key`` is
    the path tuple with the layer dimension factored out (a "layers"
    leaf's rows are GLOBAL layer indices ``[lo, hi)``); edge leaves are
    single rows keyed by their path."""
    leaves, _ = tree_flatten_with_path(shapes_tree)
    out = []
    off = 0
    for path, leaf in leaves:
        key = tuple(path)
        size = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        if key and key[0] == "layers":
            rows = int(leaf.shape[0])
            out.append((key, lo, rows, size // max(rows, 1), off))
        else:
            out.append((key, 0, 1, size, off))
        off += size
    return out, off


def stage_flat_layouts(cfg, stage_map: Sequence[Tuple[int, int]]):
    """``([layout_per_stage], [total_per_stage])`` for a stage map —
    the pure geometry the re-carve segment plan is computed from."""
    layouts, totals = [], []
    n = len(stage_map)
    for s, (lo, hi) in enumerate(stage_map):
        lay, total = _flat_layout(
            stage_param_shapes(cfg, lo, hi, s == 0, s == n - 1), lo)
        layouts.append(lay)
        totals.append(total)
    return layouts, totals


def flat_recarve_segments(cfg, old_map, new_map):
    """Pure flat-segment plan between two stage maps:
    ``[(old_stage, old_off, new_stage, new_off, length)]`` — for every
    leaf row range of every NEW stage, the contiguous span of the OLD
    stage flat holding the same values.  Segments tile every new stage
    flat exactly.  Unit ownership comes from :func:`stage_recarve_plan`
    — ONE computation of "who owns layer l / the edges", shared by the
    unit-level plan and this transport plan."""
    old_lay, _ = stage_flat_layouts(cfg, old_map)
    new_lay, _ = stage_flat_layouts(cfg, new_map)
    S_old, S_new = len(old_map), len(new_map)
    if old_map != stage_partition(cfg.n_layers, S_old) \
            or new_map != stage_partition(cfg.n_layers, S_new):
        raise ValueError(
            "stage maps must be stage_partition outputs (the canonical "
            "balanced carve every rank derives identically)")
    unit_plan = stage_recarve_plan(cfg.n_layers, S_old, S_new)
    owner = {u: os_ for (u, os_, _) in unit_plan}

    def old_home(key, grow):
        """(old_stage, offset) of one row of leaf ``key``."""
        if key[0] == "layers":
            s = owner[grow]
            for k, gr0, rows, rowsize, off in old_lay[s]:
                if k == key:
                    return s, off + (grow - gr0) * rowsize, rowsize
            raise AssertionError((key, grow))
        s = owner[_UNIT_EMBED if key[0] in ("embed", "pos_embed")
                  else _UNIT_FINAL]
        for k, _, _, rowsize, off in old_lay[s]:
            if k == key:
                return s, off, rowsize
        raise AssertionError(key)

    segs = []
    for ns in range(S_new):
        for key, gr0, rows, rowsize, noff in new_lay[ns]:
            r = 0
            while r < rows:
                os_, ooff, rs = old_home(key, gr0 + r)
                assert rs == rowsize, (key, rs, rowsize)
                # extend over consecutive rows living contiguously in
                # the SAME old stage
                lo, hi = old_map[os_] if key[0] == "layers" else (0, 0)
                if key[0] == "layers":
                    run = min(rows - r, hi - (gr0 + r))
                else:
                    run = rows - r
                segs.append((os_, ooff, ns, noff + r * rowsize,
                             run * rowsize))
                r += run
    return segs


# -- the per-stage compute module -------------------------------------------
class _Replicate(torch.autograd.Function):
    """``x`` as ``n`` stacked rows (one per co-resident tp rank).  Every
    row's cotangent is the full one (the Megatron pair makes the ranks'
    partial cotangents whole), so the backward takes row 0's — a sum over
    rows (``expand``'s backward) would count it ``n`` times."""

    @staticmethod
    def forward(ctx, x, n):
        return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()

    @staticmethod
    def backward(ctx, g):
        return g[0], None


class _Pick(torch.autograd.Function):
    """Row 0 of a value replicated over the stacked tp ranks; the
    backward hands every rank the full cotangent, as each device of the
    reference's replicated output receives it."""

    @staticmethod
    def forward(ctx, xs):
        ctx.n = xs.shape[0]
        return xs[0].clone()

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0).expand((ctx.n,) + tuple(g.shape)).contiguous()


class StageModule:
    """One pipeline stage's transformer math: the layer range
    ``[lo, hi)`` (+ embedding on the first stage, final norm + LM head
    + loss on the last), with forward, recompute-backward (activation
    recomputation — the 1F1B memory contract), and optional tensor
    parallelism over ``tp`` co-resident ranks of the stage's device
    (TP stays within the stage; only activations cross the wire)."""

    def __init__(self, cfg, lo: int, hi: int, *, first: bool, last: bool,
                 tp: int = 1, device=None):
        self.cfg, self.lo, self.hi = cfg, int(lo), int(hi)
        self.first, self.last = bool(first), bool(last)
        self.tp = int(tp)
        self.device = resolve_device(device)
        #: the tp ranks' mesh (None when tp == 1)
        self.mesh = None
        if self.tp > 1:
            if cfg.n_heads % self.tp or cfg.d_ff % self.tp:
                raise ValueError(
                    f"tp={self.tp} must divide n_heads ({cfg.n_heads}) "
                    f"and d_ff ({cfg.d_ff})")
            self.mesh = MeshPlan(tp=self.tp)

    # -- parameter layout -------------------------------------------------
    def param_specs(self):
        """PartitionSpecs of the layer leaves over the stage's tp ranks
        (None when tp == 1); the edge params stay whole."""
        from kungfu_tpu_torch.parallel.train import P

        if self.mesh is None:
            return None
        col = {"w": P(None, None, "tp"), "b": P(None, "tp")}
        layer = {
            "ln1": {"scale": P(None, None), "bias": P(None, None)},
            "ln2": {"scale": P(None, None), "bias": P(None, None)},
            "wq": dict(col), "wk": dict(col), "wv": dict(col),
            "wo": {"w": P(None, "tp", None), "b": P(None, None)},
            "ffn_in": dict(col),
            "ffn_out": {"w": P(None, "tp", None), "b": P(None, None)},
        }
        return {"layers": layer}

    def place(self, params):
        """Put a stage-param tree (tensors or arrays, the global layout)
        onto this module's device — the layer leaves as stacked
        ``[tp, ...]`` shards when tp > 1."""
        from kungfu_tpu_torch.parallel.train import shard_stacked

        out = tree_map(lambda x: _tensor(x).to(self.device), params)
        if self.mesh is not None:
            out["layers"] = tree_map(
                lambda x, spec: shard_stacked(x, spec, self.mesh),
                out["layers"], self.param_specs()["layers"])
        return out

    def gather(self, tree):
        """Inverse of :meth:`place` for a placed tree (params, or a
        gradient of them): the global layout."""
        from kungfu_tpu_torch.parallel.train import gather_stacked

        if self.mesh is None:
            return tree
        out = dict(tree)
        out["layers"] = tree_map(
            lambda x, spec: gather_stacked(x, spec, self.mesh),
            tree["layers"], self.param_specs()["layers"])
        return out

    # -- math --------------------------------------------------------------
    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    def _embed(self, params, ids):
        cfg = self.cfg
        h = nn.embedding_apply(params["embed"], ids,
                               dtype=cfg.compute_dtype)
        if cfg.pos == "learned":
            h = h + nn.embedding_apply(
                params["pos_embed"], self._positions(*ids.shape),
                dtype=cfg.compute_dtype)
        return h

    def _layers_dense(self, params, h, positions):
        """The tp == 1 layer loop — the flagship
        :meth:`Transformer.hidden` block math, attention included
        (:func:`pick_attention`, ROADMAP C22)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        H, Hd = cfg.n_heads, cfg.head_dim
        attn = pick_attention()

        def heads(t):
            B, S, _ = t.shape
            return t.reshape(B, S, H, Hd).transpose(1, 2)

        def merge(t):
            B, Hn, S, D = t.shape
            return t.transpose(1, 2).reshape(B, S, Hn * D)

        for i in range(self.hi - self.lo):
            lp = tree_map(lambda a: a[i], params["layers"])
            x = nn.layernorm_apply(lp["ln1"], h)
            q = heads(nn.dense_apply(lp["wq"], x, dtype=dt))
            k = heads(nn.dense_apply(lp["wk"], x, dtype=dt))
            v = heads(nn.dense_apply(lp["wv"], x, dtype=dt))
            if cfg.pos == "rope":
                q, k = _rope(q, k, positions)
            o = attn(q, k, v, cfg.causal)
            h = h + nn.dense_apply(lp["wo"], merge(o), dtype=dt)
            x = nn.layernorm_apply(lp["ln2"], h)
            y = nn.gelu(nn.dense_apply(lp["ffn_in"], x, dtype=dt))
            h = h + nn.dense_apply(lp["ffn_out"], y, dtype=dt)
        return h

    def _layers_tp(self, params, h, positions):
        """The tp > 1 layer loop over the stacked tp ranks in a rank
        world of their own: Megatron column/row products with the
        paired region collectives (:mod:`kungfu_tpu_torch.parallel.tp`),
        attention over each rank's head shard."""
        from kungfu_tpu_torch.ops import collective as coll
        from kungfu_tpu_torch.parallel.train import _ln

        cfg = self.cfg
        dt = cfg.compute_dtype
        n = self.tp
        H_loc, Hd = cfg.n_heads // n, cfg.head_dim
        attn = pick_attention()
        B, S, _ = h.shape
        pos = positions.repeat(n, 1)

        def heads(t):
            return t.reshape(n * B, S, H_loc, Hd).transpose(1, 2)

        def merge(t):
            return t.transpose(1, 2).reshape(n, B, S, H_loc * Hd)

        with coll.rank_world([("tp", n)]):
            hs = _Replicate.apply(h, n)
            for i in range(self.hi - self.lo):
                lp = tree_map(lambda a: a[:, i], params["layers"])
                x = _ln(lp["ln1"], hs)
                x = tpmod.tp_region_enter(x, "tp")
                q = heads(tpmod.column_dense(lp["wq"], x, dtype=dt))
                k = heads(tpmod.column_dense(lp["wk"], x, dtype=dt))
                v = heads(tpmod.column_dense(lp["wv"], x, dtype=dt))
                if cfg.pos == "rope":
                    q, k = _rope(q, k, pos)
                o = attn(q, k, v, cfg.causal)
                hs = hs + tpmod.row_dense(lp["wo"], merge(o), "tp", dtype=dt)
                x = _ln(lp["ln2"], hs)
                x = tpmod.tp_region_enter(x, "tp")
                y = nn.gelu(tpmod.column_dense(lp["ffn_in"], x, dtype=dt))
                hs = hs + tpmod.row_dense(lp["ffn_out"], y, "tp", dtype=dt)
            return _Pick.apply(hs)

    def _hidden(self, params, x):
        if self.first:
            positions = self._positions(*x.shape)
            h = self._embed(params, x)
        else:
            B, S = x.shape[0], x.shape[1]
            positions = self._positions(B, S)
            h = x.to(self.cfg.compute_dtype)
        if self.mesh is not None:
            return self._layers_tp(params, h, positions)
        return self._layers_dense(params, h, positions)

    def _fwd(self, params, x):
        return self._hidden(params, x)

    def _loss(self, params, x, targets):
        h = self._hidden(params, x)
        hf = nn.layernorm_apply(params["ln_f"], h)
        logits = nn.dense_apply(params["head"], hf).float()
        return token_nll(logits, targets)

    def _leaves(self, params):
        """Detached copies of the param leaves that require grad, and
        the tree over them, for one recompute."""
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        return leaves, tree_unflatten(treedef, leaves), treedef

    def _bwd(self, params, x, dout):
        leaves, p, treedef = self._leaves(params)
        with torch.enable_grad():
            if self.first:
                out = self._fwd(p, x)
                grads = torch.autograd.grad(out, leaves, dout)
                return tree_unflatten(treedef, grads), None
            xx = x.detach().requires_grad_(True)
            out = self._fwd(p, xx)
            *grads, dx = torch.autograd.grad(out, leaves + [xx], dout)
        return tree_unflatten(treedef, grads), dx

    def _loss_bwd(self, params, x, targets):
        leaves, p, treedef = self._leaves(params)
        with torch.enable_grad():
            if self.first:
                loss = self._loss(p, x, targets)
                grads = torch.autograd.grad(loss, leaves)
                return loss.detach(), tree_unflatten(treedef, grads), None
            xx = x.detach().requires_grad_(True)
            loss = self._loss(p, xx, targets)
            *grads, dx = torch.autograd.grad(loss, leaves + [xx])
        return loss.detach(), tree_unflatten(treedef, grads), dx

    def _input(self, x) -> torch.Tensor:
        """Token ids (the first stage) or an incoming activation, on the
        stage's device."""
        t = _tensor(x)
        if self.first:
            return t.to(self.device, torch.long)
        return t.to(self.device)

    # -- public ------------------------------------------------------------
    def forward(self, params, x):
        """Stage forward; ``x`` is int ids on the first stage, the
        incoming activation elsewhere.  Keeps no graph."""
        with torch.no_grad():
            return self._fwd(params, self._input(x))

    def backward(self, params, x, dout):
        """Recompute-backward: ``(dparams, dx)`` (``dx`` None on the
        first stage — token ids have no cotangent); ``dparams`` in the
        placed layout."""
        dout = _tensor(dout).to(self.device)
        return self._bwd(params, self._input(x), dout)

    def loss_backward(self, params, x, targets):
        """Last stage only: ``(loss, dparams, dx)`` — the loss forward
        and its gradient in one recompute (seed 1.0)."""
        if not self.last:
            raise ValueError("loss_backward belongs to the last stage")
        targets = _tensor(targets).to(self.device, torch.long)
        return self._loss_bwd(params, self._input(x), targets)


# -- elastic stage boundary -------------------------------------------------
class StageBoundary:
    """Committed step boundary of ONE rank's pipeline stage: the stage
    params as a flat host vector (+ shapes for restore) and the ZeRO-2
    optimizer chunk, with a ring-buddy mirror one stage back in the SAME
    dp lane (``stride = dp`` ranks = one slice on a multislice pod) so a
    whole dead stage re-carves from its predecessor — the
    :class:`~kungfu_tpu_torch.elastic.reshard.ZeroBoundary` discipline
    applied to the pipeline axis."""

    def __init__(self):
        self._lock = threading.Lock()
        self._step: Optional[int] = None
        self._cfg = None
        self._stage: Optional[int] = None
        self._n_stages: Optional[int] = None
        self._dp: int = 1
        self._dp_index: int = 0
        self._zero: int = 0
        #: flat stage params [total_s] f32 (params are replicated
        #: within the stage's dp group, so every member holds the full
        #: stage flat)
        self._pflat: Optional[np.ndarray] = None
        #: ZeRO-2 optimizer vec leaves: {leaf_idx: [chunk] np}
        self._opt_vec: Dict[int, np.ndarray] = {}
        self._opt_scal: Dict[int, np.ndarray] = {}
        self._opt_treedef = None
        self._opt_dtypes: Dict[int, np.dtype] = {}
        #: mirror of the successor stage (same dp lane)
        self._buddy: Optional[dict] = None
        self._buddy_stage: Optional[int] = None
        #: the last :meth:`recarve` on this rank: wall seconds and the
        #: bytes sent, params and optimizer chunks apart (port addition)
        self.last_recarve: Optional[dict] = None

    # -- commit ------------------------------------------------------------
    def commit(self, step: int, cfg, stage: int, n_stages: int, dp: int,
               dp_index: int, params, opt_state, zero_stage: int) -> None:
        """Host-copy this rank's stage state as of completed step
        ``step``.  ``params`` is the stage tree in the global layout;
        ``opt_state`` is the ZeRO-2 chunk tree (leaves are
        ``[ceil(total/dp)]`` vectors or scalars); a replicated
        (``zero_stage == 0``) optimizer must be stateless — its vector
        leaves have no flat-chunk geometry to re-carve."""
        pflat = _flat_f32(tree_leaves(params))
        oleaves, otd = tree_flatten(opt_state)
        vec, scal = {}, {}
        for i, l in enumerate(oleaves):
            a = np.array(_np(l))
            if a.ndim >= 1:
                if zero_stage != 2:
                    raise ValueError(
                        "StageBoundary carries optimizer state through a "
                        "stage re-carve only in the ZeRO-2 flat-chunk "
                        "geometry — use zero_stage=2 or a stateless inner")
                vec[i] = a
            else:
                scal[i] = a
        with self._lock:
            self._step = int(step)
            self._cfg = cfg
            self._stage, self._n_stages = int(stage), int(n_stages)
            self._dp, self._dp_index = int(dp), int(dp_index)
            self._zero = int(zero_stage)
            self._pflat = pflat
            self._opt_vec, self._opt_scal = vec, scal
            self._opt_treedef = otd
            self._opt_dtypes = {i: a.dtype for i, a in vec.items()}
            self._buddy = None
            self._buddy_stage = None

    def step(self) -> Optional[int]:
        with self._lock:
            return self._step

    @property
    def stage(self) -> Optional[int]:
        with self._lock:
            return self._stage

    # -- ring-buddy mirror --------------------------------------------------
    def _blob(self) -> bytes:
        bio = io.BytesIO()
        np.savez(
            bio, pflat=self._pflat,
            meta=np.array([self._step, self._stage, self._n_stages,
                           self._dp, self._dp_index, self._zero], np.int64),
            **{f"v{i}": a for i, a in self._opt_vec.items()},
        )
        return bio.getvalue()

    def replicate_ring(self, chan, workers, tag: str) -> int:
        """Mirror this rank's committed stage onto the same dp lane of
        the PREDECESSOR stage (``stride = dp`` ranks back, ring-wrapped)
        and adopt the successor's — after this, a whole dead stage's
        params and opt chunks survive one stage (= one slice) earlier.
        ``tag`` must be identical on every rank.  Returns the bytes
        sent."""
        from kungfu_tpu_torch.elastic.reshard import _recv_or_fail

        with self._lock:
            if self._step is None:
                raise ValueError("replicate_ring before any commit")
            blob = self._blob()
            dp, stage, n_stages = self._dp, self._stage, self._n_stages
            dp_index = self._dp_index
        if n_stages < 2:
            return 0
        world = n_stages * dp
        me = stage * dp + dp_index
        pred = workers[(me - dp) % world]
        succ = workers[(me + dp) % world]
        name = f"kf.ppbuddy.{tag}"
        timeline.event("pp", "buddy-replicate", rank=me,
                       nbytes=len(blob), stage=stage)
        chan.send(pred, name, blob)
        raw = _recv_or_fail(chan, succ, (me + dp) % world,
                            "pp-buddy", name)
        with np.load(io.BytesIO(raw)) as z:
            buddy = {
                "pflat": z["pflat"],
                "meta": z["meta"],
                "vec": {int(k[1:]): z[k] for k in z.files
                        if k.startswith("v")},
            }
        with self._lock:
            self._buddy = buddy
            self._buddy_stage = (stage + 1) % n_stages
        return len(blob)

    # -- re-carve -----------------------------------------------------------
    def recarve(self, new_n_stages: int, peer=None, old_workers=None,
                new_workers=None, tag: str = "0",
                dead: Optional[Sequence[int]] = None,
                expect_step: Optional[int] = None) -> None:
        """Re-balance the committed stage state for a
        ``new_n_stages``-stage world (same dp width).  Leaderless: every
        participant computes the same :func:`flat_recarve_segments`
        plan and moves only the spans it owns or will own; dead stages'
        spans are served from the ring-buddy mirror on their
        predecessor (same dp lane).  ``dead`` is the confirmed dead set
        of OLD ranks; whole stages only (the slice ladder excludes
        slices whole).  ``expect_step`` gates against survivors whose
        boundaries committed different steps (the ZeroBoundary
        policy).  :attr:`last_recarve` records its seconds and the bytes
        this rank sent."""
        from kungfu_tpu_torch.elastic.reshard import _recv_or_fail

        t0 = time.perf_counter()
        with self._lock:
            if self._step is None:
                raise ValueError("recarve before any commit")
            step = self._step
            cfg = self._cfg
            old_n, dp = self._n_stages, self._dp
            my_stage, my_dp = self._stage, self._dp_index
            pflat = self._pflat
            opt_vec = dict(self._opt_vec)
            buddy, buddy_stage = self._buddy, self._buddy_stage
            zero = self._zero
        if expect_step is not None and step >= 0 and step != int(expect_step):
            raise ValueError(
                f"stage boundary committed at step {step} but the cluster "
                f"agreed to replay from step {expect_step} — a re-carve "
                "would blend states from different steps; escalate to the "
                "checkpoint restart")
        if not 1 <= new_n_stages:
            raise ValueError(f"new_n_stages must be >= 1, {new_n_stages}")
        old_map = stage_partition(cfg.n_layers, old_n)
        new_map = stage_partition(cfg.n_layers, new_n_stages)
        dead = {int(d) for d in (dead or ())}
        dead_stages = sorted({d // dp for d in dead})
        for s in dead_stages:
            members = set(range(s * dp, (s + 1) * dp))
            if not members <= dead:
                raise ValueError(
                    f"stage {s} is partially dead ({sorted(dead & members)}"
                    f" of {sorted(members)}) — the recovery ladder excludes "
                    "failure domains whole; re-run the slice verdict")
        alive_stages = [s for s in range(old_n) if s not in dead_stages]

        def server_stage(os_: int) -> Tuple[int, bool]:
            """(old stage whose ranks serve ``os_``'s spans, via_buddy)."""
            if os_ not in dead_stages:
                return os_, False
            pred = (os_ - 1) % old_n
            if pred in dead_stages:
                raise ValueError(
                    f"stage {os_} is dead and so is its buddy predecessor "
                    f"{pred} — stage unrecoverable (mirror redundancy "
                    "covers one failure domain; escalate to the "
                    "checkpoint restart)")
            return pred, True

        # recoverability first, BEFORE anything moves (and before the
        # wiring checks — data loss outranks a missing argument): every
        # dead stage must have an alive buddy predecessor, and when
        # THIS rank is that predecessor it must actually hold the
        # mirror — committed at THIS boundary's step.  replicate_ring
        # runs off the step path, so a rank one commit ahead can mirror
        # a NEWER successor state; serving a dead stage from a different
        # step would silently blend two optimizer states
        for s in dead_stages:
            serv0, _ = server_stage(s)
            if serv0 == my_stage:
                if buddy is None or buddy_stage != s:
                    raise ValueError(
                        f"stage {s} is dead and this rank holds no "
                        "mirror of it (replicate_ring was never run on "
                        "this boundary) — stage unrecoverable")
                bstep = int(buddy["meta"][0])
                if bstep != step:
                    raise ValueError(
                        f"stage {s}'s mirror was replicated at step "
                        f"{bstep} but this boundary committed step "
                        f"{step} — serving it would blend states from "
                        "different steps; escalate to the checkpoint "
                        "restart")
        if (old_n > 1 or new_n_stages > 1) and (
                peer is None or old_workers is None or new_workers is None):
            # all three or none: a missing worker list would silently
            # skip the remote sends in phase 1 and then crash the
            # receiving rank with a raw TypeError in phase 2
            raise ValueError(
                "multi-stage recarve needs peer + old_workers + "
                "new_workers (the typed configuration contract of the "
                "recovery path)")
        # staying = alive stages whose ranks are members of the NEW
        # world; alive-but-leaving stages (a planned resize's leavers)
        # still SERVE their spans before detaching, exactly like
        # ZeroBoundary's leavers
        if old_workers is not None and new_workers is not None:
            staying = [s for s in alive_stages
                       if new_workers.rank(old_workers[s * dp]) is not None]
        else:
            staying = alive_stages
        if len(staying) != new_n_stages:
            raise ValueError(
                f"{len(staying)} staying stages cannot carve "
                f"{new_n_stages} new stages (dp width is fixed)")
        # old-stage index -> new-stage index over the stayers
        new_of_old = {os_: ns for ns, os_ in enumerate(staying)}
        my_new_stage = new_of_old.get(my_stage)
        segs = flat_recarve_segments(cfg, old_map, new_map)
        timeline.event("pp", "stage-recarve", old_n=old_n,
                       new_n=new_n_stages, dead=dead_stages,
                       segments=len(segs))

        _, old_totals = stage_flat_layouts(cfg, old_map)
        _, new_totals = stage_flat_layouts(cfg, new_map)

        def old_rank(os_: int, j: int) -> int:
            return os_ * dp + j

        def new_rank(ns: int, j: int) -> int:
            return ns * dp + j

        chan = peer.channel if peer is not None else None
        me_addr = peer.config.self_id if peer is not None else None
        sent = {"params": 0, "opt": 0}

        def send(dst, name: str, arr: np.ndarray, kind: str) -> None:
            chan.send(dst, name, np.ascontiguousarray(arr))
            sent[kind] += arr.nbytes

        def local_flat(os_: int, via_buddy: bool) -> np.ndarray:
            if via_buddy:
                if buddy is None or buddy_stage != os_:
                    raise ValueError(
                        f"stage {os_} is dead and this rank holds no "
                        "mirror of it (replicate_ring was never run on "
                        "this boundary) — stage unrecoverable")
                return buddy["pflat"]
            return pflat

        def local_vec(os_: int, via_buddy: bool) -> Dict[int, np.ndarray]:
            if via_buddy:
                return buddy["vec"]
            return opt_vec

        # --- params: replicated within the stage, so the server for a
        # span toward (ns, j) is (server_stage, j) — same lane, zero
        # cross-lane traffic, and the whole-dead-stage case is LOCAL
        # (the mirror lives exactly where the data is needed).
        def seg_name(kind: str, i: int) -> str:
            return f"kf.pprc.{tag}.{kind}{i}"

        new_pflat = (np.zeros(new_totals[my_new_stage], np.float32)
                     if my_new_stage is not None else None)
        oc = {s: max(1, math.ceil(old_totals[s] / dp))
              for s in range(old_n)}
        nc = {s: max(1, math.ceil(new_totals[s] / dp))
              for s in range(new_n_stages)}
        new_vec: Dict[int, np.ndarray] = {}
        if zero == 2 and self._opt_dtypes and my_new_stage is not None:
            new_vec = {i: np.zeros(nc[my_new_stage], dt)
                       for i, dt in self._opt_dtypes.items()}

        # PHASE 1 — serve: every span this rank hosts that lands on
        # another rank is sent BEFORE any receive (the channel buffers
        # frames, so serve-all-then-assemble cannot deadlock).  Local
        # spans copy in place here too.
        for i, (os_, ooff, ns, noff, ln) in enumerate(segs):
            serv, via_buddy = server_stage(os_)
            if serv == my_stage:
                dst = new_rank(ns, my_dp)
                src_flat = local_flat(os_, via_buddy)
                if my_new_stage is not None and ns == my_new_stage:
                    new_pflat[noff:noff + ln] = src_flat[ooff:ooff + ln]
                elif new_workers is not None \
                        and new_workers[dst] != me_addr:
                    send(new_workers[dst], seg_name("p", i),
                         src_flat[ooff:ooff + ln], "params")
            if zero == 2 and self._opt_dtypes:
                for (jo, jn, oo, no, l) in _chunk_splits(
                        ooff, noff, ln, oc[os_], nc[ns]):
                    if not (serv == my_stage and jo == my_dp):
                        continue
                    vecs = local_vec(os_, via_buddy)
                    base = jo * oc[os_]
                    dst_is_me = (my_new_stage is not None
                                 and ns == my_new_stage and jn == my_dp)
                    if dst_is_me:
                        for k, arr in vecs.items():
                            new_vec[k][no - jn * nc[ns]:
                                       no - jn * nc[ns] + l] = \
                                arr[oo - base:oo - base + l]
                    else:
                        dst = new_rank(ns, jn)
                        for k, arr in vecs.items():
                            send(new_workers[dst],
                                 seg_name(f"z{k}.", i) + f".{oo}",
                                 arr[oo - base:oo - base + l], "opt")

        # PHASE 2 — assemble: receive every remote span of my new stage
        for i, (os_, ooff, ns, noff, ln) in enumerate(segs):
            serv, via_buddy = server_stage(os_)
            if my_new_stage is not None and ns == my_new_stage \
                    and serv != my_stage:
                raw = _recv_or_fail(
                    chan, old_workers[old_rank(serv, my_dp)],
                    old_rank(serv, my_dp), "pp-recarve",
                    seg_name("p", i))
                got = np.frombuffer(raw, np.float32)
                if got.shape[0] != ln:
                    raise ValueError(
                        f"recarve segment p{i}: expected {ln} "
                        f"elements, got {got.shape[0]}")
                new_pflat[noff:noff + ln] = got
            if zero == 2 and self._opt_dtypes:
                for (jo, jn, oo, no, l) in _chunk_splits(
                        ooff, noff, ln, oc[os_], nc[ns]):
                    dst_is_me = (my_new_stage is not None
                                 and ns == my_new_stage and jn == my_dp)
                    if not dst_is_me or (serv == my_stage and jo == my_dp):
                        continue
                    src = old_rank(serv, jo)
                    for k in new_vec:
                        raw = _recv_or_fail(
                            chan, old_workers[src], src, "pp-recarve",
                            seg_name(f"z{k}.", i) + f".{oo}")
                        got = np.frombuffer(raw, self._opt_dtypes[k])
                        if got.shape[0] != l:
                            raise ValueError(
                                f"recarve opt segment {i}@{oo}: "
                                f"expected {l}, got {got.shape[0]}")
                        new_vec[k][no - jn * nc[ns]:
                                   no - jn * nc[ns] + l] = got

        with self._lock:
            self.last_recarve = {
                "s": time.perf_counter() - t0,
                "sent_param_bytes": sent["params"],
                "sent_opt_bytes": sent["opt"]}
            if my_new_stage is None:
                # leaver/dead lane: served its spans; drop stale state
                self._pflat = None
                self._opt_vec = {}
            else:
                self._stage = my_new_stage
                self._n_stages = int(new_n_stages)
                self._pflat = new_pflat
                self._opt_vec = new_vec
                self._buddy = None
                self._buddy_stage = None

    # -- restore ------------------------------------------------------------
    def restore(self):
        """``(stage, n_stages, params_tree, opt_state)`` from the
        (re-carved) boundary — the new :class:`HostPipeline` epoch's
        starting state, as CPU tensors."""
        with self._lock:
            if self._pflat is None:
                raise ValueError("restore before commit (or on a leaver)")
            cfg, stage, n = self._cfg, self._stage, self._n_stages
            pflat = self._pflat
            vec, scal = dict(self._opt_vec), dict(self._opt_scal)
            otd = self._opt_treedef
        lo, hi = stage_partition(cfg.n_layers, n)[stage]
        shapes = stage_param_shapes(cfg, lo, hi, stage == 0, stage == n - 1)
        leaves, treedef = tree_flatten(shapes)
        params = _unflatten_like(leaves, treedef,
                                 torch.from_numpy(pflat.copy()))
        opt = None
        if otd is not None:
            oleaves = [torch.from_numpy(np.array(vec[i] if i in vec
                                                 else scal[i]))
                       for i in range(num_leaves(otd))]
            opt = tree_unflatten(otd, oleaves)
        return stage, n, params, opt


def recarve_stages_after_shrink(peer, boundary: StageBoundary,
                                old_workers,
                                expect_step: Optional[int] = None) -> None:
    """Shrink-recovery rung 10: re-balance pipeline stages across the
    survivors.  Call AFTER ``shrink_to_survivors`` succeeded
    (``peer.cluster.workers`` is the shrunk list); ``old_workers`` is
    the pre-shrink membership the boundary was committed under.  The
    dead set is derived the same way the ZeRO re-carve derives it:
    every old rank absent from the survivor list is confirmed dead."""
    new_workers = peer.cluster.workers
    dead = [r for r, w in enumerate(old_workers)
            if new_workers.rank(w) is None]
    dp = max(1, boundary._dp)
    if len(new_workers) % dp:
        raise ValueError(
            f"surviving world of {len(new_workers)} does not tile the "
            f"dp width {dp} — stage re-carve needs whole dp groups")
    boundary.recarve(
        len(new_workers) // dp, peer=peer, old_workers=old_workers,
        new_workers=new_workers, tag=f"v{peer.cluster_version}",
        dead=dead, expect_step=expect_step,
    )


# -- the host-plane pipeline runner ----------------------------------------
@dataclass
class _PendingRecv:
    handle: object
    dtype: object
    shape: tuple


class HostPipeline:
    """Runs one rank's side of the cross-host pipeline: the 1F1B (or
    interleaved / sequential) schedule over async p2p handles, with the
    stage's DP gradient sync — replicated or ZeRO-2 bucketed
    reduce-scatter — overlapped into the drain.

    World layout is stage-major (= slice-major): rank ``r`` is stage
    ``r // dp``, dp lane ``r % dp``; activations flow within a lane,
    gradients reduce within a stage.  ``plan`` is a
    :class:`~kungfu_tpu_torch.parallel.train.ParallelPlan` with
    ``pp * dp == len(engine.peers)``; ``tp`` shards the stage math over
    co-resident ranks of this rank's ``device`` (TP never crosses the
    wire)."""

    def __init__(self, engine, plan, cfg, *, full_params=None,
                 stage_params=None, inner=None, device=None, peer=None,
                 n_buckets: int = 2, prefetch: int = _PREFETCH):
        from kungfu_tpu_torch.comm.engine import ASYNC_POOL_WORKERS

        self.engine = engine
        self.plan = plan
        self.cfg = cfg
        self.peer = peer
        world = len(engine.peers)
        if plan.pp * plan.dp != world:
            raise ValueError(
                f"plan pp={plan.pp} x dp={plan.dp} does not tile the "
                f"{world}-rank world")
        if plan.zero_stage not in (0, 2):
            raise ValueError(
                "HostPipeline composes ZeRO-2 (bucketed reduce-scatter) "
                f"or replicated DP — zero_stage={plan.zero_stage}")
        if peer is not None:
            topo = peer.slice_topology()
            if topo is not None and (topo.num_slices != plan.pp
                                     or topo.ranks_per_slice != plan.dp):
                raise ValueError(
                    f"plan (pp={plan.pp}, dp={plan.dp}) disagrees with "
                    f"the slice topology {topo} — PP maps across the "
                    "slice axis (one stage per slice)")
        self.rank = engine.rank
        self.stage = self.rank // plan.dp
        self.dp_index = self.rank % plan.dp
        self.v = plan.interleave if plan.pp_schedule == "interleaved" else 1
        self.n_micro = plan.n_micro or plan.pp
        self._S, self._V = plan.pp, plan.pp * self.v
        part = interleaved_partition(cfg.n_layers, plan.pp, self.v)
        self.mods: List[StageModule] = []
        self.params: List[dict] = []
        for c in range(self.v):
            lo, hi = part[self.stage][c]
            vs = c * self._S + self.stage
            mod = StageModule(cfg, lo, hi, first=vs == 0,
                              last=vs == self._V - 1, tp=plan.tp,
                              device=device)
            self.mods.append(mod)
            if stage_params is not None:
                sp = stage_params if self.v == 1 else stage_params[c]
            elif full_params is not None:
                sp = slice_stage_params(cfg, full_params, lo, hi,
                                        vs == 0, vs == self._V - 1)
            else:
                raise ValueError("need full_params or stage_params")
            self.params.append(mod.place(sp))
        self.inner = inner if inner is not None else sgd(0.01)
        self._n_buckets = max(1, int(n_buckets))
        self._prefetch = max(0, int(prefetch))
        # ZeRO-2 opt state: one flat chunk per chunk-module; replicated:
        # full tree (global layout) per module
        self.opt_state: List[object] = []
        self._flat_shapes: List[int] = []
        for c in range(self.v):
            gparams = self.mods[c].gather(self.params[c])
            total = sum(l.numel() for l in tree_leaves(gparams))
            self._flat_shapes.append(total)
            if plan.zero_stage == 2:
                chunk = max(1, math.ceil(total / plan.dp))
                self.opt_state.append(self.inner.init(torch.zeros(
                    (chunk,), dtype=torch.float32,
                    device=self.mods[c].device)))
            else:
                self.opt_state.append(self.inner.init(gparams))
        self._step = 0
        #: the op list is a pure function of (schedule, m, S, stage, v)
        #: — all fixed at construction; the interleaved variant's
        #: greedy DAG simulation must not re-run on the per-step path
        self._ops = build_schedule(self.plan.pp_schedule, self.n_micro,
                                   self._S, self.stage, self.v)
        # the steady-state in-flight set — prefetched activation recvs,
        # bounded sends, and the act+grad pair the current op touches —
        # must fit the engine's async worker pool, or a full pool stalls
        # submission mid-schedule while every peer waits on the frame we
        # never sent: a distributed deadlock, not a slowdown
        window = self._prefetch + _MAX_INFLIGHT_SENDS + 2
        if window > ASYNC_POOL_WORKERS:
            raise ValueError(
                f"pipeline in-flight window {window} (prefetch="
                f"{self._prefetch} + max sends {_MAX_INFLIGHT_SENDS} + 2)"
                f" exceeds the async pool ({ASYNC_POOL_WORKERS} workers);"
                f" lower prefetch= or widen ASYNC_POOL_WORKERS")
        #: tag namespace keyed by the channel epoch token: a rebuilt
        #: post-shrink engine gets a fresh token, so a replayed step's
        #: tags can never collide with the dead epoch's stragglers
        self._tagbase = f"pp.e{getattr(engine.channel, 'token', 0)}"
        # the schedule needs warmup+drain handles in flight; widen the
        # engine window (local backpressure knob)
        engine.set_overlap_depth(
            max(engine.overlap_depth, self._prefetch + _MAX_INFLIGHT_SENDS
                + 2))

    # -- geometry ----------------------------------------------------------
    def _phys(self, vs: int) -> int:
        return vs % self._S

    def _peer_rank(self, stage: int) -> int:
        return stage * self.plan.dp + self.dp_index

    def _dp_rank(self, j: int) -> int:
        return self.stage * self.plan.dp + j

    def _act_tag(self, mb: int, vs: int) -> str:
        return f"{self._tagbase}.t{self._step}.f{mb}.v{vs}"

    def _grad_tag(self, mb: int, vs: int) -> str:
        return f"{self._tagbase}.t{self._step}.b{mb}.v{vs}"

    def _op_dep(self, op) -> Optional[Tuple[str, int, tuple]]:
        """(tag, src_rank, (dtype, shape)) this op blocks on, or None."""
        kind, mb, c = op
        vs = c * self._S + self.stage
        act_shape = (self._B_mb, self._seq, self.cfg.d_model)
        dt = self.cfg.compute_dtype
        if kind == "F":
            if vs == 0:
                return None
            return (self._act_tag(mb, vs), self._peer_rank(
                self._phys(vs - 1)), (dt, act_shape))
        if vs == self._V - 1:
            return None
        return (self._grad_tag(mb, vs), self._peer_rank(
            self._phys(vs + 1)), (dt, act_shape))

    def warmup(self, B_loc: int, seq: int) -> None:
        """Run every stage's entry points once on dummy shapes — locally,
        with NO wire traffic.  A kernel built or first launched inside
        the first step's recv window would read as a dead peer to the
        per-peer deadline."""
        m = self.n_micro
        if B_loc % m:
            raise ValueError(f"batch {B_loc} % n_micro {m} != 0")
        B_mb = B_loc // m
        ids = torch.zeros((B_mb, seq), dtype=torch.long)
        act = torch.zeros((B_mb, seq, self.cfg.d_model),
                          dtype=self.cfg.compute_dtype)
        for c, mod in enumerate(self.mods):
            p = self.params[c]
            x = ids if mod.first else act
            if mod.last:
                mod.loss_backward(p, x, ids)
            else:
                mod.forward(p, x)
                mod.backward(p, x, act)

    # -- the step ----------------------------------------------------------
    def train_step(self, ids, targets) -> Optional[float]:
        """One full training step over this rank's dp-lane batch shard
        ``(ids, targets)`` of shape ``[B_loc, S]``; returns the mean
        microbatch loss on last-stage ranks, None elsewhere."""
        ids = _np(ids)
        targets = _np(targets)
        m = self.n_micro
        B_loc, S = ids.shape
        if B_loc % m:
            raise ValueError(f"batch {B_loc} % n_micro {m} != 0")
        self._B_mb, self._seq = B_loc // m, S
        ids_mb = ids.reshape(m, self._B_mb, S)
        tgt_mb = targets.reshape(m, self._B_mb, S)
        ops = self._ops
        grads = [None] * self.v
        b_done = [0] * self.v
        losses: List[float] = []
        x_in: Dict[Tuple[int, int], object] = {}
        recvs: Dict[str, _PendingRecv] = {}
        sends: List[object] = []
        dp_pending: List[tuple] = []
        prefetch_on = self.plan.pp_schedule != "sequential"

        def ensure_recv(idx: int) -> None:
            if not prefetch_on:
                return
            for op in ops[idx: idx + 1 + self._prefetch]:
                dep = self._op_dep(op)
                if dep is None or dep[0] in recvs:
                    continue
                tag, src, (dt, shape) = dep
                recvs[tag] = _PendingRecv(
                    self.engine.recv_async(src, tag, dtype=dt,
                                           shape=shape), dt, shape)

        def wait_dep(op):
            dep = self._op_dep(op)
            if dep is None:
                return None
            tag, src, (dt, shape) = dep
            pr = recvs.pop(tag, None)
            kind, mb, c = op
            with timeline.span("pp", "bubble", rank=self.rank,
                               stage=self.stage, mb=mb, tag=tag):
                if pr is not None:
                    return pr.handle.wait()
                return self.engine.recv_from(src, tag, dtype=dt,
                                             shape=shape)

        def push_send(rank: int, t: torch.Tensor, tag: str) -> None:
            h = self.engine.send_async(rank, t.detach().cpu().contiguous(),
                                       tag)
            sends.append(h)
            while len(sends) > _MAX_INFLIGHT_SENDS:
                sends.pop(0).wait()

        ensure_recv(0)
        for idx, op in enumerate(ops):
            ensure_recv(idx + 1)
            kind, mb, c = op
            vs = c * self._S + self.stage
            mod, params = self.mods[c], self.params[c]
            if kind == "F":
                x = ids_mb[mb] if vs == 0 else wait_dep(op)
                x_in[(mb, c)] = x
                if vs < self._V - 1:
                    with timeline.span("pp", "fwd", rank=self.rank,
                                       stage=self.stage, mb=mb, chunk=c):
                        out = mod.forward(params, x)
                    push_send(self._peer_rank(self._phys(vs + 1)), out,
                              self._act_tag(mb, vs + 1))
                # last virtual stage: forward work happens fused into
                # the loss gradient at B — the schedule's B follows at once
                continue
            # backward
            x = x_in.pop((mb, c))
            if vs == self._V - 1:
                with timeline.span("pp", "bwd", rank=self.rank,
                                   stage=self.stage, mb=mb, chunk=c):
                    loss, dparams, dx = mod.loss_backward(
                        params, x, tgt_mb[mb])
                losses.append(float(loss))
            else:
                dout = wait_dep(op)
                with timeline.span("pp", "bwd", rank=self.rank,
                                   stage=self.stage, mb=mb, chunk=c):
                    dparams, dx = mod.backward(params, x, dout)
            if vs > 0:
                push_send(self._peer_rank(self._phys(vs - 1)), dx,
                          self._grad_tag(mb, vs - 1))
            grads[c] = dparams if grads[c] is None else \
                tree_map(torch.add, grads[c], dparams)
            b_done[c] += 1
            if b_done[c] == m:
                # this chunk's gradient is final: issue its DP
                # reduce-scatter NOW — the send rides the remaining
                # drain (the bubble hides the DP wire)
                dp_pending.append(self._dp_sync_begin(c, grads[c]))

        for h in sends:
            h.wait()
        for pend in dp_pending:
            self._dp_sync_finish(pend)
        self._step += 1
        return float(np.mean(losses)) if losses else None

    # -- DP gradient sync ---------------------------------------------------
    def _bucket_spans(self, width: int) -> List[Tuple[int, int]]:
        nb = min(self._n_buckets, max(1, width))
        base, rem = divmod(width, nb)
        spans, off = [], 0
        for b in range(nb):
            w = base + (1 if b < rem else 0)
            if w:
                spans.append((off, w))
            off += w
        return spans

    def _dp_sync_begin(self, c: int, gtree):
        """Flatten chunk ``c``'s grads to the host and ISSUE the
        per-bucket reduce-scatter sends as async handles; returns the
        pending state ``_dp_sync_finish`` completes.  With dp == 1 there
        is no wire — the pending state is just the local flat."""
        dp = self.plan.dp
        flat = _flat_f32(tree_leaves(self.mods[c].gather(gtree)))
        chunkw = max(1, math.ceil(max(flat.shape[0], 1) / dp))
        padded = np.zeros(dp * chunkw, np.float32)
        padded[: flat.shape[0]] = flat
        view = padded.reshape(dp, chunkw)
        spans = self._bucket_spans(chunkw)
        handles: List[object] = []
        tb = f"{self._tagbase}.t{self._step}.rs.c{c}"
        for b, (off, w) in enumerate(spans):
            for j in range(dp):
                if j == self.dp_index:
                    continue
                h = self.engine.send_async(
                    self._dp_rank(j),
                    np.ascontiguousarray(view[j, off:off + w]),
                    f"{tb}.b{b}.o{self.dp_index}")
                handles.append(h)
                while len(handles) > _MAX_INFLIGHT_SENDS:
                    handles.pop(0).wait()
        return (c, view, spans, handles)

    def _dp_sync_finish(self, pend) -> None:
        """Receive the peers' contributions bucket by bucket (summed in
        dp-member order — the bitwise contract), normalize by
        ``m * dp``, run the optimizer (ZeRO-2: on this member's chunk
        only, then all-gather the updated param chunks; replicated:
        all-gather the reduced grad and update locally).  Bucket b+1's
        recvs are posted before bucket b is summed — the depth-k
        bucket pipeline shape."""
        c, view, spans, handles = pend
        dp, m = self.plan.dp, self.n_micro
        chunkw = view.shape[1]
        tb = f"{self._tagbase}.t{self._step}.rs.c{c}"
        rhs: Dict[Tuple[int, int], object] = {}

        def post(b: int) -> None:
            if b >= len(spans):
                return
            _, w = spans[b]
            for j in range(dp):
                if j != self.dp_index:
                    rhs[(b, j)] = self.engine.recv_async(
                        self._dp_rank(j), f"{tb}.b{b}.o{j}",
                        dtype=np.float32, shape=(w,))

        acc = np.zeros(chunkw, np.float32)
        post(0)
        for b, (off, w) in enumerate(spans):
            post(b + 1)
            parts = [view[self.dp_index, off:off + w] if j == self.dp_index
                     else rhs.pop((b, j)).wait() for j in range(dp)]
            s = parts[0].copy()
            for p in parts[1:]:
                s += p
            acc[off:off + w] = s
        for h in handles:
            h.wait()
        acc /= (m * dp)
        self._apply_update(c, acc, chunkw)

    def _apply_update(self, c: int, grad_chunk: np.ndarray,
                      chunkw: int) -> None:
        """Optimizer step from MY reduced gradient chunk, on the stage's
        device.  ZeRO-2: elementwise update on the chunk, all-gather the
        updated param chunks (each member's optimizer state never
        exceeds 1/dp of the stage).  Replicated: all-gather the reduced
        grad chunks to the full gradient and update the whole tree."""
        dp = self.plan.dp
        mod = self.mods[c]
        dev = mod.device
        total = self._flat_shapes[c]
        gparams = mod.gather(self.params[c])
        leaves, treedef = tree_flatten(gparams)

        def exchange_chunks(mine: np.ndarray, what: str) -> np.ndarray:
            """All-gather equal chunks over the dp group (member order);
            returns the concatenated [dp*chunkw] flat."""
            tb = f"{self._tagbase}.t{self._step}.{what}.c{c}"
            hs, pending = [], {}
            for j in range(dp):
                if j == self.dp_index:
                    continue
                hs.append(self.engine.send_async(
                    self._dp_rank(j), np.ascontiguousarray(mine),
                    f"{tb}.o{self.dp_index}"))
                pending[j] = self.engine.recv_async(
                    self._dp_rank(j), f"{tb}.o{j}", dtype=np.float32,
                    shape=(chunkw,))
            full = np.zeros(dp * chunkw, np.float32)
            for j in range(dp):
                full[j * chunkw:(j + 1) * chunkw] = (
                    mine if j == self.dp_index else pending[j].wait())
            for h in hs:
                h.wait()
            return full

        if self.plan.zero_stage == 2:
            padded = torch.zeros(dp * chunkw, dtype=torch.float32,
                                 device=dev)
            if leaves:
                padded[:total] = torch.cat([l.reshape(-1).float()
                                            for l in leaves])
            mine = padded[self.dp_index * chunkw:
                          (self.dp_index + 1) * chunkw]
            upd, self.opt_state[c] = self.inner.update(
                torch.from_numpy(grad_chunk).to(dev), self.opt_state[c],
                mine)
            new_mine = _np(apply_updates(mine, upd))
            new_flat = (exchange_chunks(new_mine, "ag") if dp > 1
                        else new_mine)[:total]
            self.params[c] = mod.place(_unflatten_like(
                leaves, treedef, torch.from_numpy(new_flat).to(dev)))
            return
        gfull = (exchange_chunks(grad_chunk, "gg")
                 if dp > 1 else grad_chunk)[:total]
        gtree = _unflatten_like(leaves, treedef,
                                torch.from_numpy(gfull).to(dev))
        upd, self.opt_state[c] = self.inner.update(
            gtree, self.opt_state[c], gparams)
        self.params[c] = mod.place(apply_updates(gparams, upd))

    # -- elastic boundary ---------------------------------------------------
    def commit_boundary(self, boundary: StageBoundary) -> None:
        """Commit this rank's stage state at the CURRENT step (call
        right after a completed ``train_step``).  v == 1 only: the
        interleaved variant's chunks have no single contiguous stage
        flat to re-carve (schedule-level feature, not an elastic one)."""
        if self.v != 1:
            raise ValueError(
                "stage boundaries support the non-interleaved pipeline "
                "(one chunk per stage)")
        boundary.commit(
            self._step, self.cfg, self.stage, self._S, self.plan.dp,
            self.dp_index, self.mods[0].gather(self.params[0]),
            self.opt_state[0], self.plan.zero_stage)

    @classmethod
    def from_boundary(cls, engine, plan, cfg, boundary: StageBoundary,
                      *, inner=None, device=None, peer=None,
                      n_buckets: int = 2) -> "HostPipeline":
        """Rebuild a pipeline for the post-re-carve world from a
        re-carved :class:`StageBoundary` (params AND ZeRO-2 optimizer
        chunks restored bitwise)."""
        stage, n, params, opt = boundary.restore()
        if plan.pp != n:
            raise ValueError(
                f"plan.pp={plan.pp} but the boundary is carved for {n} "
                "stages — recarve first")
        pipe = cls(engine, plan, cfg, stage_params=params, inner=inner,
                   device=device, peer=peer, n_buckets=n_buckets)
        if opt is not None:
            dev = pipe.mods[0].device
            pipe.opt_state[0] = tree_map(lambda t: t.to(dev), opt)
        pipe._step = boundary.step() or 0
        return pipe

    # -- reporting ----------------------------------------------------------
    @property
    def step_count(self) -> int:
        return self._step

    def stage_layers(self, c: int = 0) -> Tuple[int, int]:
        return self.mods[c].lo, self.mods[c].hi


def merge_stage_trees(cfg, n_stages: int, v: int, trees) -> dict:
    """Reassemble per-virtual-stage param-SHAPED trees (params, or any
    tree mirroring them — an optimizer trace, a gradient) in the global
    layout into the full stacked tree.  ``trees[vs]`` must have the
    stage-subtree structure of virtual stage ``vs``
    (:func:`slice_stage_params`)."""
    S, V = n_stages, n_stages * v
    part = interleaved_partition(cfg.n_layers, S, v)
    full: dict = {}
    layer_rows: List[object] = [None] * cfg.n_layers
    for vs in range(V):
        c, s = vs // S, vs % S
        lo, hi = part[s][c]
        for i, l in enumerate(range(lo, hi)):
            layer_rows[l] = tree_map(lambda a, ii=i: _tensor(a)[ii],
                                     trees[vs]["layers"])
        if vs == 0:
            full["embed"] = trees[vs]["embed"]
            if cfg.pos == "learned":
                full["pos_embed"] = trees[vs]["pos_embed"]
        if vs == V - 1:
            full["ln_f"] = trees[vs]["ln_f"]
            full["head"] = trees[vs]["head"]
    full["layers"] = tree_map(_stack_rows, layer_rows[0], *layer_rows[1:])
    return full


def _lane_passes(cfg, plan, full_params, shards, device):
    """The fixed-world forward and backward of every dp lane through the
    stage modules, and the dp reduction in member order then one
    normalize — the exact numpy math of
    :meth:`HostPipeline._dp_sync_finish`.  Returns ``(mods, params,
    accs, losses)``: ``accs[vs]`` the reduced flat gradient of virtual
    stage ``vs``, ``losses`` each lane's mean microbatch loss."""
    S, v = plan.pp, (plan.interleave
                     if plan.pp_schedule == "interleaved" else 1)
    V = S * v
    m = plan.n_micro or S
    dp = plan.dp
    part = interleaved_partition(cfg.n_layers, S, v)
    mods, params = [], []
    for vs in range(V):
        c, s = vs // S, vs % S
        lo, hi = part[s][c]
        mod = StageModule(cfg, lo, hi, first=vs == 0, last=vs == V - 1,
                          tp=plan.tp, device=device)
        mods.append(mod)
        params.append(mod.place(slice_stage_params(
            cfg, full_params, lo, hi, vs == 0, vs == V - 1)))
    lane_grads: List[List[object]] = []
    losses = []
    for d in range(dp):
        ids, targets = _np(shards[d][0]), _np(shards[d][1])
        ids_mb = ids.reshape(m, -1, ids.shape[-1])
        tgt_mb = targets.reshape(m, -1, targets.shape[-1])
        acts: Dict[Tuple[int, int], object] = {}
        grads: List[object] = [None] * V
        lane_loss = []
        for mb in range(m):
            x = ids_mb[mb]
            for vs in range(V):
                acts[(vs, mb)] = x
                if vs < V - 1:
                    x = mods[vs].forward(params[vs], x)
        for mb in range(m):
            loss, dparams, dx = mods[V - 1].loss_backward(
                params[V - 1], acts[(V - 1, mb)], tgt_mb[mb])
            lane_loss.append(float(loss))
            grads[V - 1] = dparams if grads[V - 1] is None else \
                tree_map(torch.add, grads[V - 1], dparams)
            for vs in range(V - 2, -1, -1):
                dparams, dx2 = mods[vs].backward(
                    params[vs], acts[(vs, mb)], dx)
                grads[vs] = dparams if grads[vs] is None else \
                    tree_map(torch.add, grads[vs], dparams)
                dx = dx2
        lane_grads.append(grads)
        losses.append(float(np.mean(lane_loss)))
    accs = []
    for vs in range(V):
        flats = [_flat_f32(tree_leaves(mods[vs].gather(lane_grads[d][vs])))
                 for d in range(dp)]
        acc = flats[0].copy()
        for f in flats[1:]:
            acc += f
        acc /= (m * dp)
        accs.append(acc)
    return mods, params, accs, losses


def pipeline_gradients(cfg, plan, full_params, shards, device=None):
    """``(grads, losses)``: the dp-mean gradient one pipeline step
    applies, as a full stacked tree, and each lane's mean loss — the
    first half of :func:`reference_pipeline_step` (a port addition, so a
    step's gradient can be held against another path's)."""
    S, v = plan.pp, (plan.interleave
                     if plan.pp_schedule == "interleaved" else 1)
    mods, params, accs, losses = _lane_passes(cfg, plan, full_params,
                                              shards, device)
    trees = []
    for mod, p, acc in zip(mods, params, accs):
        leaves, td = tree_flatten(mod.gather(p))
        trees.append(_unflatten_like(leaves, td,
                                     torch.from_numpy(acc).to(mod.device)))
    return merge_stage_trees(cfg, S, v, trees), losses


def reference_pipeline_step(cfg, plan, full_params, shards, inner,
                            opt_states=None, device=None):
    """Single-process fixed-world reference: the SAME stage modules and
    the SAME dp-member numpy reductions run sequentially — the bitwise
    yardstick the 1F1B tests pin the distributed run against.

    ``shards`` is ``[(ids, targets)]`` per dp lane; returns
    ``(new_full_params, losses_per_lane_mean, opt_states)`` where
    ``opt_states`` (trees in the global layout) round-trips for
    multi-step references.  The update runs on the stage's device,
    elementwise as the ZeRO-2 chunk update."""
    S, v = plan.pp, (plan.interleave
                     if plan.pp_schedule == "interleaved" else 1)
    mods, params, accs, losses = _lane_passes(cfg, plan, full_params,
                                              shards, device)
    new_states = []
    opt_states = opt_states or [None] * len(mods)
    for vs, (mod, acc) in enumerate(zip(mods, accs)):
        gparams = mod.gather(params[vs])
        pleaves, ptd = tree_flatten(gparams)
        gtree = _unflatten_like(pleaves, ptd,
                                torch.from_numpy(acc).to(mod.device))
        st = opt_states[vs] if opt_states[vs] is not None \
            else inner.init(gparams)
        upd, st = inner.update(gtree, st, gparams)
        params[vs] = apply_updates(gparams, upd)
        new_states.append(st)
    full = merge_stage_trees(cfg, S, v, params)
    return full, losses, new_states
