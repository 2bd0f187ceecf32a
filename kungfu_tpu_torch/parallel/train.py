"""Training steps over co-resident stacked ranks: the parallel plan, the
in-mesh 4-D ``ShardedTrainer`` and the data-parallel step.

Port of ``kungfu_tpu/parallel/train.py``: ``:52 ParallelPlan``, ``:191
ShardedTrainer`` (dp x pp x sp x tp, + EP over dp; its ranks run in
lockstep, see the class), ``:662 dp_train_step`` and ``:864
stack_for_replicas``.  The steps are functional, as the reference's
jitted ones are: they take trees of tensors and return new trees (the
inputs are not modified).

In ``dp_train_step`` the reference runs the step body under
``shard_map``, one copy per device.  The port runs it for the
communicator's ``n`` ranks in one process: rank ``r`` takes rows
``[r*B/n, (r+1)*B/n)`` of every batch leaf (as ``P(axes)`` splits the
batch), and the ranks' forwards and backwards run one after another.
Their gradients are stacked on a leading rank axis ``[n, ...]`` and
``tx`` reduces them inside :meth:`Communicator.world
<kungfu_tpu_torch.comm.device.Communicator.world>`.  With replicated
params (S-SGD, the monitors) a replicated output (the params, the loss)
is returned once (:func:`~kungfu_tpu_torch.ops.collective.replicated`);
with ``replicated_params=False`` (SMA, AdaptiveSGD) the params, the
optimizer state and the aux state are stacked ``[n, ...]``
(:func:`stack_for_replicas`), rank ``r`` differentiates its own row and
the updates stay stacked.

``zero_stage`` (or a plan with one) routes to
:func:`kungfu_tpu_torch.parallel.zero.zero_train_step`.  A plan with
tp/pp/sp axes raises, naming ``ShardedTrainer`` (one mesh) and the
cross-host pipeline, as the reference's does.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.models.transformer import TransformerConfig, _rope
from kungfu_tpu_torch.monitor.pulse import PulseMonitor
from kungfu_tpu_torch.ops import collective as coll
from kungfu_tpu_torch.ops.collective import (all_reduce, group_all_reduce,
                                             replicated)
from kungfu_tpu_torch.ops.monitor import _sq_norm, rank_sq_norms
from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.ops.schedules import (ALLREDUCE_SCHEDULES,
                                            all_reduce_scheduled)
from kungfu_tpu_torch.ops.xent import token_nll_rows
from kungfu_tpu_torch.optimizers._transform import apply_updates, sgd
from kungfu_tpu_torch.parallel import tp as tpmod
from kungfu_tpu_torch.parallel.mesh import (AXES, AXIS_DP, AXIS_PP, AXIS_SP,
                                            AXIS_TP, MeshPlan)
from kungfu_tpu_torch.parallel.moe import _glorot3, moe_apply
from kungfu_tpu_torch.parallel.pp import SCHEDULES, stage_partition
from kungfu_tpu_torch.parallel.ring import ring_attention
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                         tree_unflatten)


MOE_AUX_COEF = 0.01


@dataclass(frozen=True)
class ParallelPlan:
    """The parallelism configuration: every axis degree, the ZeRO stage
    and the pipeline schedule in one value, consumed by every entry point
    — :class:`ShardedTrainer` (in-mesh dp/pp/sp/tp), :func:`dp_train_step`
    and :func:`~kungfu_tpu_torch.parallel.zero.zero_train_step` (dp and
    ZeRO), and the serving fleet
    (:class:`~kungfu_tpu_torch.serve.scale.ServeFleet`,
    :class:`~kungfu_tpu_torch.serve.engine.InferenceEngine`).

    The host-plane geometry (:attr:`host_size`, :meth:`stage_of`,
    :meth:`stage_ranks`, :meth:`to_slice_topology`) is the reference's
    stage-major layout: pp across slices, dp lanes within each.  It
    validates what the reference validates; ``collective_schedule`` is
    checked by the consumers."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    #: 0 = replicated optimizer; 1/2/3 route the ZeRO family
    zero_stage: int = 0
    #: pipeline microbatches (None -> pp, the minimum that fills it)
    n_micro: Optional[int] = None
    #: pipeline schedule: "1f1b" | "interleaved" | "sequential"
    pp_schedule: str = "1f1b"
    #: model chunks per stage for the interleaved schedule
    interleave: int = 1
    #: allreduce decomposition arm (ops.schedules.ALLREDUCE_SCHEDULES)
    collective_schedule: str = "psum"

    def __post_init__(self):
        for name, v in (("dp", self.dp), ("tp", self.tp),
                        ("pp", self.pp), ("sp", self.sp)):
            if v < 1:
                raise ValueError(f"{name}={v} must be >= 1")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage={self.zero_stage} not in 0..3")
        if self.pp_schedule not in SCHEDULES:
            raise ValueError(
                f"pp_schedule={self.pp_schedule!r}; one of {SCHEDULES}")
        if self.interleave < 1:
            raise ValueError(f"interleave={self.interleave} must be >= 1")
        if self.interleave > 1 and self.pp_schedule != "interleaved":
            raise ValueError(
                "interleave > 1 requires pp_schedule='interleaved'")
        if self.n_micro is not None and self.n_micro < 1:
            raise ValueError(f"n_micro={self.n_micro} must be >= 1")

    # -- shape -------------------------------------------------------------
    @property
    def size(self) -> int:
        """Rank count of the in-mesh form (dp*pp*sp*tp)."""
        return self.dp * self.pp * self.sp * self.tp

    @property
    def host_size(self) -> int:
        """Host-plane world size of the cross-host form: one rank per
        (stage, dp lane); tp/sp ride each rank's local mesh."""
        return self.dp * self.pp

    def mesh_plan(self) -> MeshPlan:
        return MeshPlan(dp=self.dp, pp=self.pp, sp=self.sp, tp=self.tp)

    def build_mesh(self, devices=None):
        return self.mesh_plan().build_mesh(devices)

    # -- pipeline geometry (stage-major = slice-major rank layout) ---------
    def stage_map(self, n_layers: int) -> List[Tuple[int, int]]:
        return stage_partition(n_layers, self.pp)

    def stage_of(self, rank: int) -> int:
        return rank // self.dp

    def dp_index(self, rank: int) -> int:
        return rank % self.dp

    def stage_ranks(self, stage: int) -> List[int]:
        return list(range(stage * self.dp, (stage + 1) * self.dp))

    def to_slice_topology(self):
        """The multislice topology this plan maps onto (pp across slices,
        dp lanes within each), or None when single-stage."""
        if self.pp <= 1:
            return None
        from kungfu_tpu_torch.elastic.slices import SliceTopology

        return SliceTopology(self.pp, self.dp)

    def with_stages(self, pp: int) -> "ParallelPlan":
        """The plan after a stage re-carve: same axes, ``pp`` stages."""
        return _dc_replace(self, pp=pp)

    # -- env contract ------------------------------------------------------
    @classmethod
    def from_env(cls, **overrides) -> "ParallelPlan":
        """Plan from the launch contract: ``KF_PP_STAGES``,
        ``KF_PP_MICROBATCHES`` (0 -> pp), ``KF_PP_SCHEDULE`` (1f1b |
        interleaved | sequential); explicit kwargs win."""
        vals = dict(
            pp=envs.parse_int_env(envs.PP_STAGES, 1),
            n_micro=envs.parse_int_env(envs.PP_MICROBATCHES, 0) or None,
            pp_schedule=(os.environ.get(envs.PP_SCHEDULE, "")
                         or "1f1b").strip().lower(),
        )
        vals.update(overrides)
        return cls(**vals)


# parameter kinds -> (sum axes, replication denominator axes)
_KIND_AXES = {
    # embed / ln_f / head: replicated everywhere; grads live on one stage
    "replicated": ((AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP),
                   (AXIS_DP, AXIS_SP, AXIS_TP)),
    # per-layer params replicated over dp/sp/tp (layernorms, gate)
    "dense_layer": ((AXIS_DP, AXIS_SP, AXIS_TP), (AXIS_DP, AXIS_SP, AXIS_TP)),
    # tp-sharded weights: the tp flows are the enter/exit pair's
    "tp_sharded": ((AXIS_DP, AXIS_SP), (AXIS_DP, AXIS_SP)),
    # expert weights: the dp flows are the all-to-all's transpose
    "expert": ((AXIS_SP, AXIS_TP), (AXIS_DP, AXIS_SP, AXIS_TP)),
}


def _sizes(plan: MeshPlan) -> Dict[str, int]:
    return {AXIS_DP: plan.dp, AXIS_PP: plan.pp, AXIS_SP: plan.sp,
            AXIS_TP: plan.tp}


def _axis_prod(plan: MeshPlan, axes) -> int:
    return math.prod(_sizes(plan)[a] for a in axes)


class PartitionSpec:
    """Which mesh axis shards each dim of a global parameter (``None``:
    the dim is whole on every rank), as ``jax.sharding.PartitionSpec``."""

    def __init__(self, *names: Optional[str]):
        self.names = names

    def __repr__(self):
        return f"P{self.names}"


P = PartitionSpec


def _rank_coords(plan: MeshPlan) -> List[Dict[str, int]]:
    """Mesh coordinates of each rank, mesh-major (dp outermost)."""
    out = []
    for r in range(plan.size):
        r, t = divmod(r, plan.tp)
        r, s = divmod(r, plan.sp)
        d, p = divmod(r, plan.pp)
        out.append({AXIS_DP: d, AXIS_PP: p, AXIS_SP: s, AXIS_TP: t})
    return out


def _rank_slices(shape, spec: PartitionSpec, plan: MeshPlan,
                 coords: Dict[str, int]) -> tuple:
    """The block of a global array of ``shape`` a rank at ``coords``
    holds under ``spec``."""
    sizes = _sizes(plan)
    out = []
    for i, dim in enumerate(shape):
        name = spec.names[i] if i < len(spec.names) else None
        if name is None:
            out.append(slice(None))
            continue
        if dim % sizes[name]:
            raise ValueError(f"dim {i} of {tuple(shape)} is not divisible "
                             f"by {name}={sizes[name]}")
        local = dim // sizes[name]
        out.append(slice(coords[name] * local, (coords[name] + 1) * local))
    return tuple(out)


def shard_stacked(x: torch.Tensor, spec: PartitionSpec, plan: MeshPlan,
                  first: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """A global array as the stacked per-rank blocks ``[n, *local]``
    that the mesh's ranks hold under ``spec`` (only ranks ``[first,
    first + rows)``, ``[rows, *local]``, when ``rows`` is given)."""
    rows = plan.size - first if rows is None else rows
    coords = _rank_coords(plan)[first:first + rows]
    if all(name is None for name in spec.names):
        return x.unsqueeze(0).expand((rows,) + tuple(x.shape)).clone()
    return torch.stack([x[_rank_slices(x.shape, spec, plan, c)]
                        for c in coords])


def gather_stacked(x: torch.Tensor, spec: PartitionSpec,
                   plan: MeshPlan) -> torch.Tensor:
    """Inverse of :func:`shard_stacked`: the global array from the
    stacked blocks (a block replicated over an axis is read from the
    rank at index 0 of it, as the reference's global array shows
    device 0's replica)."""
    sizes = _sizes(plan)
    shape = list(x.shape[1:])
    for i, name in enumerate(spec.names):
        if name is not None:
            shape[i] *= sizes[name]
    out = x.new_empty(shape)
    used = {n for n in spec.names if n is not None}
    for r, c in enumerate(_rank_coords(plan)):
        if any(c[a] for a in AXES if a not in used):
            continue
        out[_rank_slices(shape, spec, plan, c)] = x[r]
    return out


def _tensor(x) -> torch.Tensor:
    """A tensor, or a copy of an array (a reference's, read-only)."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.array(x))


def _stack_layers(layers: List[dict]) -> dict:
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def _rows(t: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    return t if rows is None else t.index_select(0, rows)


def _ln(p, x: torch.Tensor, rows: Optional[torch.Tensor] = None):
    """LayerNorm with stacked per-rank ``[n, D]`` params over stacked
    ``[n, ..., D]`` activations."""
    lead = (1,) * (x.dim() - 2)
    scale, bias = _rows(p["scale"], rows), _rows(p["bias"], rows)
    return nn.layernorm_apply(
        {"scale": scale.reshape(scale.shape[0], *lead, scale.shape[-1]),
         "bias": bias.reshape(bias.shape[0], *lead, bias.shape[-1])}, x)


def _embed(table: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Row gather from stacked per-rank tables ``[n, V, D]`` by stacked
    ids ``[n, ...]``, with ``jnp.take``'s semantics
    (:func:`~kungfu_tpu_torch.models.nn.embedding_apply`)."""
    n = table.shape[0]
    safe, ok = nn.take_index(ids, table.shape[1])
    rank = torch.arange(n, device=ids.device).reshape(
        (n,) + (1,) * (ids.dim() - 1))
    rows = torch.where(ok[..., None], table[rank, safe], float("nan"))
    return rows.to(dtype)


class ShardedTrainer:
    """The in-mesh 4-D training step: dp x pp x sp x tp (+ EP over dp).

    Port of ``kungfu_tpu/parallel/train.py:191 ShardedTrainer``.  The
    reference runs one ``shard_map`` body per device; the port runs the
    same body once over the mesh's ranks stacked on a leading axis, in
    lockstep (tp's sum, sp's K/V rotation, pp's stage hop and EP's
    all-to-all sit inside the forward, so no rank could finish its pass
    before the others).  Every per-rank value is ``[n, ...]``; each op
    acts on all ranks' rows at once (products batched over ranks), and a
    collective is an op on the rank axis whose backward is the
    reference's transpose, so one ``backward()`` over the stacked graph
    gives each rank's gradient of its own loss term, as autodiff inside
    ``shard_map`` does.  The two rank-dependent branches become per-rank
    masks or row partitions: stage 0 picks the embedded input
    (``torch.where`` on the ranks' pp index), and ring attention
    partitions its rows by round branch (:mod:`.ring`).  The head and
    the loss run on the last stage's ranks only: the reference masks the
    other stages' terms, whose gradients are zero.

    ``devices`` is a list of ``plan.size`` devices on one card (or the
    host), or a :class:`~kungfu_tpu_torch.comm.device.Communicator` of
    ``plan.size`` ranks (:meth:`MeshPlan.build_mesh`).  A communicator
    across worker processes gives a mesh across them, the reference's
    default ``jax.devices()`` under ``jax.distributed``: each process
    then runs the lockstep body for the ranks it holds, ``[first, first
    + rows)`` in mesh-major order, every stacked value is ``[rows,
    ...]``, and the collectives inside the forward and backward (tp's
    pair, sp's rotation, pp's hop, EP's all-to-all, the gradient sync)
    cross the processes, differentiably
    (:func:`~kungfu_tpu_torch.ops.collective.lift`).  Every process
    passes the same global batch and calls each method in the same
    order.

    Parameters are stacked per-rank blocks ``[n, *local]`` of the
    reference's global layout (:meth:`shard_params`, :meth:`gather_params`);
    a replicated leaf is a stacked copy per rank, never an ``expand`` of
    one tensor (autograd would sum its gradient implicitly, past the
    scheduled collective).  :meth:`sync_grads` reduces each kind's
    gradients over its axes with ``all_reduce_scheduled`` and divides by
    the replication, as the reference does after its local backprop."""

    def __init__(self, cfg: TransformerConfig,
                 plan: Union[MeshPlan, "ParallelPlan"], n_experts: int = 0,
                 n_micro: Optional[int] = None, tx=None, devices=None,
                 capacity_factor: float = 1.25, schedule: str = "psum",
                 fuse_grads: bool = False):
        if isinstance(plan, ParallelPlan):
            if plan.zero_stage:
                raise ValueError(
                    "ShardedTrainer holds one replicated optimizer over "
                    "the mesh — ZeRO stages route through dp_train_step/"
                    "zero_train_step (device DP) or HostPipeline "
                    "(cross-DCN pp)")
            n_micro = n_micro or plan.n_micro
            if schedule != "psum" and schedule != plan.collective_schedule:
                raise ValueError(
                    f"schedule={schedule!r} disagrees with "
                    f"plan.collective_schedule="
                    f"{plan.collective_schedule!r} — set it in the plan")
            schedule = plan.collective_schedule
            plan = plan.mesh_plan()
        if cfg.pos not in ("rope", "learned"):
            raise ValueError(f"unknown position mode {cfg.pos!r}")
        if cfg.n_layers % plan.pp:
            raise ValueError(f"n_layers {cfg.n_layers} % pp {plan.pp} != 0")
        if cfg.n_heads % plan.tp:
            raise ValueError(f"n_heads {cfg.n_heads} % tp {plan.tp} != 0")
        if cfg.d_ff % plan.tp:
            raise ValueError(f"d_ff {cfg.d_ff} % tp {plan.tp} != 0")
        if n_experts and n_experts % plan.ep:
            raise ValueError(f"n_experts {n_experts} % ep {plan.ep} != 0")
        if schedule not in ALLREDUCE_SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; one of {ALLREDUCE_SCHEDULES}")
        self.cfg = cfg
        self.plan = plan
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.n_micro = n_micro or plan.pp
        self.tx = tx or sgd(0.01)
        #: allreduce decomposition of sync_grads (ops.schedules)
        self.schedule = schedule
        #: one collective per sync kind (exact: the leaves of a kind share
        #: axes and denominator)
        self.fuse_grads = fuse_grads
        self.mesh = plan.build_mesh(devices)
        self.param_specs, self.param_kinds = self._layout()
        #: gradient-signal monitor (None when KF_PULSE_EVERY=0)
        self.pulse = PulseMonitor.from_env()

    # -- parameter layout --------------------------------------------------
    def _layout(self):
        """(PartitionSpec tree, kind tree) of the stacked param tree."""
        moe = self.n_experts > 0
        layer = {
            "ln1": {"scale": (P(AXIS_PP, None), "dense_layer"),
                    "bias": (P(AXIS_PP, None), "dense_layer")},
            "ln2": {"scale": (P(AXIS_PP, None), "dense_layer"),
                    "bias": (P(AXIS_PP, None), "dense_layer")},
            "wq": {"w": (P(AXIS_PP, None, AXIS_TP), "tp_sharded"),
                   "b": (P(AXIS_PP, AXIS_TP), "tp_sharded")},
            "wk": {"w": (P(AXIS_PP, None, AXIS_TP), "tp_sharded"),
                   "b": (P(AXIS_PP, AXIS_TP), "tp_sharded")},
            "wv": {"w": (P(AXIS_PP, None, AXIS_TP), "tp_sharded"),
                   "b": (P(AXIS_PP, AXIS_TP), "tp_sharded")},
            "wo": {"w": (P(AXIS_PP, AXIS_TP, None), "tp_sharded"),
                   "b": (P(AXIS_PP, None), "dense_layer")},
        }
        if moe:
            layer["gate"] = {"w": (P(AXIS_PP, None, None), "dense_layer")}
            layer["w_in"] = (P(AXIS_PP, AXIS_DP, None, None), "expert")
            layer["w_out"] = (P(AXIS_PP, AXIS_DP, None, None), "expert")
        else:
            layer["ffn_in"] = {"w": (P(AXIS_PP, None, AXIS_TP), "tp_sharded"),
                               "b": (P(AXIS_PP, AXIS_TP), "tp_sharded")}
            layer["ffn_out"] = {"w": (P(AXIS_PP, AXIS_TP, None), "tp_sharded"),
                                "b": (P(AXIS_PP, None), "dense_layer")}
        tree = {
            "embed": {"table": (P(None, None), "replicated")},
            "layers": layer,
            "ln_f": {"scale": (P(None), "replicated"),
                     "bias": (P(None), "replicated")},
            "head": {"w": (P(None, None), "replicated")},
        }
        if self.cfg.pos == "learned":
            tree["pos_embed"] = {"table": (P(None, None), "replicated")}

        def split(t, i):
            if isinstance(t, dict):
                return {k: split(v, i) for k, v in t.items()}
            return t[i]

        return split(tree, 0), split(tree, 1)

    # -- init --------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random f32 params drawn on the CPU from ``generator`` (default
        seed 0) in the reference's order, sharded onto the mesh; returns
        ``{"params", "opt_state", "step"}``."""
        cfg = self.cfg
        gen = generator or torch.Generator().manual_seed(0)
        params: Dict[str, Any] = {
            "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model)}
        if cfg.pos == "learned":
            params["pos_embed"] = nn.embedding_init(gen, cfg.max_seq,
                                                    cfg.d_model)
        per_layer = []
        for _ in range(cfg.n_layers):
            lp = {
                "ln1": nn.layernorm_init(cfg.d_model),
                "wq": nn.dense_init(gen, cfg.d_model, cfg.d_model),
                "wk": nn.dense_init(gen, cfg.d_model, cfg.d_model),
                "wv": nn.dense_init(gen, cfg.d_model, cfg.d_model),
                "wo": nn.dense_init(gen, cfg.d_model, cfg.d_model),
                "ln2": nn.layernorm_init(cfg.d_model),
            }
            if self.n_experts:
                lp["gate"] = {"w": nn.normal(gen, (cfg.d_model,
                                                   self.n_experts))}
                lp["w_in"] = _glorot3(gen, (self.n_experts, cfg.d_model,
                                            cfg.d_ff))
                lp["w_out"] = _glorot3(gen, (self.n_experts, cfg.d_ff,
                                             cfg.d_model))
            else:
                lp["ffn_in"] = nn.dense_init(gen, cfg.d_model, cfg.d_ff)
                lp["ffn_out"] = nn.dense_init(gen, cfg.d_ff, cfg.d_model)
            per_layer.append(lp)
        params["layers"] = _stack_layers(per_layer)
        params["ln_f"] = nn.layernorm_init(cfg.d_model)
        params["head"] = nn.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       use_bias=False)
        params = self.shard_params(params)
        return {"params": params, "opt_state": self.tx.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.mesh.device)}

    def shard_params(self, params):
        """A global param tree (tensors or numpy arrays, the reference's
        layout) as stacked per-rank blocks ``[n, *local]`` on the mesh's
        device."""
        dev = self.mesh.device

        def put(x, spec):
            return shard_stacked(_tensor(x).to(dev, torch.float32), spec,
                                 self.plan, self.mesh.first, self.mesh.rows)

        return tree_map(put, params, self.param_specs)

    def gather_params(self, params):
        """Inverse of :meth:`shard_params`: the global tree (what the
        reference's ``jax.device_get`` of its sharded params shows).
        Over a mesh across processes every rank's blocks are gathered
        first (one exchange: every process calls this)."""
        if self.mesh.span is not None:
            leaves, treedef = tree_flatten(params)
            params = tree_unflatten(treedef, self.mesh.span.gather(
                [l.detach().contiguous() for l in leaves]))
        return tree_map(lambda x, spec: gather_stacked(x, spec, self.plan),
                        params, self.param_specs)

    def from_transformer_params(self, tparams):
        """Pack per-layer ``Transformer.init`` params (dense FFN only)
        into the stacked sharded layout — for cross-checks against the
        unsharded model."""
        assert not self.n_experts
        L = self.cfg.n_layers
        stacked = {
            "embed": tparams["embed"],
            "layers": _stack_layers([tparams[f"layer_{i}"]
                                     for i in range(L)]),
            "ln_f": tparams["ln_f"],
            "head": tparams["head"],
        }
        if self.cfg.pos == "learned":
            stacked["pos_embed"] = tparams["pos_embed"]
        return self.shard_params(stacked)

    def shard_batch(self, x) -> torch.Tensor:
        """A global ``[B, S]`` batch leaf as each rank's ``[B/dp, S/sp]``
        block, stacked (``P(dp, sp)``, replicated over pp and tp)."""
        return shard_stacked(_tensor(x).to(self.mesh.device),
                             P(AXIS_DP, AXIS_SP), self.plan, self.mesh.first,
                             self.mesh.rows)

    # -- the per-rank math, all ranks at once ------------------------------
    def _block(self, lp, h, positions):
        """One transformer layer on the stacked local shards: h
        ``[n, B_mb, S_loc, D]`` replicated over tp; returns (h', aux
        ``[n]``)."""
        cfg, plan = self.cfg, self.plan
        dt = cfg.compute_dtype
        H_loc = cfg.n_heads // plan.tp
        n, B, S, _ = h.shape

        x = _ln(lp["ln1"], h)
        x = tpmod.tp_region_enter(x, AXIS_TP)
        q = tpmod.column_dense(lp["wq"], x, dtype=dt)
        k = tpmod.column_dense(lp["wk"], x, dtype=dt)
        v = tpmod.column_dense(lp["wv"], x, dtype=dt)

        def heads(t):
            return t.reshape(n, B, S, H_loc, cfg.head_dim).transpose(2, 3)

        q, k, v = heads(q), heads(k), heads(v)
        if cfg.pos == "rope":
            pos = positions.reshape(n * B, S)
            q, k = _rope(q.reshape(n * B, H_loc, S, cfg.head_dim),
                         k.reshape(n * B, H_loc, S, cfg.head_dim), pos)
            q = q.reshape(n, B, H_loc, S, cfg.head_dim)
            k = k.reshape(n, B, H_loc, S, cfg.head_dim)
        o = ring_attention(q, k, v, causal=cfg.causal, axis=AXIS_SP)
        o = o.transpose(2, 3).reshape(n, B, S, H_loc * cfg.head_dim)
        h = h + tpmod.row_dense(lp["wo"], o, AXIS_TP, dtype=dt)

        x = _ln(lp["ln2"], h)
        if self.n_experts:
            y, aux = moe_apply(
                {"gate": lp["gate"], "w_in": lp["w_in"],
                 "w_out": lp["w_out"]}, x,
                axis=AXIS_DP if plan.ep > 1 else None,
                n_experts_global=self.n_experts,
                capacity_factor=self.capacity_factor, dtype=dt)
        else:
            x = tpmod.tp_region_enter(x, AXIS_TP)
            y = nn.gelu(tpmod.column_dense(lp["ffn_in"], x, dtype=dt))
            y = tpmod.row_dense(lp["ffn_out"], y, AXIS_TP, dtype=dt)
            aux = torch.zeros(n, dtype=torch.float32, device=h.device)
        return h + y, aux

    def _local_loss(self, lparams, ids, targets):
        """Each rank's loss term, stacked: ids/targets ``[n, B_loc,
        S_loc]``.  Returns (own ``[n]``, (nll_term, aux_term)) as the
        reference returns one device's."""
        cfg, plan = self.cfg, self.plan
        n_micro, Pp = self.n_micro, plan.pp
        n, B_loc, S_loc = ids.shape
        assert B_loc % n_micro == 0, (B_loc, n_micro)
        B_mb = B_loc // n_micro
        dev = ids.device
        dt = cfg.compute_dtype

        pp_host = coll.peer_rank(AXIS_PP).tolist()
        sp_idx = coll.axis_index(AXIS_SP, dev)
        pp_idx = coll.axis_index(AXIS_PP, dev)
        pos = sp_idx[:, None] * S_loc + torch.arange(S_loc, device=dev)
        positions = pos[:, None, :].expand(n, B_mb, S_loc)

        ids_mb = ids.reshape(n, n_micro, B_mb, S_loc)
        tgt_mb = targets.reshape(n, n_micro, B_mb, S_loc)
        h0 = _embed(lparams["embed"]["table"], ids_mb, dt)
        if cfg.pos == "learned":
            # positions carry the sp-global offsets, so the learned table
            # lookup is shard-correct under sequence parallelism too
            pe = _embed(lparams["pos_embed"]["table"], positions, dt)
            h0 = h0 + pe[:, None]

        # each layer's params sliced once a step: one backward op a leaf,
        # where a slice at every tick would zero-fill the whole stacked
        # leaf's gradient each time
        leaves, ldef = tree_flatten(lparams["layers"])
        per_layer = [tree_unflatten(ldef, list(ts))
                     for ts in zip(*(t.unbind(1) for t in leaves))]

        def stage_fn(x):
            aux = torch.zeros(n, dtype=torch.float32, device=dev)
            for lp in per_layer:
                x, a = self._block(lp, x, positions)
                aux = aux + a
            return x, aux

        # GPipe ticks: microbatch m leaves the last stage at m + Pp - 1
        T = n_micro + Pp - 1
        first = (pp_idx == 0).reshape(n, 1, 1, 1)
        perm = [(j, j + 1) for j in range(Pp - 1)]
        buf = torch.zeros_like(h0[:, 0])
        outs, auxs = [], []
        for t in range(T):
            x_t = h0[:, t] if t < n_micro else torch.zeros_like(buf)
            inp = torch.where(first, x_t, buf) if Pp > 1 else x_t
            out, aux = stage_fn(inp)
            if Pp > 1 and t < T - 1:
                buf = coll.ppermute(out, AXIS_PP, perm)
            outs.append(out)
            auxs.append(aux)
        valid_outs = torch.stack(outs[Pp - 1:Pp - 1 + n_micro], dim=1)

        # the head and the loss on the last stage's ranks only: the
        # others' terms are masked to zero in the reference
        last = [r for r in range(n) if pp_host[r] == Pp - 1]
        rows = None if len(last) == n else coll.index_tensor(last, dev)
        hf = _ln(lparams["ln_f"], _rows(valid_outs, rows), rows)
        w = _rows(lparams["head"]["w"], rows)
        wdt = torch.promote_types(hf.dtype, w.dtype)
        logits = tpmod._matmul(hf.to(wdt), w.to(wdt)).float()
        # fused-or-plain NLL: one launch over every last-stage rank's
        # rows, then each rank's mean over its own tokens
        nll_rows = token_nll_rows(logits, _rows(tgt_mb, rows))
        nll_own = nll_rows.reshape(nll_rows.shape[0], -1).mean(dim=1)
        nll_term = (nll_own if rows is None else torch.zeros(
            n, dtype=torch.float32, device=dev).index_copy(0, rows, nll_own))

        # aux from ticks where this stage processed a real microbatch
        t_idx = torch.arange(T, device=dev)
        valid = (t_idx >= pp_idx[:, None]) & (t_idx < pp_idx[:, None]
                                               + n_micro)
        aux_term = (torch.stack(auxs, dim=1) * valid).sum(dim=1) / n_micro

        own = nll_term + MOE_AUX_COEF * aux_term
        return own, (nll_term, aux_term)

    def sync_grads(self, grads):
        """Each kind's gradients summed over its axes and divided by its
        replication, per leaf or (``fuse_grads``) one fused buffer a
        kind; called inside the mesh's world."""
        plan = self.plan
        if not self.fuse_grads:
            def f(g, kind):
                axes, denom_axes = _KIND_AXES[kind]
                g = all_reduce_scheduled(g, axes, op="sum",
                                         schedule=self.schedule)
                return g / _axis_prod(plan, denom_axes)

            return tree_map(f, grads, self.param_kinds)

        flat_g, treedef = tree_flatten(grads)
        flat_k = tree_leaves(self.param_kinds)
        for kind in sorted(set(flat_k)):
            idxs = [i for i, k in enumerate(flat_k) if k == kind]
            buf, spec = fuse([flat_g[i] for i in idxs], batch_axes=1)
            axes, denom_axes = _KIND_AXES[kind]
            buf = all_reduce_scheduled(buf, axes, op="sum",
                                       schedule=self.schedule)
            buf = buf / _axis_prod(plan, denom_axes)
            for i, g in zip(idxs, defuse(buf, spec)):
                flat_g[i] = g
        return tree_unflatten(treedef, flat_g)

    # -- the step ----------------------------------------------------------
    def _pure_dp(self) -> bool:
        """True when the mesh is data-parallel only: the shape where the
        two-batch GNS pair is defined."""
        p = self.plan
        return (p.pp == 1 and p.sp == 1 and p.tp == 1
                and self.n_experts == 0)

    def _batch(self, batch):
        ids, targets = batch
        return self.shard_batch(ids), self.shard_batch(targets)

    @staticmethod
    def _report(term: torch.Tensor) -> torch.Tensor:
        """The stage-masked terms gathered into the global mean: summed
        over pp, averaged over dp, sp and tp (every rank then holds it)."""
        t = coll.all_reduce(term, AXIS_PP)
        return coll.replicated(coll.all_reduce(t, (AXIS_DP, AXIS_SP, AXIS_TP),
                                               op="mean"))

    def _run(self, state, batch, with_pulse: bool):
        ids, targets = self._batch(batch)
        params = state["params"]
        leaves, treedef = tree_flatten(params)
        own_leaves = [l.detach().requires_grad_(True) for l in leaves]
        with self.mesh.world():
            own, (nll, aux) = self._local_loss(
                tree_unflatten(treedef, own_leaves), ids, targets)
            raw = torch.autograd.grad(own.sum(), own_leaves,
                                      allow_unused=True)
            grads = tree_unflatten(treedef, [
                torch.zeros_like(l) if g is None else g
                for g, l in zip(raw, own_leaves)])
            del raw, own
            gl = None
            if with_pulse and self._pure_dp():
                # small-batch side: each rank's full-replica gradient
                # square norm, meaned over the dp ranks
                sq = sum((g.float().square().reshape(g.shape[0], -1).sum(1)
                          for g in tree_leaves(grads)))
                gl = coll.replicated(coll.all_reduce(sq, AXIS_DP, op="mean"))
            grads = self.sync_grads(grads)
            group_sq = {}
            if with_pulse:
                # per-kind |g|^2 of the synced gradients: replicated over
                # the kind's sum axes and sharded over the rest
                flat_k = tree_leaves(self.param_kinds)
                flat_g = tree_leaves(grads)
                for kind in sorted(set(flat_k)):
                    s = sum(g.float().square().reshape(g.shape[0], -1).sum(1)
                            for g, k in zip(flat_g, flat_k) if k == kind)
                    shard_axes = tuple(a for a in AXES
                                       if a not in _KIND_AXES[kind][0])
                    if shard_axes:
                        s = coll.all_reduce(s, shard_axes)
                    group_sq[kind] = coll.replicated(s)
            loss = self._report(nll.detach()) + MOE_AUX_COEF * self._report(
                aux.detach())
        params = tree_unflatten(treedef, [l.detach() for l in own_leaves])
        updates, opt_state = self.tx.update(grads, state["opt_state"], params)
        new = {"params": apply_updates(params, updates),
               "opt_state": opt_state, "step": state["step"] + 1}
        return new, loss, group_sq, gl, grads

    def step(self, state, batch):
        """One full training step; batch = (ids, targets), global
        ``[B, S]``.  Returns (new state, loss)."""
        mon = self.pulse
        if mon is not None and mon.should_sample():
            new, loss, group_sq, gl, _ = self._run(state, batch, True)
            self._publish_pulse(mon, group_sq, gl, int(batch[0].shape[0]))
            return new, loss
        return self._run(state, batch, False)[:2]

    def _publish_pulse(self, mon, group_sq, gl, global_batch: int) -> None:
        norms = {k: math.sqrt(max(0.0, float(v)))
                 for k, v in group_sq.items()}
        if self._pure_dp():
            n = int(self.plan.dp)
            gg = sum(float(group_sq[k]) for k in sorted(group_sq))
            b_small = max(1, global_batch // max(1, n))
            mon.update(float(gl), gg, b_small, n, group_norms=norms)
        else:
            # sharded meshes: no rank holds a full small-batch gradient,
            # so only the per-kind norms publish
            mon.publish_norms(norms)

    def loss(self, state, batch) -> torch.Tensor:
        """Global loss (nll + aux) without updating."""
        ids, targets = self._batch(batch)
        with torch.no_grad(), self.mesh.world():
            _, (nll, aux) = self._local_loss(state["params"], ids, targets)
            return self._report(nll) + MOE_AUX_COEF * self._report(aux)


def split_batch(batch, n: int) -> List:
    """Rank ``r``'s shard of every batch leaf: rows ``[r*B/n, (r+1)*B/n)``
    (views); a 0-d leaf goes to every rank whole, as ``P()``."""
    leaves, treedef = tree_flatten(batch)
    for l in leaves:
        if l.dim() and l.shape[0] % n:
            raise ValueError(f"batch leading axis {l.shape[0]} is not "
                             f"divisible by the {n} ranks")

    def shard(l, r):
        if not l.dim():
            return l
        m = l.shape[0] // n
        return l[r * m:(r + 1) * m]

    return [tree_unflatten(treedef, [shard(l, r) for l in leaves])
            for r in range(n)]


def per_rank_grads(fn: Callable, params, shards: Sequence,
                   sink: Callable, stacked: bool = False) -> tuple:
    """Each rank's forward and backward in turn: ``fn(params, shard_r)``
    (its first output is the scalar loss), then ``sink(r, grads)`` with
    rank ``r``'s gradients as a list in ``tree_flatten`` order, before
    the next rank runs.  With ``stacked`` every params leaf is ``[n,
    ...]`` and rank ``r`` differentiates a detached view of its own row
    ``r``, so its gradients are that row's; otherwise the ranks share
    one tree.  Returns the detached outputs, one per rank, and the
    detached params."""
    leaves, treedef = tree_flatten(params)
    shared = None if stacked else [l.detach().requires_grad_(True)
                                   for l in leaves]
    outs = []
    for r, shard in enumerate(shards):
        own = ([l[r].detach().requires_grad_(True) for l in leaves]
               if stacked else shared)
        out = fn(tree_unflatten(treedef, own), shard)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, own, allow_unused=True)
        sink(r, [torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, own)])
        outs.append(tree_map(lambda t: t.detach(), out))
    return outs, tree_unflatten(treedef, [l.detach() for l in leaves])


def stack_ranks(rows: Sequence):
    """Stack per-rank trees on a new leading rank axis (a view when there
    is one rank)."""
    if len(rows) == 1:
        return tree_map(lambda a: a[None], rows[0])
    return tree_map(lambda *a: torch.stack(a), *rows)


def stack_for_replicas(tree, n: int):
    """``tree`` tiled onto a leading replica axis ``[n, ...]`` (copies),
    for ``dp_train_step(replicated_params=False)``: the params, and the
    optimizer state from ``tx.init`` of the unstacked params."""
    return tree_map(
        lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)).contiguous(),
        tree)


def _stacked_grads(fn, params, shards, stacked: bool = False):
    """Per-rank gradients stacked ``[n, ...]`` per leaf; each rank's row
    is copied in as soon as its backward ends."""
    n = len(shards)
    _, treedef = tree_flatten(params)
    store = []

    def sink(r, grads):
        if n == 1:
            store.extend(g[None] for g in grads)
            return
        if not store:
            store.extend(g.new_empty((n,) + tuple(g.shape)) for g in grads)
        for s, g in zip(store, grads):
            s[r].copy_(g)

    outs, params = per_rank_grads(fn, params, shards, sink, stacked)
    return outs, tree_unflatten(treedef, store), params


def _check_plan(zero_stage, plan):
    if plan is not None:
        if plan.tp != 1 or plan.pp != 1 or plan.sp != 1:
            raise ValueError(
                f"dp_train_step is the dp-only entrypoint but the plan "
                f"carries tp={plan.tp} pp={plan.pp} sp={plan.sp} — use "
                "ShardedTrainer (one mesh) or HostPipeline (cross-DCN)")
        if zero_stage is not None and zero_stage != plan.zero_stage:
            raise ValueError(f"zero_stage={zero_stage} disagrees with "
                             f"plan.zero_stage={plan.zero_stage}")
        if not plan.zero_stage and plan.collective_schedule != "psum":
            raise ValueError(
                f"dp_train_step's replicated step has no "
                f"{plan.collective_schedule!r} arm — use ShardedTrainer "
                "(in-mesh schedule arms) or a ZeRO stage (bucket "
                "schedules)")
        zero_stage = plan.zero_stage or None
    return zero_stage


def dp_train_step(loss_fn, tx, comm, replicated_params: bool = True,
                  has_aux: bool = False, donate: bool = False,
                  zero_stage: Optional[int] = None, plan=None):
    """Pure data-parallel training step over a
    :class:`~kungfu_tpu_torch.comm.device.Communicator` of ``n`` ranks.

    ``loss_fn(params, batch) -> scalar`` runs per rank on its batch
    shard (or, with ``has_aux=True``, ``loss_fn(params, aux, batch) ->
    (loss, new_aux)`` and ``step(params, aux, opt_state, batch) ->
    (params, aux, opt_state, loss)``; the floating aux leaves are
    averaged over the ranks).  ``tx`` is any
    :mod:`kungfu_tpu_torch.optimizers` transform over ``comm.axis``; it
    does the gradient or weight collective.  ``donate`` is accepted for
    the reference's signature: the port's step allocates new trees and
    the caller frees the old ones by dropping them.

    ``replicated_params=False`` (SMA, AdaptiveSGD: each replica owns
    diverging weights) takes ``params``, ``opt_state`` and, with
    ``has_aux``, ``aux`` stacked on a leading ``comm.addressable_n``
    axis (:func:`stack_for_replicas`) and returns them stacked; rank
    ``r`` trains its row, and the pulse monitor stays off.

    Over a communicator across processes every process passes the
    global batch and runs the forward and backward of the ranks it holds
    (:attr:`~kungfu_tpu_torch.comm.device.Communicator.addressable_n`
    from :attr:`~kungfu_tpu_torch.comm.device.Communicator.first_rank`)
    on their shards; the collectives cross the processes.  Per-replica
    params, aux and optimizer state are then this process's rows
    ``[addressable_n, ...]`` (the reference's ``P(axis)`` addressable
    slice), and the weight averages of SMA and AdaptiveSGD, like the
    monitors' reductions, run across the processes.

    ``zero_stage`` (1/2/3), or ``plan.zero_stage``, returns
    :func:`~kungfu_tpu_torch.parallel.zero.zero_train_step` with ``tx``
    as the inner elementwise transform; a plan's ``pallas_ring`` arm
    becomes its bucket schedule.

    With ``KF_PULSE_EVERY`` > 0 (default 10) every ``every``-th step
    also publishes the gradient-norm pulse
    (:class:`~kungfu_tpu_torch.monitor.pulse.PulseMonitor`, exposed as
    ``step.pulse``); the noise scale is ``None`` at one rank."""
    del donate
    zero_stage = _check_plan(zero_stage, plan)
    if zero_stage is not None:
        if has_aux or not replicated_params:
            raise ValueError(
                "a ZeRO stage composes with the plain replicated-params, "
                "no-aux step only (the sharded update is elementwise over "
                "the fused flat buffer)")
        from kungfu_tpu_torch.parallel.zero import zero_train_step

        zsched = ("pallas_ring" if plan is not None
                  and plan.collective_schedule == "pallas_ring" else "lax")
        return zero_train_step(loss_fn, tx, comm, stage=zero_stage,
                               schedule=zsched)
    axis, n = comm.axis, comm.size
    stacked = not replicated_params
    # a communicator across processes: this process runs the ranks it
    # holds, on their shards of the global batch every process passes
    lo, hold = comm.first_rank, comm.addressable_n

    def body(params, aux, opt_state, batch, pulse: bool):
        shards = split_batch(batch, n)[lo:lo + hold]
        if has_aux:
            # each rank passes its own aux row when the aux is stacked
            rows = ([tree_map(lambda a: a[r], aux) for r in range(hold)]
                    if stacked else [aux] * hold)
            outs, grads, params = _stacked_grads(
                lambda p, ab: loss_fn(p, ab[0], ab[1]), params,
                list(zip(rows, shards)), stacked)
            losses = torch.stack([o[0] for o in outs])
            aux_rows = stack_ranks([o[1] for o in outs])
        else:
            outs, grads, params = _stacked_grads(loss_fn, params, shards,
                                                 stacked)
            losses = torch.stack(outs)
        with comm.world():
            new_aux = aux
            if has_aux:
                # replicas average floating aux state, as they do gradients
                new_aux = tree_map(
                    lambda a: (all_reduce(a, axis, op="mean")
                               if a.is_floating_point() else a), aux_rows)
                if not stacked:
                    new_aux = replicated(new_aux)
            stats = None
            if pulse:
                # small-batch side: each rank's square norm, meaned over
                # the ranks; large-batch side: the mean gradient's
                stats = (replicated(all_reduce(rank_sq_norms(grads), axis,
                                               op="mean")),
                         _sq_norm(replicated(group_all_reduce(
                             grads, axis, op="mean"))))
            updates, new_state = tx.update(grads, opt_state, params)
            if not stacked:
                # a tx that does not reduce leaves the updates stacked:
                # the replicated params take rank 0's, as P() takes
                # device 0's
                updates = tree_map(
                    lambda u, p: (replicated(u) if u.dim() == p.dim() + 1
                                  else u), updates, params)
            new_params = apply_updates(params, updates)
            loss = replicated(all_reduce(losses, axis, op="mean"))
        return new_params, new_aux, new_state, loss, stats

    if has_aux:
        def step4(params, aux, opt_state, batch):
            return body(params, aux, opt_state, batch, False)[:4]

        return step4

    # diverged replicas (SMA, AdaptiveSGD) are no small/large-batch
    # pair: only the replicated step samples the pulse
    mon = PulseMonitor.from_env() if replicated_params else None

    def step(params, opt_state, batch):
        sample = mon is not None and mon.should_sample()
        p, _, s, loss, stats = body(params, None, opt_state, batch, sample)
        if sample:
            gl, gg = (float(x) for x in stats)
            leaves = tree_leaves(batch)
            b_small = (max(1, int(leaves[0].shape[0]) // n)
                       if (leaves and n) else 1)
            mon.update(gl, gg, b_small, n,
                       group_norms={"flat": max(0.0, gg) ** 0.5})
        return p, s, loss

    step.pulse = mon
    return step
