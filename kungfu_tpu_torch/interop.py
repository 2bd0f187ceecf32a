"""Carry weights and sharded state between the JAX reference and the port.

The reference's parameter pytree is a nested dict of arrays keyed
``embed/table``, ``layer_{i}/wq/w``, ..., ``head/w``; the port keeps the
same keys and the same layouts (dense weights ``[in, out]``), so the
mapping is key for key with no transposes.  Random init cannot match
``jax.random``, so every parity check goes through these functions.
Params stacked per replica (``stack_for_replicas``, ``[n, ...]`` in
both packages) cross with ``replicas=n``.  Any other state (an
optimizer state, stacked or not: ``AdaptiveSGDState``, ``GNSState``,
``GradVarianceState``, ``EMAState``; a ZeRO shard, the reference's
global ``[n*chunk]`` arrays to the port's ``[n, chunk]`` rows) crosses
leaf for leaf with :func:`tree_from_jax` and :func:`tree_to_jax`: the
port's states keep the reference's fields in its order, and both
packages visit dict keys sorted.

A reference ``ShardedTrainer``'s params (the global arrays of its
sharded layout, stacked layers ``[L, ...]``, dense or MoE) cross with
:func:`sharded_params_from_jax` and :func:`sharded_params_to_jax` into
and out of the port's stacked per-rank blocks ``[n, *local]``, with the
port trainer's layout.

The caller hands the JAX tree over as numpy arrays (``np.asarray`` on
each leaf): this module, like the whole port, never imports jax.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.models.transformer import (TransformerConfig, flatten,
                                                 param_spec, unflatten)
from kungfu_tpu_torch.utils.device import resolve_device
from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                         tree_unflatten)


def params_from_jax(tree, cfg: TransformerConfig, device=None,
                    replicas: Optional[int] = None) -> dict:
    """The port's parameters from the reference's tree for ``cfg``, as
    f32 tensors on ``device`` (default ``cuda``); with ``replicas=n``
    every leaf is stacked ``[n, ...]``.  The mapping is total: every
    reference leaf is consumed and every port parameter filled, with
    matching shapes, or ``ValueError`` names the difference."""
    dev = resolve_device(device)
    flat = flatten(tree)
    lead = () if replicas is None else (int(replicas),)
    spec = {path: lead + tuple(shape) for path, shape, _ in param_spec(cfg)}
    missing = sorted(set(spec) - set(flat))
    extra = sorted(set(flat) - set(spec))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {extra}")
    out: Dict[str, torch.Tensor] = {}
    for path, shape in spec.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        out[path] = torch.from_numpy(arr.copy()).to(dev)
    return unflatten(out)


def params_to_jax(params) -> dict:
    """The reference's tree (nested dict of f32 numpy arrays) from the
    port's parameters, stacked or not; feed it to
    ``jax.tree_util.tree_map(jnp.asarray, ...)`` on the JAX side."""
    return unflatten({path: t.detach().to("cpu", torch.float32).numpy()
                      for path, t in flatten(params).items()})


def sharded_params_from_jax(tree, trainer) -> dict:
    """The port's stacked per-rank params for ``trainer`` (a
    :class:`~kungfu_tpu_torch.parallel.train.ShardedTrainer`) from a
    reference ``ShardedTrainer``'s params on the same plan: its global
    arrays as numpy (``jax.device_get``), each cut into the blocks the
    port's ranks hold.  The trees must match leaf for leaf
    (``ValueError`` otherwise), dense or MoE."""
    flat, want = flatten(tree), flatten(trainer.param_specs)
    if set(flat) != set(want):
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(want))}")
    return trainer.shard_params(unflatten(
        {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}))


def sharded_params_to_jax(params, trainer) -> dict:
    """The reference's global param tree (nested dict of f32 numpy
    arrays) from the port trainer's stacked per-rank params; feed it to
    the reference trainer's ``shard_params``."""
    return unflatten({path: t.detach().to("cpu", torch.float32).numpy()
                      for path, t in flatten(
                          trainer.gather_params(params)).items()})


def tree_from_jax(leaves: Sequence, template):
    """A port tree (an optimizer state, a ZeRO state, stacked or not)
    from the reference's value of the same structure.

    ``leaves`` are the reference value's leaves in ``jax.tree_util``
    order, as numpy arrays.  ``template`` is the port's own value of the
    same structure (``tx.init``, ``stack_for_replicas`` of it,
    ``ZeroStep.init_opt``); the result has its structure, shapes, dtypes
    and device, filled from ``leaves``, each reshaped to its slot (the
    reference's global ``[n*chunk]`` ZeRO leaf fills the port's ``[n,
    chunk]``).  The match is leaf for leaf, or ``ValueError`` names the
    difference."""
    slots, treedef = tree_flatten(template)
    if len(leaves) != len(slots):
        raise ValueError(f"{len(leaves)} reference leaves for a state of "
                         f"{len(slots)}")
    out = []
    for i, (arr, slot) in enumerate(zip(leaves, slots)):
        arr = np.asarray(arr)
        if arr.size != slot.numel():
            raise ValueError(f"leaf {i}: {arr.shape} does not fill "
                             f"{tuple(slot.shape)}")
        out.append(torch.from_numpy(arr.reshape(slot.shape).copy()).to(
            device=slot.device, dtype=slot.dtype))
    return tree_unflatten(treedef, out)


def tree_to_jax(tree) -> List[np.ndarray]:
    """The leaves of a port tree as numpy arrays, in the order
    ``jax.tree_util.tree_unflatten`` takes them for the reference's
    value of the same structure."""
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]
