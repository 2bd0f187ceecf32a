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

A pipeline's stacked full-model tree (``parallel/pp.py``: ``embed``,
``layers`` with every leaf stacked ``[L, ...]``, ``ln_f``, ``head``)
comes in with :func:`stacked_params_from_jax`, through the same
key-for-key check, and goes back with :func:`params_to_jax`.

A reference ``ShardedTrainer``'s params (the global arrays of its
sharded layout, stacked layers ``[L, ...]``, dense or MoE) cross with
:func:`sharded_params_from_jax` and :func:`sharded_params_to_jax` into
and out of the port's stacked per-rank blocks ``[n, *local]``, with the
port trainer's layout.

The image models' ``(params, bn_state)`` pair (ResNet, VGG, MLP: nested
dicts of f32 arrays, HWIO conv kernels, ``[in, out]`` dense weights)
crosses with :func:`image_params_from_jax` and
:func:`image_params_to_jax`, layouts unchanged.

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
                                         tree_map, tree_unflatten)


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


def stacked_params_from_jax(tree, cfg: TransformerConfig,
                            device=None) -> dict:
    """The port's stacked full-model tree (``parallel.pp``'s layout) from
    the reference's (``pp.init_stacked_params``' tree as numpy arrays),
    as f32 tensors on ``device``: each layer row is checked and carried
    by :func:`params_from_jax`, then stacked again."""
    from kungfu_tpu_torch.parallel.pp import stacked_from_transformer

    per_layer = {k: v for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    n = {np.asarray(a).shape[0] for a in tree_leaves(layers)}
    if n != {cfg.n_layers}:
        raise ValueError(f"stacked layers of {sorted(n)} rows for "
                         f"{cfg.n_layers} layers")
    for i in range(cfg.n_layers):
        per_layer[f"layer_{i}"] = unflatten(
            {k: np.asarray(a)[i] for k, a in flatten(layers).items()})
    return stacked_from_transformer(cfg, params_from_jax(per_layer, cfg,
                                                         device))


def sharded_params_from_jax(tree, trainer) -> dict:
    """The port's stacked per-rank params for ``trainer`` (a
    :class:`~kungfu_tpu_torch.parallel.train.ShardedTrainer`) from a
    reference ``ShardedTrainer``'s params on the same plan: its global
    arrays as numpy (``jax.device_get``), each cut into the blocks the
    port's ranks hold (over a mesh across processes, the blocks of this
    process's ranks).  The trees must match leaf for leaf
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


def image_params_from_jax(params, bn_state=None, device=None):
    """``(params, bn_state)`` of a ResNet, VGG or MLP from the reference's
    trees (nested dicts of numpy arrays), as f32 tensors on ``device``
    (default ``cuda``), key for key and layout for layout; ``bn_state``
    ``None`` (an MLP) comes back ``None``.  A leaf that is not floating
    raises ``ValueError``."""
    dev = resolve_device(device)

    def put(a):
        arr = np.asarray(a)
        if not np.issubdtype(arr.dtype, np.floating):
            raise ValueError(f"image model leaf of dtype {arr.dtype}")
        return torch.from_numpy(arr.astype(np.float32)).to(dev)

    out = tree_map(put, params)
    return out, (None if bn_state is None else tree_map(put, bn_state))


def image_params_to_jax(params, bn_state=None):
    """The inverse of :func:`image_params_from_jax`: nested dicts of
    numpy f32 arrays the reference's ``apply`` takes."""
    get = lambda t: t.detach().to("cpu", torch.float32).numpy()  # noqa: E731
    return (tree_map(get, params),
            None if bn_state is None else tree_map(get, bn_state))


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
