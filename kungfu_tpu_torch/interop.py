"""Carry weights and sharded state between the JAX reference and the port.

The reference's parameter pytree is a nested dict of arrays keyed
``embed/table``, ``layer_{i}/wq/w``, ..., ``head/w``; the port keeps the
same keys and the same layouts (dense weights ``[in, out]``), so the
mapping is key for key with no transposes.  Random init cannot match
``jax.random``, so every parity check goes through these functions.  A
ZeRO state (the optimizer shard, a stage-3 parameter shard) crosses with
:func:`sharded_from_jax`, from the reference's global ``[n*chunk]``
arrays to the port's stacked ``[n, chunk]`` rows.

The caller hands the JAX tree over as numpy arrays (``np.asarray`` on
each leaf): this module, like the whole port, never imports jax.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.models.transformer import (TransformerConfig, flatten,
                                                 param_spec, unflatten)
from kungfu_tpu_torch.utils.device import resolve_device
from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten


def params_from_jax(tree, cfg: TransformerConfig, device=None) -> dict:
    """The port's parameters from the reference's tree for ``cfg``, as
    f32 tensors on ``device`` (default ``cuda``).  The mapping is total:
    every reference leaf is consumed and every port parameter filled,
    with matching shapes, or ``ValueError`` names the difference."""
    dev = resolve_device(device)
    flat = flatten(tree)
    spec = {path: shape for path, shape, _ in param_spec(cfg)}
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
    port's parameters; feed it to ``jax.tree_util.tree_map(jnp.asarray,
    ...)`` on the JAX side."""
    return unflatten({path: t.detach().to("cpu", torch.float32).numpy()
                      for path, t in flatten(params).items()})


def sharded_from_jax(leaves: Sequence, template):
    """The port's stacked ZeRO state from the reference's sharded one.

    ``leaves`` are the reference value's leaves in ``jax.tree_util``
    order, as numpy arrays of the global view: a sharded vector leaf is
    ``[n*chunk]`` (an ``opt_shard`` moment, a stage-3 parameter shard),
    a replicated one 0-d (Adam's ``count``).  ``template`` is the port's
    own value of the same structure (``ZeroStep.init_opt`` or
    ``init_params``), whose leaves are ``[n, chunk]`` and 0-d; the result
    has its structure, shapes, dtypes and device, filled from
    ``leaves``.  The optax states and the port's lay their leaves out in
    the same order, so the match is leaf for leaf, or ``ValueError``
    names the difference."""
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
