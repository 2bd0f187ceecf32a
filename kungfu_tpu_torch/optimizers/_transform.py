"""The optax subset the training step uses, as functional transforms on
trees of tensors.

A trimmed copy of optax's interface, not an import: a
:class:`GradientTransformation` is an ``(init, update)`` pair,
``update(grads, state, params) -> (updates, new_state)`` returns new
trees and mutates nothing, and :func:`apply_updates` adds updates to
params in the params' dtype.  :func:`sgd` has optax's ``trace``
semantics: ``t <- g + momentum * t``; the update is ``-lr * t`` (or
``-lr * (g + momentum * t)`` with Nesterov).  :func:`adam`,
:func:`adamw` and :func:`scale_by_adam` follow optax's: bias-corrected
moments, ``eps`` outside the square root, an int32 ``count`` that
saturates, and a state laid out as optax's ``chain`` lays it out, so a
state carried over from the reference fills it leaf for leaf.

The transforms are elementwise tree maps: a leaf stacked on a leading
rank axis (a ZeRO shard, ``[n, chunk]``) is updated row by row.  Adam's
``count`` is one 0-d tensor that every rank shares, or, in a state
stacked per replica (``stack_for_replicas``), ``[n]``: each rank's count
then meets its own rows (:func:`~kungfu_tpu_torch.ops.collective.
rank_view`), as each device's scalar does in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from kungfu_tpu_torch.ops.collective import rank_view
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class TraceState(NamedTuple):
    trace: object


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: object
    nu: object


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: the transforms in turn; the state is the tuple of
    theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """``optax.scale_by_adam``: ``mu <- (1-b1) g + b1 mu``, ``nu <-
    (1-b2) g^2 + b2 nu``, and ``mu_hat / (sqrt(nu_hat + eps_root) +
    eps)`` with ``x_hat = x / (1 - b^count)``."""

    def init(params):
        first = tree_leaves(params)[0]
        return ScaleByAdamState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads,
                      state.nu)
        top = torch.iinfo(torch.int32).max
        count = torch.where(state.count < top, state.count + 1, state.count)
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=c.device), c)
        updates = tree_map(
            lambda m, v: (m / rank_view(bc1, m).to(m.dtype))
            / (torch.sqrt(v / rank_view(bc2, v).to(v.dtype) + eps_root)
               + eps), mu, nu)
        return updates, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """``optax.add_decayed_weights``: ``g + weight_decay * p``."""

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_map(lambda g, p: g + weight_decay * p, grads,
                        params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale(step_size: float) -> GradientTransformation:
    """``optax.scale``: every update times ``step_size``."""

    def update(grads, state, params=None):
        del params
        return tree_map(lambda g: step_size * g, grads), state

    return GradientTransformation(lambda params: EmptyState(), update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """``optax.adam`` with a constant learning rate."""
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale(-learning_rate))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw`` with a constant learning rate and no mask."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay), scale(-learning_rate))


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """``optax.sgd`` with a constant learning rate."""

    def init(params):
        if momentum is None:
            return EmptyState()
        return TraceState(tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        if momentum is None:
            return tree_map(lambda g: -learning_rate * g, grads), state
        trace = tree_map(lambda g, t: g + momentum * t, grads, state.trace)
        if nesterov:
            step = tree_map(lambda g, t: g + momentum * t, grads, trace)
        else:
            step = trace
        return tree_map(lambda u: -learning_rate * u, step), TraceState(trace)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``params + updates``, each leaf kept in its param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
