"""The optax subset the training step uses, as functional transforms on
trees of tensors.

A trimmed copy of optax's interface, not an import: a
:class:`GradientTransformation` is an ``(init, update)`` pair,
``update(grads, state, params) -> (updates, new_state)`` returns new
trees and mutates nothing, and :func:`apply_updates` adds updates to
params in the params' dtype.  :func:`sgd` has optax's ``trace``
semantics: ``t <- g + momentum * t``; the update is ``-lr * t`` (or
``-lr * (g + momentum * t)`` with Nesterov).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from kungfu_tpu_torch.utils.tree import tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class TraceState(NamedTuple):
    trace: object


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
