"""The synchronous-SGD torch optimizer wrapper (port of
``kungfu_tpu/torch/optimizers/sync_sgd.py``, reference
``kungfu/torch/optimizers/sync_sgd.py:6-32``).

A dynamic subclass of the user's optimizer whose ``step()`` first
allreduces every parameter's gradient (mean by default) over the host
engine, launched per parameter and awaited together, then runs the
wrapped update.  A gradient on the card stays on the card.
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch.torch.ops import collective


def _sync_gradients(optimizer: torch.optim.Optimizer, op: str,
                    engine) -> None:
    # one name per parameter (the reference keys collectives by tensor
    # name); every handle completes before the next step reuses a name
    handles = []
    idx = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                continue
            handles.append(
                collective.all_reduce_async(
                    p.grad, op=op, engine=engine, name=f"torch.grad.{idx}"
                )
            )
            idx += 1
    collective.wait_all_handles(handles)


def SynchronousSGDOptimizer(optimizer: torch.optim.Optimizer,
                            op: str = "mean",
                            engine=None) -> torch.optim.Optimizer:
    """Wrap any ``torch.optim.Optimizer`` so that ``step()`` synchronizes
    gradients first.  Changes ``optimizer``'s class in place (the
    reference's dynamic subclass) and returns it.  ``op='mean'`` averages
    the gradients; ``op='sum'`` leaves the scaling to the learning
    rate."""
    base = optimizer.__class__

    class _KungFuSynchronousSGD(base):  # type: ignore[valid-type, misc]
        def step(self, closure=None):
            _sync_gradients(self, self._kf_op, self._kf_engine)
            return super().step(closure)

    _KungFuSynchronousSGD.__name__ = "KungFu" + base.__name__
    optimizer.__class__ = _KungFuSynchronousSGD
    optimizer._kf_op = op
    optimizer._kf_engine = engine
    return optimizer
