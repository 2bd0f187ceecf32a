"""Optimizers: the S-SGD wrapper (``sync_sgd.py``) over the functional
optax subset (``_transform.py``)."""

from kungfu_tpu_torch.optimizers._transform import (GradientTransformation,
                                                    apply_updates, sgd)
from kungfu_tpu_torch.optimizers.sync_sgd import synchronous_sgd

__all__ = ["GradientTransformation", "apply_updates", "sgd",
           "synchronous_sgd"]
