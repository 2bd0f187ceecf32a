"""Optimizers: the S-SGD wrapper (``sync_sgd.py``) over the functional
optax subset (``_transform.py``)."""

from kungfu_tpu_torch.optimizers._transform import (GradientTransformation,
                                                    adam, adamw,
                                                    apply_updates, chain,
                                                    scale_by_adam, sgd)
from kungfu_tpu_torch.optimizers.sync_sgd import synchronous_sgd

__all__ = ["GradientTransformation", "adam", "adamw", "apply_updates",
           "chain", "scale_by_adam", "sgd", "synchronous_sgd"]
