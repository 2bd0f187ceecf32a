from kungfu_tpu_torch.torch.optimizers.sync_sgd import (  # noqa: F401
    SynchronousSGDOptimizer,
)
