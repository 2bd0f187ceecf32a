"""The host-plane PyTorch binding (port of ``kungfu_tpu/torch/``, the
reference's ``srcs/python/kungfu/torch``).

``SynchronousSGDOptimizer`` wraps any ``torch.optim`` optimizer so that
``step()`` first allreduces every gradient, ``broadcast_parameters``
gives every rank rank 0's parameters, and the collectives run over the
port's host :class:`~kungfu_tpu_torch.comm.engine.CollectiveEngine`.  A
tensor on the card is copied to the host, goes through the engine and
comes back to its own device: this path never uses NCCL, and a result
never stays on the CPU in place of a card tensor.  Results are the
reference's bit for bit on the same inputs and engines.
"""

from kungfu_tpu_torch.torch.ops.collective import (  # noqa: F401
    all_gather,
    all_reduce,
    all_reduce_async,
    broadcast,
    broadcast_parameters,
    wait_all_handles,
)
from kungfu_tpu_torch.torch.optimizers.sync_sgd import (  # noqa: F401
    SynchronousSGDOptimizer,
)
