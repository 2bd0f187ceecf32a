from kungfu_tpu_torch.torch.ops.collective import (  # noqa: F401
    all_gather,
    all_reduce,
    all_reduce_async,
    broadcast,
    broadcast_parameters,
    wait_all_handles,
)
