"""Platform adapters: the TPU pod env contract and the slice layouts
over co-resident ranks (port of ``kungfu_tpu/platforms/``)."""

from kungfu_tpu_torch.platforms.tpu_pod import (  # noqa: F401
    PodInfo,
    multislice_communicator,
    parse_tpu_pod_env,
    slice_device_groups,
    slice_mesh_layout,
)
