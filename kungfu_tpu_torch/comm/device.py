"""The device-plane communicator, world-1 subset.

Port of the part of ``kungfu_tpu/comm/device.py:116 Communicator`` that
the single-card training step reads: ``devices``, ``size``, ``rank``,
``axis`` (the names the collectives of :mod:`kungfu_tpu_torch.ops` take)
and the allreduce ``strategy``.  One torch device; more than one raises
until the data-parallel slice (port slice 4) brings the
``torch.distributed`` mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES
from kungfu_tpu_torch.utils.device import resolve_device

HOST_AXIS = "kf_host"
LOCAL_AXIS = "kf_local"
GLOBAL_AXES = (HOST_AXIS, LOCAL_AXIS)


class Communicator:
    """One device's world.  ``devices`` defaults to ``[cuda]``; a
    ``"cpu"`` device runs the plain paths on the host."""

    def __init__(self, devices: Optional[Sequence] = None,
                 strategy: str = "psum"):
        devs = [resolve_device(d) for d in (devices or [None])]
        if len(devs) != 1:
            raise NotImplementedError(
                f"a communicator over {len(devs)} devices comes with the "
                "data-parallel slice (port slice 4)")
        self.devices = devs
        self.axis = GLOBAL_AXES
        self.set_strategy(strategy)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        return 0

    @property
    def device(self):
        return self.devices[0]

    @property
    def strategy(self) -> str:
        """Active allreduce schedule (:mod:`kungfu_tpu_torch.ops.schedules`)."""
        return self._strategy

    def set_strategy(self, name: str) -> None:
        if name not in ALLREDUCE_SCHEDULES:
            raise ValueError(
                f"unknown strategy {name!r}; one of {ALLREDUCE_SCHEDULES}")
        self._strategy = name

    def __repr__(self):
        return f"Communicator({self.size} device: {self.device})"
