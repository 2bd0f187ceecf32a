"""Variable broadcast initialization on the device plane.

Port of ``kungfu_tpu/initializer.py:50 device_broadcast``: make every
rank start from (or re-sync to) rank ``root``'s weights.  The port's
ranks are co-resident and stacked (:mod:`kungfu_tpu_torch.ops.collective`),
so the broadcast is the stacked ``where`` + sum over ``axis``.  The
host-channel paths of the reference (``broadcast_parameters``,
``resync_parameters``) need the host plane and come with the elastic
slice.
"""

from __future__ import annotations

from kungfu_tpu_torch.ops import collective


def device_broadcast(params, axis, root: int = 0):
    """Every rank's row of the stacked ``params`` tree replaced by rank
    ``root``'s, over ``axis`` of the current rank world (enter it with
    :meth:`Communicator.world <kungfu_tpu_torch.comm.device.Communicator.world>`);
    outside a world ``params`` is returned."""
    return collective.broadcast(params, axis, root=root)
