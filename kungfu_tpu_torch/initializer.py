"""Variable broadcast initialization (port of
``kungfu_tpu/initializer.py``): make every worker start from (or re-sync
to) rank ``root``'s weights, at job start and after every elastic
resize.

* :func:`broadcast_parameters` -- worker to worker over the peer's host
  channel, the params fused to one f32 buffer as the reference fuses
  them (works while no mesh exists, as right after a resize);
* :func:`resync_parameters` -- the post-resize re-sync on the device
  plane when the peer has a communicator;
* :func:`device_broadcast` -- over the stacked ranks of a rank world.
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.ops.fuse import defuse, fuse
from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map


def broadcast_parameters(params, peer=None, root: int = 0,
                         name: str = "bcast-params"):
    """Every worker's ``params`` replaced by rank ``root``'s, fused to
    f32 and sent over the host channel (reference
    ``initializer.py:27``); the result lies on the device of ``params``'
    first leaf, each leaf in its own dtype."""
    if peer is None:
        from kungfu_tpu_torch.python import init as _init

        peer = _init()
    if peer.size() <= 1 or peer.channel is None:
        return params
    buf, spec = fuse(params, dtype=torch.float32)
    data = (buf.detach().cpu().contiguous().numpy().tobytes()
            if peer.rank() == root else None)
    # the star broadcast roots at rank 0 of the list: rotate ``root`` first
    workers = peer.cluster.workers
    order = list(range(len(workers)))
    order = order[root:] + order[:root]
    blob = peer.channel.broadcast_bytes(
        data, workers.select(order), name=f"{name}.v{peer.cluster_version}")
    arr = torch.frombuffer(bytearray(blob), dtype=torch.float32)
    return defuse(arr.to(tree_leaves(params)[0].device), spec)


def device_broadcast(params, axis, root: int = 0):
    """Every rank's row of the stacked ``params`` tree replaced by rank
    ``root``'s, over ``axis`` of the current rank world (enter it with
    :meth:`Communicator.world <kungfu_tpu_torch.comm.device.Communicator.world>`);
    outside a world ``params`` is returned."""
    return collective.broadcast(params, axis, root=root)


def resync_parameters(params, peer=None, comm=None, root: int = 0):
    """The post-resize re-sync (reference ``initializer.py:55``): with a
    communicator (``comm``, or the peer's) the params are placed on its
    device, since one controller holds every rank of it and rank
    ``root``'s weights are the ones passed; without one (a detached
    peer) :func:`broadcast_parameters` over the host channel."""
    if comm is None and peer is not None:
        try:
            comm = peer.communicator()
        except RuntimeError:
            comm = None
    if comm is None:
        return broadcast_parameters(params, peer, root=root)
    return tree_map(lambda a: a.to(comm.device, copy=True), params)
