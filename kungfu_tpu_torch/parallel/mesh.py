"""Mesh plans: named parallel axes over co-resident stacked ranks.

Port of ``kungfu_tpu/parallel/mesh.py``.  A :class:`MeshPlan` factorizes
the rank count into four named axes, outer to inner:

* ``dp`` — data parallelism (the gradient allreduce axis).  Expert
  parallelism rides this axis: MoE experts live one group per dp rank
  and tokens move to them by ``all_to_all`` over it (``ep`` is ``dp``);
* ``pp`` — pipeline parallelism (layer stages; activations hop stage to
  stage by ``ppermute``);
* ``sp`` — sequence parallelism (activations sharded on the sequence;
  ring attention rotates K/V blocks over this axis);
* ``tp`` — tensor parallelism (Megatron column/row sharded products).

The reference lays the axes over a grid of TPU devices and runs one
program per device under ``shard_map``.  The port's ranks are
co-resident: :meth:`MeshPlan.build_mesh` returns a :class:`Mesh`, the
four axes as a :func:`~kungfu_tpu_torch.ops.collective.rank_world` over
``size`` ranks that share one card (or the host), every per-rank value
stacked on a leading axis in mesh-major order (rank ``r`` has
coordinates ``(dp, pp, sp, tp)`` with ``r = ((dp*PP + pp)*SP + sp)*TP
+ tp``, as ``np.reshape(devices, (dp, pp, sp, tp))`` lays them out).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from kungfu_tpu_torch.ops import collective as coll
from kungfu_tpu_torch.utils import envs

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_TP = "tp"
AXES = (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP)


def _prime_factors(n: int):
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


class Mesh:
    """The four mesh axes over ``len(devices)`` co-resident ranks: the
    counterpart of ``jax.sharding.Mesh(grid, AXES)``.  :meth:`world`
    binds the axes for the collectives called inside, as ``shard_map``
    binds the mesh's axis names."""

    def __init__(self, plan: "MeshPlan", devices: Sequence[torch.device]):
        self.plan = plan
        self.devices = list(devices)
        self.axes: List[Tuple[str, int]] = [
            (AXIS_DP, plan.dp), (AXIS_PP, plan.pp), (AXIS_SP, plan.sp),
            (AXIS_TP, plan.tp)]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    def world(self):
        return coll.rank_world(self.axes)

    def __repr__(self):
        return f"Mesh({self.shape} on {self.device})"


@dataclass(frozen=True)
class MeshPlan:
    """Static factorization of the rank count into parallel axes."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    @property
    def ep(self) -> int:
        """Expert parallelism degree (MoE experts are sharded over dp)."""
        return self.dp

    @classmethod
    def auto(cls, n_devices: int) -> "MeshPlan":
        """Spread prime factors round-robin over (dp, tp, sp, pp), largest
        first, so 8 -> dp=2, tp=2, sp=2 and 16 adds pp=2."""
        sizes = {AXIS_DP: 1, AXIS_TP: 1, AXIS_SP: 1, AXIS_PP: 1}
        order = (AXIS_DP, AXIS_TP, AXIS_SP, AXIS_PP)
        for i, f in enumerate(sorted(_prime_factors(n_devices), reverse=True)):
            sizes[order[i % len(order)]] *= f
        return cls(dp=sizes[AXIS_DP], pp=sizes[AXIS_PP], sp=sizes[AXIS_SP],
                   tp=sizes[AXIS_TP])

    def build_mesh(self, devices: Optional[Sequence] = None) -> Mesh:
        """The plan's :class:`Mesh` over the first ``size`` of ``devices``
        (default ``["cuda"] * size``; raises without a GPU unless given
        CPU devices).  Every rank must sit on the same card or on the
        host.  On a multislice pod (``MEGASCALE_NUM_SLICES`` > 1) the
        reference orders its devices slice-major; the port has that
        layout (``platforms.tpu_pod.slice_mesh_layout``), but its ranks
        share one card, so that raises, naming the multi-card slice."""
        from kungfu_tpu_torch.comm.device import _one_device

        if int(os.environ.get(envs.MEGASCALE_NUM_SLICES, "0") or 0) > 1:
            raise NotImplementedError(
                "a slice-major mesh over a multislice pod: the layout is "
                "platforms.tpu_pod.slice_mesh_layout, but each slice's "
                "ranks need a card of their own, which needs ranks on "
                "more than one card: the multi-card slice")
        names = (list(devices) if devices is not None
                 else ["cuda"] * self.size)
        if len(names) < self.size:
            raise ValueError(f"plan needs {self.size} devices, have "
                             f"{len(names)}")
        return Mesh(self, _one_device(names[:self.size]))

    def __str__(self):
        return f"MeshPlan(dp={self.dp}, pp={self.pp}, sp={self.sp}, tp={self.tp})"
