"""TPU pod / multislice environment adapter.

Port of ``kungfu_tpu/platforms/tpu_pod.py``: the platform-adapter slot
of the reference's cloud integration (read the scheduler's env contract,
produce self identity and the peer list).  The pod scheduler publishes:

=================================  =====================================
``TPU_WORKER_HOSTNAMES``           comma-separated host list, rank order
``TPU_WORKER_ID``                  this host's index in that list
``MEGASCALE_COORDINATOR_ADDRESS``  multislice coordinator (slice 0 host 0)
``MEGASCALE_SLICE_ID`` /
``MEGASCALE_NUM_SLICES``           multislice identity (optional)
=================================  =====================================

``parse_tpu_pod_env`` turns that contract into the launcher's inputs: a
:class:`~kungfu_tpu_torch.plan.hostspec.HostList` (one slot per host),
this runner's host and the coordinator, with the reference's validation.

The slice layouts take any device objects with ``slice_index`` and
``process_index`` attributes.  The port's default world is the
co-resident ranks of one card (:func:`co_resident_ranks`), grouped by
the emulation contract: rank ``r`` lives in slice ``r //
ranks_per_slice`` (``elastic/slices.py``).  A
:func:`multislice_communicator` over those ranks is a
:class:`~kungfu_tpu_torch.comm.device.Communicator` whose ``local_size``
is the ranks a slice, so its ``cross_*`` collectives run across slices.
Slices on distinct cards need the multi-card slice: the communicator
refuses ranks on more than one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

from kungfu_tpu_torch.elastic.slices import SliceTopology, bootstrap_topology
from kungfu_tpu_torch.plan.hostspec import HostList
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("tpu-pod")

WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
WORKER_ID = "TPU_WORKER_ID"
MEGASCALE_COORDINATOR = envs.MEGASCALE_COORDINATOR
MEGASCALE_SLICE_ID = envs.MEGASCALE_SLICE_ID
MEGASCALE_NUM_SLICES = envs.MEGASCALE_NUM_SLICES


@dataclass(frozen=True)
class PodInfo:
    hosts: HostList          #: one slot per pod host, scheduler rank order
    self_host: str           #: this runner's host
    worker_id: int
    coordinator: str = ""    #: multislice coordinator addr ("" = single slice)
    slice_id: int = 0
    num_slices: int = 1

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)


def detected(env=None) -> bool:
    env = env if env is not None else os.environ
    return bool(env.get(WORKER_HOSTNAMES))


def parse_tpu_pod_env(env=None, slots_per_host: int = 1) -> Optional[PodInfo]:
    """Parse the pod contract; None when not running inside a TPU pod.
    Raises on a malformed contract (set but inconsistent), like the
    reference adapter."""
    env = env if env is not None else os.environ
    hostnames = env.get(WORKER_HOSTNAMES, "").strip()
    if not hostnames:
        return None
    names = [h.strip() for h in hostnames.split(",") if h.strip()]
    if not names:
        raise ValueError(f"{WORKER_HOSTNAMES} is set but empty")
    wid_s = env.get(WORKER_ID, "").strip()
    if not wid_s:
        if len(names) == 1:
            wid = 0  # single-host pod: the id env is often omitted
        else:
            raise ValueError(
                f"{WORKER_ID} not set but {WORKER_HOSTNAMES} lists "
                f"{len(names)} hosts"
            )
    else:
        wid = int(wid_s)
    if not 0 <= wid < len(names):
        raise ValueError(
            f"{WORKER_ID}={wid} outside the {len(names)}-host list"
        )
    hosts = HostList.parse(
        ",".join(f"{n}:{slots_per_host}" for n in names)
    )
    info = PodInfo(
        hosts=hosts,
        self_host=names[wid],
        worker_id=wid,
        coordinator=env.get(MEGASCALE_COORDINATOR, "").strip(),
        slice_id=int(env.get(MEGASCALE_SLICE_ID, "0") or 0),
        num_slices=int(env.get(MEGASCALE_NUM_SLICES, "1") or 1),
    )
    _log.info(
        "TPU pod: %d hosts, self=%s (id %d), slice %d/%d",
        info.num_hosts, info.self_host, wid, info.slice_id, info.num_slices,
    )
    return info


@dataclass(frozen=True)
class RankDevice:
    """One co-resident rank as a slice-layout device: its rank, its slice
    by the emulation contract, the one process that holds every rank,
    and the torch device its values live on."""

    rank: int
    slice_index: int
    device: str = "cuda"
    process_index: int = 0


def _env_int(name: str) -> int:
    return int(os.environ.get(name, "0") or 0)


def co_resident_ranks(n: Optional[int] = None,
                      ranks_per_slice: Optional[int] = None,
                      device: str = "cuda") -> List[RankDevice]:
    """The default device world: ``n`` ranks of one card, rank ``r`` in
    the slice ``SliceTopology.slice_of(r)`` gives it.  The topology is
    :func:`~kungfu_tpu_torch.elastic.slices.bootstrap_topology`'s reading
    of the launch contract (``MEGASCALE_NUM_SLICES``, ``KF_SLICE_RANKS``,
    which ``ranks_per_slice`` overrides), or one slice when the contract
    names none; ``n`` defaults to its size.  A world that is not whole
    slices raises."""
    env = dict(os.environ)
    if ranks_per_slice is not None:
        env[envs.SLICE_RANKS] = str(ranks_per_slice)
    topo = bootstrap_topology(n or 1, env)
    if topo is None:
        topo = SliceTopology(1, ranks_per_slice or n or 1)
    if n is not None:
        topo = topo.for_size(n)
    return [RankDevice(r, topo.slice_of(r), device) for r in range(topo.size)]


def slice_device_groups(devices=None, by: str = "slice"):
    """Group the device list by slice, outer-sorted by slice id.

    ``by="slice"``: devices carry ``slice_index`` (a device without one
    falls back to its ``process_index``).  ``by="process"``: the
    reference's emulation contract, one process per slice.  ``devices``
    defaults to :func:`co_resident_ranks`."""
    devs = list(devices) if devices is not None else co_resident_ranks()

    def slice_of(d):
        if by == "process":
            return d.process_index
        si = getattr(d, "slice_index", None)
        return si if si is not None else d.process_index

    groups = {}
    for d in devs:
        groups.setdefault(slice_of(d), []).append(d)
    return [groups[k] for k in sorted(groups)]


def slice_mesh_layout(num_slices: Optional[int] = None, devices=None):
    """``(devices_slice_major, per_slice)`` for a hierarchical mesh whose
    outer axis is the slice and inner axis the ranks within it; the
    validation core of :func:`multislice_communicator`:

    * ``num_slices`` defaults to the ``MEGASCALE_NUM_SLICES`` contract
      and is checked against the devices' grouping; a mismatch raises (a
      half-joined multislice job must fail loudly, not silently train one
      slice);
    * when the contract disagrees with the ``slice_index`` grouping but
      matches the per-process grouping, the emulation contract applies;
    * uneven slice sizes raise: multislice meshes need identical slices.
    """
    if num_slices is None:
        num_slices = _env_int(MEGASCALE_NUM_SLICES) or None
    groups = slice_device_groups(devices)
    if num_slices is not None and len(groups) != num_slices:
        by_proc = slice_device_groups(devices, by="process")
        if len(by_proc) == num_slices:
            groups = by_proc
        else:
            raise ValueError(
                f"{MEGASCALE_NUM_SLICES}={num_slices} but the device "
                f"world shows {len(groups)} slice group(s) "
                f"({len(by_proc)} process group(s))"
            )
    per = len(groups[0])
    if any(len(g) != per for g in groups):
        raise ValueError(
            f"uneven slice sizes {[len(g) for g in groups]} — multislice "
            "meshes need identical slices"
        )
    return [d for g in groups for d in g], per


def multislice_communicator(num_slices: Optional[int] = None, devices=None,
                            version: int = 0, **comm_kwargs):
    """A :class:`~kungfu_tpu_torch.comm.device.Communicator` over the
    slice-major layout of :func:`slice_mesh_layout`, ``local_size`` the
    ranks a slice: its outer (``kf_host``) axis is the slice, so the
    ``two_stage`` schedule reduces within each slice, exchanges across
    slices, and broadcasts back.  Each device's ``device`` attribute (or
    the device itself) places its rank; extra ``comm_kwargs``
    (``strategy``, ``on_strategy_change``) pass through."""
    from kungfu_tpu_torch.comm.device import Communicator

    flat, per = slice_mesh_layout(num_slices, devices)
    return Communicator(devices=[getattr(d, "device", d) for d in flat],
                        local_size=per, version=version, **comm_kwargs)
