"""Job -> worker processes with the ``KF_*`` bootstrap env (port of
``kungfu_tpu/runner/job.py``).

One :class:`~kungfu_tpu_torch.runner.proc.Proc` per local worker, with
the reference's env contract key for key: identity, the initial peer and
runner lists, the cluster version, the strategies, the config server,
the parent runner, the two timestamps, the slice identity of
``-num-slices`` and ``PYTHONPATH``, here computed from
``kungfu_tpu_torch``'s own location.

Where the port differs (ROADMAP C24): the backend is ``gpu`` (the
default) or ``cpu``.  ``cpu`` stamps the reference's ``JAX_PLATFORMS=cpu``
and ``KF_JAX_PLATFORM=cpu``, which the port's peer reads as its device
plane on the host; ``gpu`` stamps what the reference's ``tpu`` backend
stamps, and every worker of a host shares the one card.  With more than
one worker the ``gpu`` backend's workers form one fixed process world
(``KF_COORDINATOR``, ``KF_NUM_PROCESSES``, ``KF_PROCESS_ID``; the
coordinator address is stamped for the reference's contract, the port's
rendezvous rides the host channel).  A provisioned world
(``-device-world``, :attr:`Job.world`) spawns every slot, each stamped
with ``KF_WORLD_PEERS`` and its slot as its process id, and under ``cpu``
with ``KF_NUM_DEVICES=1``, as the reference does.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.plan.peerlist import PeerList
from kungfu_tpu_torch.plan.strategy import Strategy
from kungfu_tpu_torch.runner.proc import Proc
from kungfu_tpu_torch.utils import envs

#: the worker backends: the card, or the host
BACKENDS = ("gpu", "cpu")

#: coordinator port = first worker's (job-unique) peer port + this
#: offset, so two jobs sharing a host never collide
COORDINATOR_PORT_OFFSET = 20000


def _coordinator(first: PeerID) -> str:
    """The coordinator address of a world whose first worker is
    ``first``; a port past 65535 wraps into the dynamic range."""
    port = first.port + COORDINATOR_PORT_OFFSET
    if port > 65535:
        port = 20000 + (port % 25536)
    return f"{first.host}:{port}"


@dataclass
class Job:
    prog: str
    args: List[str]
    strategy: Strategy = Strategy.AUTO
    device_strategy: str = ""  # initial device allreduce schedule
    config_server: str = ""
    log_dir: str = ""
    parent: Optional[PeerID] = None
    extra_envs: Dict[str, str] = field(default_factory=dict)
    backend: str = "gpu"  # "gpu": the card | "cpu": the host
    #: every provisioned worker slot (``-device-world``): all of them are
    #: spawned and boot into one process world; a resize re-carves the
    #: communicator over the active ones (Peer._carve)
    world: Optional[PeerList] = None
    #: multislice partitioning (``-num-slices``): > 1 stamps each worker
    #: with its slice, slice-major contiguous, as the reference does
    slices: int = 0
    #: ranks per slice, pinned at the first spawn (0 = derive then), so
    #: a watch-mode respawn over a resized cluster keeps the geometry
    slice_rps: int = 0
    job_start: float = field(default_factory=time.time)

    def __post_init__(self):
        if self.backend == "tpu":
            raise NotImplementedError(
                f"tpu is not a backend of the port; its backends are "
                f"{BACKENDS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}, one of {BACKENDS}")

    def new_proc(self, worker: PeerID, cluster: Cluster,
                 version: int = 0) -> Proc:
        rank = cluster.workers.rank(worker)
        env = {
            envs.SELF_SPEC: str(worker),
            envs.INIT_PEERS: str(cluster.workers),
            envs.INIT_RUNNERS: str(cluster.runners),
            envs.INIT_CLUSTER_VERSION: str(version),
            envs.ALLREDUCE_STRATEGY: str(self.strategy),
            **({envs.DEVICE_STRATEGY: self.device_strategy}
               if self.device_strategy else {}),
            envs.JOB_START_TIMESTAMP: f"{self.job_start:.3f}",
            envs.PROC_START_TIMESTAMP: f"{time.time():.3f}",
        }
        if self.parent is not None:
            env[envs.PARENT_ID] = str(self.parent)
        if self.slices and self.slices > 1:
            # slice identity rides the stable spawn rank (the world slot
            # in a provisioned world); the first spawn pins
            # ranks-per-slice, later (resized) spawns reuse it
            spawn_list = (self.world if self.world is not None
                          else cluster.workers)
            base_rank = (self.world.rank(worker) if self.world is not None
                         else rank)
            if self.slice_rps <= 0:
                if len(spawn_list) % self.slices:
                    raise ValueError(
                        f"{len(spawn_list)} worker slot(s) cannot "
                        f"partition into {self.slices} slices")
                self.slice_rps = len(spawn_list) // self.slices
            rps = self.slice_rps
            if base_rank is None or len(spawn_list) % rps:
                raise ValueError(
                    f"{len(spawn_list)} worker slot(s) do not tile "
                    f"{rps}-rank slices")
            env[envs.MEGASCALE_NUM_SLICES] = str(len(spawn_list) // rps)
            env[envs.MEGASCALE_SLICE_ID] = str(base_rank // rps)
            env[envs.SLICE_RANKS] = str(rps)
        if self.config_server:
            env[envs.CONFIG_SERVER] = self.config_server
        if self.world is not None:
            # a provisioned world: every slot, active or standby, joins one
            # process world under its stable slot index
            wr = self.world.rank(worker)
            if wr is None:
                raise ValueError(
                    f"worker {worker} is not a provisioned world slot")
            env[envs.WORLD_PEERS] = str(self.world)
            env[envs.COORDINATOR] = _coordinator(self.world[0])
            env[envs.NUM_PROCESSES] = str(len(self.world))
            env[envs.PROCESS_ID] = str(wr)
            if self.backend == "cpu":
                env["JAX_PLATFORMS"] = "cpu"
                env[envs.JAX_PLATFORM] = "cpu"
                # extra_envs is merged last and may override it
                env[envs.NUM_DEVICES] = "1"
        elif self.backend == "cpu":
            # each worker's device plane is the host; collectives run on
            # the host channel (the reference's names, so that its
            # workers run under this launcher too)
            env["JAX_PLATFORMS"] = "cpu"
            env[envs.JAX_PLATFORM] = "cpu"
        else:
            # the card: the workers form one fixed process world, as the
            # reference's tpu backend stamps its jax.distributed world
            n = len(cluster.workers)
            if n > 1 and rank is not None:
                env[envs.COORDINATOR] = _coordinator(cluster.workers[0])
                env[envs.NUM_PROCESSES] = str(n)
                env[envs.PROCESS_ID] = str(rank)
        # the package importable in the workers whatever their cwd
        import kungfu_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
            _pkg.__file__)))
        existing = os.environ.get("PYTHONPATH", "")
        env["PYTHONPATH"] = pkg_root + (os.pathsep + existing
                                        if existing else "")
        env.update(self.extra_envs)
        return Proc(
            name=f"worker-{rank}" if rank is not None
            else f"worker-{worker.port}",
            prog=self.prog,
            args=list(self.args),
            envs=env,
            log_dir=self.log_dir,
        )

    def create_procs(self, cluster: Cluster, self_host: str,
                     version: int = 0) -> List[Proc]:
        """Procs for the workers of ``self_host`` (reference ``job.go:74``
        CreateProcs); in a provisioned world every slot of the host, those
        outside the initial worker list booting as standby peers."""
        spawn_list = self.world if self.world is not None else cluster.workers
        return [self.new_proc(w, cluster, version)
                for w in spawn_list if w.host == self_host]
