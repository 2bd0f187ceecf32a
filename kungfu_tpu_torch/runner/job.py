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
plane on the host; ``gpu`` stamps nothing, and every worker of a host
shares the one card.  What needs a multi-process device world raises
``NotImplementedError``: a provisioned world (``-device-world``) and the
TPU backend's coordinator envs come with the multi-card slice.
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

#: the message of every launch feature that needs a device world of
#: several processes
MULTI_CARD = ("comes with the multi-card slice: the port has no "
              "counterpart of jax.distributed yet")


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
    #: a provisioned device world (``-device-world``): raises
    world: Optional[PeerList] = None
    #: multislice partitioning (``-num-slices``): > 1 stamps each worker
    #: with its slice, slice-major contiguous, as the reference does
    slices: int = 0
    #: ranks per slice, pinned at the first spawn (0 = derive then), so
    #: a watch-mode respawn over a resized cluster keeps the geometry
    slice_rps: int = 0
    job_start: float = field(default_factory=time.time)

    def __post_init__(self):
        if self.world is not None:
            raise NotImplementedError(
                f"a provisioned device world (-device-world) {MULTI_CARD}")
        if self.backend == "tpu":
            raise NotImplementedError(
                "the TPU backend's coordinator envs (KF_COORDINATOR, "
                f"KF_NUM_PROCESSES, KF_PROCESS_ID) {MULTI_CARD}; the "
                f"port's backends are {BACKENDS}")
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
            # slice identity rides the stable spawn rank; the first spawn
            # pins ranks-per-slice, later (resized) spawns reuse it
            if self.slice_rps <= 0:
                if len(cluster.workers) % self.slices:
                    raise ValueError(
                        f"{len(cluster.workers)} worker slot(s) cannot "
                        f"partition into {self.slices} slices")
                self.slice_rps = len(cluster.workers) // self.slices
            rps = self.slice_rps
            if rank is None or len(cluster.workers) % rps:
                raise ValueError(
                    f"{len(cluster.workers)} worker slot(s) do not tile "
                    f"{rps}-rank slices")
            env[envs.MEGASCALE_NUM_SLICES] = str(len(cluster.workers) // rps)
            env[envs.MEGASCALE_SLICE_ID] = str(rank // rps)
            env[envs.SLICE_RANKS] = str(rps)
        if self.config_server:
            env[envs.CONFIG_SERVER] = self.config_server
        if self.backend == "cpu":
            # each worker's device plane is the host; collectives run on
            # the host channel (the reference's names, so that its
            # workers run under this launcher too)
            env["JAX_PLATFORMS"] = "cpu"
            env[envs.JAX_PLATFORM] = "cpu"
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
        CreateProcs)."""
        return [self.new_proc(w, cluster, version)
                for w in cluster.workers if w.host == self_host]
