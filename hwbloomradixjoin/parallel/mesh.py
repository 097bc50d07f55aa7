"""Device mesh construction.

One flat data axis "d" covers hosts x devices for the join workloads (the
partitioning shuffle is a single all-to-all over every device).  A flat
axis suits cards that reach each other at one rate, such as NVLink-joined
GPUs of one host.  The helper keeps CPU test meshes
(xla_force_host_platform_device_count) and real devices uniform.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "d"


def init_distributed() -> bool:
    """Initialize jax.distributed for multi-host meshes from the env.

    The multi-host story (SURVEY.md §2.2 backend row): each host process
    calls jax.distributed.initialize, then jax.devices() spans every chip
    of every host and make_mesh builds the global data axis — the shuffle's
    all_to_all is compiled by XLA from the same shard_map program as
    single-host.

    Controlled by env (set by the launcher):
      HBRJ_COORDINATOR  host:port of process 0
      HBRJ_NUM_PROCS    total process count
      HBRJ_PROC_ID      this process's index
    Returns True if distributed init ran.  Single-process (the only mode
    exercisable in this environment) is a no-op.
    """
    import os

    coord = os.environ.get("HBRJ_COORDINATOR")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["HBRJ_NUM_PROCS"]),
        process_id=int(os.environ["HBRJ_PROC_ID"]))
    return True


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def sharded(mesh: Mesh):
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
