"""Multi-host initialization for the distributed communication backend.

The reference's distribution is MPI via PETSc (PETSC_COMM_WORLD from
MPI_COMM_WORLD, standalone_mpp.F90:75-76) with in-library scatters
(UnstructuredGridType.F90) — SURVEY §5 'distributed communication
backend'.  Here ``jax.distributed`` forms the multi-host
process group, every host contributes its local chips to one global
``Mesh``, and the same `shard_map`/`ppermute` lateral machinery
(parallel/sharding.py, parallel/ugrid.py) rides ICI within a slice and
DCN across slices — no NCCL/MPI code in the framework.

Single-host runs (CI, the virtual 8-CPU mesh) skip initialization and
fall back to ``jax.devices()``; multi-host runs set the standard
coordinator env (JAX_COORDINATOR_ADDRESS / num_processes / process_id)
or pass them explicitly.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join (or skip) the multi-host process group.

    Returns True if ``jax.distributed.initialize`` ran.  Arguments
    default to the standard env vars; with neither present this is a
    single-host run and the call is a no-op.
    """
    import jax
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes
                        or os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = int(process_id
                     or os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def global_column_mesh(axis: str = "col"):
    """1-D global device mesh over ALL processes' devices (the column
    axis of the batched problems).  After ``initialize_distributed``,
    ``jax.devices()`` spans every host; ordering groups each host's
    chips contiguously so nearest-neighbor `ppermute` halos cross DCN
    only at host boundaries."""
    import jax
    from jax.sharding import Mesh
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def process_local_slice(n_global: int, axis_size: int, index: int):
    """[start, stop) of the globally sharded column axis owned by shard
    ``index`` — the mpp_bounds begc/endc analog (mpp_bounds.F90:9-27)."""
    per = n_global // axis_size
    rem = n_global % axis_size
    start = index * per + min(index, rem)
    stop = start + per + (1 if index < rem else 0)
    return start, stop
