"""Device mesh construction — the distributed substrate the reference lacks.

The reference is strictly single-node shared-memory + one GPU (SURVEY.md §2.6:
no MPI/NCCL/UCX anywhere; its only 'communication' is cudaMemcpy,
nlibs/CSR.cc:342-371).  This package makes multi-device execution a
first-class layer: a 1-D mesh over the row axis ('x') for row-partitioned
SpGEMM / R-MCL, riding the collectives shard_map inserts, which XLA hands
to NCCL on GPUs.

Within one host the GPUs are joined all to all by NVLink, so the mesh
follows the algorithm alone: no device order is closer than another.  On
a multi-host deployment call :func:`init_distributed` first
(jax.distributed.initialize), then :func:`make_mesh` builds the global
mesh spanning all processes.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "x"

# Environment markers of a multi-process launch.  Querying
# jax.process_count() would initialize the LOCAL backend and permanently
# foreclose jax.distributed.initialize(), so cluster detection must be
# env-only (pre-init).
_CLUSTER_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def init_distributed(**kwargs) -> None:
    """Multi-host bring-up (no-op when no cluster environment is present).

    With explicit kwargs, initializes unconditionally.  With none, probes
    the environment for a coordinator/cluster marker and initializes only
    if one is found — never touching the local backend first, so the
    no-kwargs path works on real multi-host launches.
    """
    if kwargs:
        jax.distributed.initialize(**kwargs)
        return
    if any(os.environ.get(v) for v in _CLUSTER_ENV_VARS) or (
        int(os.environ.get("SLURM_NTASKS", "1")) > 1
        and os.environ.get("SLURM_JOB_ID")
    ):
        jax.distributed.initialize()


def make_mesh(n_devices: int | None = None, axis: str = ROW_AXIS) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all visible devices)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return jax.make_mesh((n_devices,), (axis,), devices=devs[:n_devices])


def row_sharding(mesh: Mesh, axis: str = ROW_AXIS) -> NamedSharding:
    """Sharding that splits the leading (shard-stack) axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
