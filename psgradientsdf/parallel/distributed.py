"""Multi-host (multi-process) runtime setup: jax.distributed + process-aware
mesh construction.

The reference is single-process (SURVEY §2.1/§5.8); this module is this
build's "distributed communication backend" row: one
`jax.distributed.initialize` per host, after which `jax.devices()` is the
GLOBAL device list and the z x frames mesh (parallel/mesh.py) spans hosts —
collectives (NCCL on GPUs) ride NVLink within a host and the network across
hosts, inserted by
GSPMD/shard_map exactly as in the single-process path.  Nothing else in the
engine changes: the pipeline's mesh path (pipeline.py) is already written
against global meshes.

Scaling recipe (512^3 over >= 2 hosts):
    # on every host (coordinator = host 0):
    from psgradientsdf.parallel import distributed
    distributed.initialize(coordinator_address="host0:8476",
                           num_processes=N, process_id=i)
    mesh = distributed.make_global_mesh(n_z=0, n_frames=1)
    # -> run the pipeline with this mesh; Z-slabs place shard i's voxel
    #    rows in host i's device memory, halo exchanges cross host boundaries once
    #    per stencil application.

Environment fallbacks follow jax.distributed's own conventions
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from psgradientsdf.parallel.mesh import FRAME_AXIS, Z_AXIS, make_mesh

_INITIALIZED = False


def is_initialized() -> bool:
    return _INITIALIZED


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Per-host jax.distributed initialization (idempotent).

    On CPU/GPU clusters the triplet must come from arguments or the JAX_*
    environment variables (a cluster scheduler jax.distributed knows may
    supply them).
    Single-process runs may skip calling this entirely — every mesh helper
    works on the local device list too.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True


def shutdown() -> None:
    global _INITIALIZED
    if _INITIALIZED:
        jax.distributed.shutdown()
        _INITIALIZED = False


def process_info() -> dict:
    """(process_index, process_count, local/global device counts)."""
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=jax.local_device_count(),
        global_devices=jax.device_count(),
    )


def make_global_mesh(n_z: int = 0, n_frames: int = 1):
    """z x frames mesh over the GLOBAL device list (all hosts).

    Device order follows jax.devices(), which groups by process — so with
    n_frames=1 the Z-slab axis is contiguous per host: each host owns a
    contiguous band of Z rows and stencil halos cross a host boundary
    exactly once per shard edge, every other z-neighbor exchange staying
    host-local."""
    return make_mesh(n_z=n_z, n_frames=n_frames, devices=jax.devices())


def host_local_slice(geom_z: int, mesh) -> slice:
    """The Z-row range of the dense grid owned by THIS process under a
    Z-slab sharding of `mesh` (for host-side IO of process-local data)."""
    n_z = mesh.shape[Z_AXIS]
    assert geom_z % n_z == 0
    zl = geom_z // n_z
    # rows of the mesh's z axis that live on this process, in order
    mine = [
        i for i, dev_row in enumerate(mesh.devices)
        for d in (dev_row if hasattr(dev_row, "__len__") else [dev_row])
        if d.process_index == jax.process_index()
    ]
    if not mine:
        return slice(0, 0)
    lo, hi = min(mine), max(mine)
    return slice(lo * zl, (hi + 1) * zl)
