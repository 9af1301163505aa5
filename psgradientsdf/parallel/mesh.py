"""Device-mesh construction and sharding specs for the voxel engine.

The reference is single-process/single-thread (SURVEY §2.1); this build
scales along two axes (SURVEY §5.7):

  "z"       — spatial Z-slab sharding of the dense voxel grid (the
              tensor-parallel analog); fusion and per-voxel work are local,
              FD stencils need 1-voxel halos, GN reductions are psums.
  "frames"  — keyframe sharding in the refinement (the data-parallel
              analog); per-frame pose/light blocks solve locally, voxel
              reductions psum over this axis.

All helpers work identically on a real pod slice or on the
xla_force_host_platform_device_count CPU mesh used by CI.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from psgradientsdf.core.volume import GradSdfVolume

Z_AXIS = "z"
FRAME_AXIS = "frames"


def make_mesh(n_z: int = 0, n_frames: int = 1, devices=None) -> Mesh:
    """(n_z x n_frames) mesh; n_z=0 -> use all remaining devices for z."""
    devices = list(devices if devices is not None else jax.devices())
    if n_z <= 0:
        n_z = len(devices) // max(n_frames, 1)
    need = n_z * n_frames
    if need > len(devices):
        raise ValueError(f"mesh {n_z}x{n_frames} needs {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_z, n_frames)
    return Mesh(arr, (Z_AXIS, FRAME_AXIS))


def volume_specs() -> GradSdfVolume:
    """PartitionSpecs for each GradSdfVolume field: Z-slab layout."""
    return GradSdfVolume(
        dist=P(Z_AXIS, None, None),
        grad=P(Z_AXIS, None, None, None),
        weight=P(Z_AXIS, None, None),
        color=P(Z_AXIS, None, None, None),
        vis=P(None, Z_AXIS, None, None),
    )


def _permute_z(vol: GradSdfVolume, n_z: int, inverse: bool) -> GradSdfVolume:
    Z = vol.dist.shape[0]
    assert Z % n_z == 0
    Zl = Z // n_z

    def one(arr, z_axis):
        pre = arr.shape[:z_axis]
        post = arr.shape[z_axis + 1:]
        if inverse:
            # stored [n_z, Zl] blocks -> logical z = local*n_z + shard
            a = arr.reshape(pre + (n_z, Zl) + post)
            a = jax.numpy.swapaxes(a, z_axis, z_axis + 1)
        else:
            # logical z = i -> stored block (i % n_z), local (i // n_z)
            a = arr.reshape(pre + (Zl, n_z) + post)
            a = jax.numpy.swapaxes(a, z_axis, z_axis + 1)
        return a.reshape(arr.shape)

    return GradSdfVolume(
        dist=one(vol.dist, 0), grad=one(vol.grad, 0),
        weight=one(vol.weight, 0), color=one(vol.color, 0),
        vis=one(vol.vis, 1),
    )


def interleave_volume(vol: GradSdfVolume, n_z: int) -> GradSdfVolume:
    """Reorder Z planes into the strided-interleave layout: stored plane
    (k*Zl + i) = logical plane (i*n_z + k), so Z-slab shard k holds the
    strided global planes {k, k+n_z, ...}.  Used with the interleave_z
    option of the sharded fusion/tracking kernels (parallel/shard.py) to
    balance per-chip cull counts on frustum scenes.  Pure relabeling —
    O(volume copy), no communication."""
    return _permute_z(vol, n_z, inverse=False)


def deinterleave_volume(vol: GradSdfVolume, n_z: int) -> GradSdfVolume:
    """Inverse of interleave_volume (back to logical plane order)."""
    return _permute_z(vol, n_z, inverse=True)


def shard_volume(vol: GradSdfVolume, mesh: Mesh) -> GradSdfVolume:
    """Place a volume on the mesh as Z-slabs (replicated over `frames`)."""
    specs = volume_specs()
    return GradSdfVolume(
        *(
            jax.device_put(arr, NamedSharding(mesh, spec))
            for arr, spec in zip(vol, specs)
        )
    )


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
