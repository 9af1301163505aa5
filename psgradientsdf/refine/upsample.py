"""Grid upsampling (2x per axis) for the refinement stage.

Equivalent of Optimizer::subsampling (OptimizerAux.cpp:622-684) +
VolumetricGradSdf::subsample (VolumetricGradSdf.cpp:469-494): each parent
voxel with fused data spawns 8 children whose distances follow the
first-order model d_child = d + (h/4)(+-gx +-gy +-gz); gradient, weight,
color, and visibility are inherited.  Parents still at the init value
(dist == T, never fused) produce init children (dist=T, albedo=0.5 — the
reference's upsample init, OptimizerAux.cpp:626-631).

Implemented as a reshape/broadcast (one kernel), not a per-voxel loop; the
new volume's visibility is re-packed so keyframe f occupies bit f.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import GradSdfVolume, subsample_dist, vis_bit


def upsample_volume(
    vol: GradSdfVolume,
    geom: GridGeometry,
    keyframe_indices: Sequence[int],
    truncation: float,
) -> Tuple[GradSdfVolume, GridGeometry, List[int]]:
    """Returns (child volume, subdivided geometry, new keyframe indices
    0..F-1 — children's visibility is re-packed keyframe-major)."""
    Z, Y, X = vol.dist.shape
    F = len(keyframe_indices)
    h = geom.voxel_size

    fused = vol.dist != truncation            # parents with real data

    child_d = subsample_dist(vol.dist, vol.grad, h)     # [Z,Y,X,2,2,2]
    init_d = jnp.full_like(child_d, truncation)
    child_d = jnp.where(fused[..., None, None, None], child_d, init_d)

    def expand(a, fill):
        # [Z,Y,X,...] -> [2Z,2Y,2X,...] by repetition, masked by `fused`
        extra = a.shape[3:]
        rep = jnp.broadcast_to(
            a[:, None, :, None, :, None], (Z, 2, Y, 2, X, 2) + extra
        )
        m = jnp.broadcast_to(
            fused.reshape((Z, 1, Y, 1, X, 1) + (1,) * len(extra)),
            (Z, 2, Y, 2, X, 2) + extra,
        )
        out = jnp.where(m, rep, jnp.asarray(fill, dtype=a.dtype))
        return out.reshape((2 * Z, 2 * Y, 2 * X) + extra)

    # distance: interleave children (child index (dz,dy,dx))
    new_dist = jnp.transpose(child_d, (0, 3, 1, 4, 2, 5)).reshape(2 * Z, 2 * Y, 2 * X)

    new_grad = expand(vol.grad, 0.0)
    new_weight = expand(vol.weight, 0.0)
    new_color = expand(vol.color, 0.5)

    # visibility: keyframe-major bits
    kvis = jnp.stack([vis_bit(vol.vis, f) for f in keyframe_indices], axis=0)  # [F,Z,Y,X]
    words = (F + 31) // 32
    new_vis = jnp.zeros((words, 2 * Z, 2 * Y, 2 * X), dtype=jnp.uint32)
    for f in range(F):
        bit_arr = jnp.where(kvis[f] & fused, jnp.uint32(1 << (f % 32)), jnp.uint32(0))
        up = jnp.broadcast_to(
            bit_arr[:, None, :, None, :, None], (Z, 2, Y, 2, X, 2)
        ).reshape(2 * Z, 2 * Y, 2 * X)
        new_vis = new_vis.at[f // 32].set(new_vis[f // 32] | up)

    new_geom = geom.subdivided()
    new_vol = GradSdfVolume(
        dist=new_dist, grad=new_grad, weight=new_weight, color=new_color, vis=new_vis
    )
    return new_vol, new_geom, list(range(F))
