"""Vectorized marching cubes over dense SDF grids (host-side numpy).

Functional equivalent of cpp/third/mesh/MarchingCubes.{h,cpp} (color variant)
and MarchingCubesNoColor: zero-isosurface extraction with edge-interpolated
vertices and colors, gated on all eight cube-corner weights being positive
(MarchingCubes.cpp:528-535).  Export-only path, so it runs as vectorized
numpy on host (the dist/weight/color crops are tiny compared to the volume).

Conventions: `phi` is the field passed in by the caller.  The volume stores
negative-inside distances and the callers pass -dist (positive inside,
VolumetricGradSdf.cpp:290), so "inside" here is phi > level, matching the
reference's sign flip.  Triangles are oriented with outward normals
(toward decreasing phi).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from psgradientsdf.ops.mc_tables import CORNERS, EDGES, TRI_TABLE


class Mesh(NamedTuple):
    vertices: np.ndarray           # [V,3] float32 world coords
    faces: np.ndarray              # [F,3] int32
    colors: Optional[np.ndarray]   # [V,3] float32 in [0,1] or None


_CORNER_OFFSETS = CORNERS.astype(np.int64)  # [8,3] in (x,y,z)


def marching_cubes(
    phi: np.ndarray,                 # [Z,Y,X] field, inside = phi > level
    voxel_size: float,
    origin: Tuple[float, float, float],   # world position of voxel (0,0,0)
    level: float = 0.0,
    weight: Optional[np.ndarray] = None,  # [Z,Y,X]; cube needs all 8 corners > 0
    color: Optional[np.ndarray] = None,   # [Z,Y,X,3] in [0,1]
    use_native: bool = True,
    grad: Optional[np.ndarray] = None,    # [Z,Y,X,3] Gradient-SDF gradients
) -> Mesh:
    """With `grad` given, vertices are placed directly from the Gradient-SDF
    (GradMarchingCubes::getVertex single-corner overload,
    cpp/third/mesh/GradMarchingCubes.cpp:707-714): each edge's vertex sits at
    p_lo + phi_lo * ghat_lo — the surface point the low corner's gradient
    points to — instead of edge interpolation.  Colors come from the low
    corner.  (The reference ships this variant but its call-site is
    commented out, OptimizerAux.cpp:346-347; we expose it as an option.)"""
    # native C++ core (native/mc.cpp — the mc_lib equivalent) when available
    if use_native:
        from psgradientsdf.native import marching_cubes_native

        out = marching_cubes_native(
            np.asarray(phi), voxel_size, origin, level, TRI_TABLE,
            weight=weight, color=color, grad=grad,
        )
        if out is not None:
            return Mesh(vertices=out[0], faces=out[1], colors=out[2])

    phi = np.asarray(phi, dtype=np.float64)
    Z, Y, X = phi.shape
    if X < 2 or Y < 2 or Z < 2:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None)

    # corner values for every cube: [Z-1, Y-1, X-1, 8]
    def corner_view(a):
        return np.stack(
            [
                a[dz : Z - 1 + dz, dy : Y - 1 + dy, dx : X - 1 + dx]
                for (dx, dy, dz) in _CORNER_OFFSETS
            ],
            axis=-1,
        )

    vals = corner_view(phi)
    inside = vals > level  # bit set = inside
    config = np.zeros(vals.shape[:3], dtype=np.int32)
    for c in range(8):
        config |= inside[..., c].astype(np.int32) << c

    active = (config != 0) & (config != 255)
    if weight is not None:
        wvals = corner_view(np.asarray(weight, dtype=np.float64))
        active &= np.all(wvals > 0.0, axis=-1)

    cz, cy, cx = np.nonzero(active)
    if cz.size == 0:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None)
    cfg = config[cz, cy, cx]                       # [C]
    cvals = vals[cz, cy, cx]                       # [C,8]

    # ---- vertices: one per active (cube, edge) pair, deduplicated globally
    # global edge key: edges are axis-aligned; identify by (axis, x, y, z) of
    # the low corner.
    tri_edges = TRI_TABLE[cfg]                     # [C,16]
    n_tris = np.sum(tri_edges >= 0, axis=1) // 3

    # gather all (cube, edge) pairs used by triangles
    tmax = tri_edges.shape[1]
    cube_idx = np.repeat(np.arange(cfg.size), tmax)
    edge_idx = tri_edges.reshape(-1)
    used = edge_idx >= 0
    cube_idx = cube_idx[used]
    edge_idx = edge_idx[used]

    # canonical global key for each cube-edge
    e_a = EDGES[edge_idx, 0]
    e_b = EDGES[edge_idx, 1]
    ca = _CORNER_OFFSETS[e_a]                      # [M,3] (x,y,z) offsets
    cb = _CORNER_OFFSETS[e_b]
    base = np.stack([cx[cube_idx], cy[cube_idx], cz[cube_idx]], axis=-1)  # (x,y,z)
    pa = base + ca
    pb = base + cb
    lo = np.minimum(pa, pb)
    axis = np.argmax(np.abs(pa - pb), axis=-1)     # which axis the edge runs along
    key = ((lo[:, 2] * Y + lo[:, 1]) * X + lo[:, 0]) * 3 + axis
    uniq_key, first_idx, inverse = np.unique(key, return_index=True, return_inverse=True)

    # interpolated positions for the unique edges
    va = cvals[cube_idx[first_idx], e_a[first_idx]]
    vb = cvals[cube_idx[first_idx], e_b[first_idx]]
    denom = vb - va
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = np.clip((level - va) / denom, 0.0, 1.0)
    pa_f = pa[first_idx].astype(np.float64)
    pb_f = pb[first_idx].astype(np.float64)
    if grad is not None:
        # Gradient-SDF vertex placement: p_lo + phi_lo * ghat_lo
        lo_i = lo[first_idx]                       # (x,y,z) integer corner
        g = np.asarray(grad, np.float64)[lo_i[:, 2], lo_i[:, 1], lo_i[:, 0]]
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
        phi_lo = phi[lo_i[:, 2], lo_i[:, 1], lo_i[:, 0]]
        verts_idx = lo_i.astype(np.float64) + (phi_lo[:, None] / voxel_size) * g
        t = np.zeros_like(t)                       # colors from the low corner
        pa_f = pb_f = lo_i.astype(np.float64)
    else:
        verts_idx = pa_f + t[:, None] * (pb_f - pa_f)  # in voxel units (x,y,z)
    verts = (np.asarray(origin)[None, :] + voxel_size * verts_idx).astype(np.float32)

    colors_out = None
    if color is not None:
        color = np.asarray(color, dtype=np.float64)
        c_a = color[pa_f[:, 2].astype(int) % Z, pa_f[:, 1].astype(int) % Y, pa_f[:, 0].astype(int) % X]
        c_b = color[pb_f[:, 2].astype(int) % Z, pb_f[:, 1].astype(int) % Y, pb_f[:, 0].astype(int) % X]
        colors_out = (c_a + t[:, None] * (c_b - c_a)).astype(np.float32)

    faces = inverse.astype(np.int32).reshape(-1, 3)
    return Mesh(vertices=verts, faces=faces, colors=colors_out)


def extract_mesh_from_volume(
    dist: np.ndarray,        # [Z,Y,X] negative-inside distances
    weight: np.ndarray,
    color: Optional[np.ndarray],
    voxel_size: float,
    geom_origin: Tuple[float, float, float],
    band: Optional[float] = None,
    grad: Optional[np.ndarray] = None,   # enable Gradient-MC vertex placement
) -> Mesh:
    """Crop to the surface band bbox then run MC — mirrors
    Optimizer::extract_mesh (OptimizerAux.cpp:278-363): bbox over
    |dist| <= sqrt(3)*h, field = -dist, cube gate on weights.

    Unlike the reference (whose MC origin drops the volume origin,
    OptimizerAux.cpp:344 — meshes live in grid-local coords), vertices here
    are in *world* coordinates; pass geom_origin=(0,0,0)-origin to match
    the reference's frame exactly.
    """
    if band is None:
        band = np.sqrt(3.0) * voxel_size
    dist = np.asarray(dist)
    in_band = np.abs(dist) <= band
    if not in_band.any():
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None)
    zz, yy, xx = np.nonzero(in_band)
    z0, z1 = int(zz.min()), int(zz.max())
    y0, y1 = int(yy.min()), int(yy.max())
    x0, x1 = int(xx.min()), int(xx.max())
    sl = (slice(z0, z1 + 1), slice(y0, y1 + 1), slice(x0, x1 + 1))
    crop_origin = (
        geom_origin[0] + voxel_size * x0,
        geom_origin[1] + voxel_size * y0,
        geom_origin[2] + voxel_size * z0,
    )
    return marching_cubes(
        -dist[sl],
        voxel_size,
        crop_origin,
        level=0.0,
        weight=np.asarray(weight)[sl],
        color=None if color is None else np.asarray(color)[sl],
        grad=None if grad is None else np.asarray(grad)[sl],
    )
