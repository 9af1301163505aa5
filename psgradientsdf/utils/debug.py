"""Debug inspectors: grid slices, visibility-map check, normal-map dump.

Equivalents of the reference's manual-inspection tooling
(SURVEY §5):

  * grid slice extraction        — VoxelGrid::slice_x/y/z (VoxelGrid.cpp:76-115)
  * visibility-map sanity check  — VolumetricGradSdf::check_vis_map
                                   (VolumetricGradSdf.cpp:445-465)
  * per-frame normal-map render  — VolumetricGradSdf::save_normal
                                   (VolumetricGradSdf.cpp:140-232)

All are host-side export/inspection paths (vectorized numpy); the per-frame
compute they borrow (projection + fusion gates) reuses the same math as the
fusion kernel, so what you inspect is exactly what fusion saw.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import GradSdfVolume


def grid_slice(grid: np.ndarray, axis: str, index: int) -> np.ndarray:
    """2-D slice of a [Z,Y,X] scalar grid (VoxelGrid.cpp:76-115).

    Axis layouts match the reference: 'x' -> [Z,Y] image, 'y' -> [X,Z],
    'z' -> [Y,X]."""
    grid = np.asarray(grid)
    if axis == "x":
        return grid[:, :, index]
    if axis == "y":
        return grid[:, index, :].T
    if axis == "z":
        return grid[index, :, :]
    raise ValueError(f"axis must be x/y/z, got {axis!r}")


def save_grid_slice(grid: np.ndarray, axis: str, index: int, path: str) -> np.ndarray:
    """Write the slice as tab-separated values (the reference's tmp_*slice.dat)
    and return it."""
    sl = grid_slice(grid, axis, index)
    with open(path, "w") as fh:
        fh.write("\t".join(str(float(v)) for v in sl.reshape(-1)) + "\t")
    return sl


def check_vis_map(
    vol: GradSdfVolume, voxel_size: float, sample_every: int = 100,
    verbose: bool = False,
) -> Dict:
    """Visibility sanity stats over surface-band voxels
    (VolumetricGradSdf.cpp:445-465).

    Returns {'band_voxels', 'frames', 'per_frame_counts', 'samples'}; with
    verbose=True also prints every `sample_every`-th band voxel's bits,
    like the reference."""
    dist = np.asarray(vol.dist)
    vis = np.asarray(vol.vis)                      # [W,Z,Y,X] uint32
    band = np.abs(dist) < np.sqrt(3.0) * voxel_size
    zz, yy, xx = np.nonzero(band)
    n_frames = vis.shape[0] * 32
    bits = np.zeros((len(zz), n_frames), dtype=bool)
    for w in range(vis.shape[0]):
        word = vis[w, zz, yy, xx]
        for b in range(32):
            bits[:, w * 32 + b] = (word >> np.uint32(b)) & 1
    per_frame = bits.sum(axis=0)
    last = int(np.nonzero(per_frame)[0].max()) + 1 if per_frame.any() else 0
    samples = []
    X, Y = dist.shape[2], dist.shape[1]
    for i in range(0, len(zz), max(1, sample_every)):
        lin = int((zz[i] * Y + yy[i]) * X + xx[i])
        samples.append((lin, bits[i, :last].tolist()))
        if verbose:
            print(f"voxel {lin}:\t" + " ".join(
                f"frame {f} vis: {int(v)}" for f, v in enumerate(bits[i, :last])))
    return dict(
        band_voxels=int(band.sum()),
        frames=last,
        per_frame_counts=per_frame[:last].tolist(),
        samples=samples,
    )


def normal_map_image(
    vol: GradSdfVolume,
    geom: GridGeometry,
    depth: np.ndarray,        # [H,W] meters
    normals: np.ndarray,      # [H,W,3] FALS normals (inward)
    K: np.ndarray,
    pose: np.ndarray,         # [4,4] camera-to-world
    *,
    truncation: float,
    zmin: float,
    zmax: float,
) -> np.ndarray:
    """Render the reference's debug normal map (VolumetricGradSdf.cpp:140-232):
    every pixel hit by a voxel that passes the fusion gates gets color
    (-n + 1)/2 * 255.  Returns [H,W,3] uint8 (RGB)."""
    depth = np.asarray(depth, np.float32)
    H, W = depth.shape
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R = np.asarray(pose, np.float64)[:3, :3]
    t = np.asarray(pose, np.float64)[:3, 3]

    p_w = np.asarray(geom.world_coords()).reshape(-1, 3)
    p_c = (p_w - t) @ R        # R^T (p - t)
    pz = p_c[:, 2]
    m = pz > 0
    u = np.full(pz.shape, -1, np.int64)
    v = np.full(pz.shape, -1, np.int64)
    u[m] = np.floor(cx + fx * p_c[m, 0] / pz[m] + 0.5).astype(np.int64)
    v[m] = np.floor(cy + fy * p_c[m, 1] / pz[m] + 0.5).astype(np.int64)
    m &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc, vc = u[m], v[m]
    z = depth[vc, uc]
    zok = (z > zmin) & (z < zmax)
    sdf = z - p_c[m, 2]
    w = np.where(sdf >= 0, 1.0, np.where(sdf >= -truncation, 1.0 + sdf / truncation, 0.0))
    keep = zok & (w > 0)
    uc, vc = uc[keep], vc[keep]

    out = np.zeros((H, W, 3), np.float32)
    n = np.asarray(normals, np.float32)
    out[vc, uc] = (-n[vc, uc] + 1.0) / 2.0 * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def save_normal_map(path: str, *args, **kwargs) -> str:
    """save_normal's PNG dump (filename + 'normal_map.png')."""
    from psgradientsdf.io import png

    fn = path + "normal_map.png"
    png.write(fn, normal_map_image(*args, **kwargs))
    return fn


def check_nan(arr, name: str = "") -> bool:
    """True iff `arr` contains NaN, printing a notice when it does
    (Auxilary.h:22-26 checkNan)."""
    bad = bool(np.isnan(np.asarray(arr)).any())
    if bad:
        print(f"checkNan: {name or 'array'} contains NaN")
    return bad
