"""Debug inspectors (utils/debug.py): slices, vis-map stats, normal map."""

import numpy as np
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import fuse_frame, make_volume
from psgradientsdf.ops.normals import build_fals_cache, compute_normals
from psgradientsdf.utils import debug


def test_grid_slice_layouts(tmp_path):
    g = np.arange(3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)  # [Z,Y,X]
    assert debug.grid_slice(g, "x", 2).shape == (3, 4)
    assert debug.grid_slice(g, "y", 1).shape == (5, 3)
    assert debug.grid_slice(g, "z", 0).shape == (4, 5)
    sl = debug.save_grid_slice(g, "z", 1, str(tmp_path / "s.dat"))
    np.testing.assert_array_equal(sl, g[1])
    txt = (tmp_path / "s.dat").read_text().strip().split("\t")
    assert len(txt) == 20


def _fused_scene():
    H, W = 40, 56
    f = 50.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cols = np.arange(W, dtype=np.float32)[None, :]
    rows = np.arange(H, dtype=np.float32)[:, None]
    x0 = (cols - W / 2) / f
    y0 = (rows - H / 2) / f
    depth = np.broadcast_to(
        1.0 + 0.1 * np.sin(4 * x0) * np.cos(3 * y0), (H, W)).astype(np.float32)
    geom = GridGeometry(dims=(24, 24, 24), voxel_size=0.05, shift=(0, 0, 1.0))
    T = 0.25
    fals = build_fals_cache(H, W, K)
    n = compute_normals(jnp.asarray(depth), fals)
    vol = make_volume(geom, T, frame_cap=32)
    for fid in range(2):
        vol = fuse_frame(vol, geom, jnp.zeros((H, W, 3)), jnp.asarray(depth), n,
                         fals.n_sq_inv, jnp.asarray(K),
                         jnp.eye(4, dtype=jnp.float32), jnp.int32(fid),
                         truncation=T, zmin=0.3, zmax=3.0)
    return vol, geom, depth, np.asarray(n), K, T


def test_check_vis_map():
    vol, geom, depth, n, K, T = _fused_scene()
    stats = debug.check_vis_map(vol, geom.voxel_size)
    assert stats["band_voxels"] > 0
    assert stats["frames"] == 2
    assert stats["per_frame_counts"][0] > 0
    assert len(stats["samples"]) >= 1


def test_normal_map_image():
    vol, geom, depth, n, K, T = _fused_scene()
    img = debug.normal_map_image(
        vol, geom, depth, n, K, np.eye(4, dtype=np.float32),
        truncation=T, zmin=0.3, zmax=3.0)
    assert img.dtype == np.uint8 and img.shape == depth.shape + (3,)
    hit = (img > 0).any(axis=-1)
    assert hit.mean() > 0.2   # central pixels covered by the volume
