import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.core.grid import GridGeometry, trilinear
from psgradientsdf.core import volume as vol_mod
from psgradientsdf.core.volume import (
    GradSdfVolume,
    fuse_frame,
    fusion_weight,
    make_volume,
    sdf_query,
    vis_bit,
    vis_count,
)


def small_geom(dim=16, h=0.1):
    return GridGeometry(dims=(dim, dim, dim), voxel_size=h, shift=(0.0, 0.0, 1.0))


def test_geometry_roundtrip():
    g = small_geom()
    idx = jnp.array([3, 5, 7], dtype=jnp.int32)
    p = g.voxel2world(idx)
    f = g.world2voxelf(p)
    np.testing.assert_allclose(f, [3.0, 5.0, 7.0], atol=1e-5)
    np.testing.assert_allclose(g.world2voxel(p), [3, 5, 7])


def test_origin_matches_reference_formula():
    g = small_geom(16, 0.1)
    # origin = shift - 0.5*h*dims (VoxelGrid.h:123)
    np.testing.assert_allclose(g.origin, (-0.8, -0.8, 0.2), atol=1e-6)


def test_nearest_info_border_rejection():
    g = small_geom()
    # a point exactly at the grid origin has float index 0 -> rejected
    p = jnp.array(g.origin, dtype=jnp.float32)
    _, valid = g.nearest_info(p)
    assert not bool(valid)
    # center is fine
    _, valid2 = g.nearest_info(jnp.array(g.shift, dtype=jnp.float32))
    assert bool(valid2)


def test_trilinear_on_linear_field():
    g = small_geom()
    coords = g.world_coords()
    field = coords[..., 0] * 2.0 + coords[..., 1] - coords[..., 2]
    p = jnp.array([0.03, -0.02, 1.04], dtype=jnp.float32)
    got = trilinear(field, g, p, extrap=99.0)
    np.testing.assert_allclose(got, 2 * 0.03 - 0.02 - 1.04, atol=1e-4)
    # outside -> extrap
    got2 = trilinear(field, g, jnp.array([10.0, 0, 0], dtype=jnp.float32), extrap=99.0)
    np.testing.assert_allclose(got2, 99.0)


def test_fusion_weight_shape():
    T = 0.5
    w = fusion_weight(jnp.array([-1.0, -0.5, -0.25, 0.0, 0.3]), T)
    np.testing.assert_allclose(w, [0.0, 0.0, 0.5, 1.0, 1.0], atol=1e-6)


def make_flat_wall_inputs(geom, z_wall=1.0, H=32, W=32):
    """Synthetic camera looking down +z at a flat wall at depth z_wall."""
    K = jnp.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], dtype=jnp.float32)
    depth = jnp.full((H, W), z_wall, dtype=jnp.float32)
    color = jnp.broadcast_to(
        jnp.array([0.8, 0.4, 0.2], dtype=jnp.float32), (H, W, 3)
    )
    # wall normal facing the camera; FALS normals are inward (away from cam): +z
    normals = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype=jnp.float32), (H, W, 3))
    n_sq_inv = jnp.ones((H, W), dtype=jnp.float32)
    pose = jnp.eye(4, dtype=jnp.float32)
    return K, depth, color, normals, n_sq_inv, pose


def test_fuse_flat_wall():
    geom = small_geom(dim=32, h=0.05)  # grid spans z in [0.2, 1.8]
    T = 5 * 0.05
    vol = make_volume(geom, truncation=T, frame_cap=64)
    K, depth, color, normals, n_sq_inv, pose = make_flat_wall_inputs(geom)
    vol2 = fuse_frame(
        vol, geom, color, depth, normals, n_sq_inv, K, pose,
        jnp.int32(0), truncation=T, zmin=0.1, zmax=3.0,
    )
    d = np.asarray(vol2.dist)
    w = np.asarray(vol2.weight)
    assert w.max() > 0
    coords = np.asarray(geom.world_coords())
    # voxels on the wall plane (z ~ 1.0) near the optical axis should have |sdf| small
    zc = coords[..., 2]
    near_wall = (np.abs(zc - 1.0) < 0.01) & (w > 0)
    assert near_wall.sum() > 0
    assert np.abs(d[near_wall]).max() < 0.05
    # voxels well in front of the wall (z ~ 0.5) should be ~ +T (truncated, but
    # weight>0 since sdf>0 in front)
    front = (np.abs(zc - 0.5) < 0.01) & (w > 0)
    assert front.sum() > 0
    np.testing.assert_allclose(d[front], T, atol=1e-5)
    # gradient should point along -z (world), since normal is +z and grad -= w*R*n
    g = np.asarray(vol2.grad)
    assert g[near_wall][:, 2].max() < 0
    # color running mean
    c = np.asarray(vol2.color)
    np.testing.assert_allclose(
        c[near_wall], np.broadcast_to([0.8, 0.4, 0.2], c[near_wall].shape), atol=1e-5
    )
    # visibility bit set exactly where updated
    vb = np.asarray(vis_bit(vol2.vis, 0))
    assert (vb == (w > 0)).all()


def test_fuse_weighted_running_mean():
    """Two identical frames must give the same dist as one (running mean)."""
    geom = small_geom(dim=32, h=0.05)
    T = 0.25
    vol = make_volume(geom, truncation=T, frame_cap=64)
    K, depth, color, normals, n_sq_inv, pose = make_flat_wall_inputs(geom)
    kw = dict(truncation=T, zmin=0.1, zmax=3.0)
    v1 = fuse_frame(vol, geom, color, depth, normals, n_sq_inv, K, pose, jnp.int32(0), **kw)
    v2 = fuse_frame(v1, geom, color, depth, normals, n_sq_inv, K, pose, jnp.int32(1), **kw)
    m = np.asarray(v1.weight) > 0
    np.testing.assert_allclose(np.asarray(v2.dist)[m], np.asarray(v1.dist)[m], atol=1e-5)
    np.testing.assert_allclose(np.asarray(v2.weight)[m], 2 * np.asarray(v1.weight)[m], atol=1e-5)
    counts = np.asarray(vis_count(v2.vis))
    assert counts[m].max() == 2


def test_sdf_query_extrapolation():
    """psi(p) = dist + ghat.(c_v - p) — the exact reference query form
    (VolumetricGradSdf.h:86: nearest voxel + gradient extrapolation with
    the (c_v - p) correction; SURVEY hard-part #5 pins this for parity)."""
    geom = small_geom(dim=16, h=0.1)
    coords = geom.world_coords()
    # plane z=1: dist = 1 - z (negative behind the plane)
    dist = 1.0 - coords[..., 2]
    grad = jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0], dtype=jnp.float32), coords.shape)
    vol = GradSdfVolume(
        dist=dist,
        grad=grad,
        weight=jnp.ones_like(dist),
        color=jnp.zeros_like(coords),
        vis=jnp.zeros((1,) + dist.shape, dtype=jnp.uint32),
    )
    p = jnp.array([0.02, -0.03, 1.234], dtype=jnp.float32)
    psi, ghat, w, valid = sdf_query(vol, geom, p, truncation=0.5)
    assert bool(valid)
    # nearest voxel of p: float idx (8.2, 7.7, 10.34) -> (8,8,10), c_v=(0,0,1.2),
    # d=-0.2; psi = -0.2 + (0,0,-1).((0,0,1.2)-(0.02,-0.03,1.234)) = -0.166
    np.testing.assert_allclose(psi, -0.166, atol=1e-4)
    np.testing.assert_allclose(ghat, [0, 0, -1], atol=1e-6)


def test_subsample_dist():
    d = jnp.full((2, 2, 2), 0.1, dtype=jnp.float32)
    g = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=jnp.float32), (2, 2, 2, 3))
    out = vol_mod.subsample_dist(d, g, voxel_size=0.2)
    assert out.shape == (2, 2, 2, 2, 2, 2)
    # children at -x get d - h/4, +x get d + h/4
    np.testing.assert_allclose(out[0, 0, 0, :, :, 0], 0.1 - 0.05, atol=1e-6)
    np.testing.assert_allclose(out[0, 0, 0, :, :, 1], 0.1 + 0.05, atol=1e-6)
