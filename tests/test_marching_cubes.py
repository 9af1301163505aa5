"""Marching-cubes correctness: topology + geometry of the generated tables."""

import numpy as np
import pytest

from psgradientsdf.ops.mc_tables import EDGE_TABLE, TRI_TABLE, MAX_TRIS
from psgradientsdf.ops.marching_cubes import marching_cubes, extract_mesh_from_volume


def test_tables_shape_and_empty_cases():
    assert TRI_TABLE.shape == (256, 16)
    assert EDGE_TABLE.shape == (256,)
    assert (TRI_TABLE[0] == -1).all()
    assert (TRI_TABLE[255] == -1).all()
    # single-corner cases emit exactly one triangle
    for c in (1, 2, 4, 128):
        assert (TRI_TABLE[c] >= 0).sum() == 3


def test_all_configs_emit_whole_triangles():
    """Complement symmetry is NOT an MC-table invariant (ambiguous faces
    resolve asymmetrically); whole-triangle structure and watertightness
    (below) are."""
    for c in range(256):
        n = (TRI_TABLE[c] >= 0).sum()
        assert n % 3 == 0
        if c not in (0, 255):
            assert n > 0


def _edge_multiset(faces):
    edges = {}
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edges[(a, b)] = edges.get((a, b), 0) + 1
    return edges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watertight_on_random_fields(seed):
    """Every directed edge must be matched by its reverse (closed, consistently
    oriented surface) for smooth random fields away from the boundary."""
    rng = np.random.RandomState(seed)
    n = 12
    # smooth random field via low-frequency cosines, padded positive border
    x = np.linspace(0, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    phi = np.zeros((n, n, n))
    for _ in range(4):
        k = rng.randint(1, 4, 3)
        phi += rng.randn() * np.cos(np.pi * (k[0] * X + k[1] * Y + k[2] * Z))
    phi += 0.1
    # force the border outside so the surface is closed within the volume
    phi[0, :, :] = phi[-1, :, :] = 1.0
    phi[:, 0, :] = phi[:, -1, :] = 1.0
    phi[:, :, 0] = phi[:, :, -1] = 1.0
    mesh = marching_cubes(phi, 1.0, (0.0, 0.0, 0.0), level=0.0)
    assert len(mesh.faces) > 0
    em = _edge_multiset(mesh.faces)
    for (a, b), cnt in em.items():
        assert em.get((b, a), 0) == cnt, "unmatched directed edge -> hole or flip"


def test_sphere_geometry_and_euler():
    n = 24
    c = (n - 1) / 2.0
    zz, yy, xx = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    r = np.sqrt((xx - c) ** 2 + (yy - c) ** 2 + (zz - c) ** 2)
    R = 8.0
    phi = R - r          # inside = phi > 0
    mesh = marching_cubes(phi, 1.0, (0.0, 0.0, 0.0), level=0.0)
    assert len(mesh.vertices) > 100
    # vertex radius ~ R
    d = np.linalg.norm(mesh.vertices - c, axis=1)
    np.testing.assert_allclose(d, R, atol=0.2)
    # Euler characteristic of a sphere: V - E + F = 2
    E = {tuple(sorted((f[i], f[(i + 1) % 3]))) for f in mesh.faces for i in range(3)}
    euler = len(mesh.vertices) - len(E) + len(mesh.faces)
    assert euler == 2, euler
    # outward orientation: normals point away from center (phi decreasing)
    v = mesh.vertices
    f = mesh.faces
    nrm = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    centroid = v[f].mean(axis=1) - c
    assert (np.einsum("ij,ij->i", nrm, centroid) > 0).mean() > 0.99


def test_plane_vertices_on_plane():
    n = 10
    zz = np.arange(n, dtype=np.float64)
    phi = np.broadcast_to((4.3 - zz)[:, None, None], (n, n, n))  # plane z=4.3
    mesh = marching_cubes(np.ascontiguousarray(phi), 0.5, (1.0, 2.0, 3.0), level=0.0)
    assert len(mesh.vertices) > 0
    np.testing.assert_allclose(mesh.vertices[:, 2], 3.0 + 0.5 * 4.3, atol=1e-5)


def test_weight_gate():
    """Cubes with any zero-weight corner are skipped (MarchingCubes.cpp:528-535)."""
    n = 8
    zz = np.arange(n, dtype=np.float64)
    phi = np.broadcast_to((3.5 - zz)[:, None, None], (n, n, n)).copy()
    w = np.ones((n, n, n))
    mesh_all = marching_cubes(phi, 1.0, (0, 0, 0), weight=w)
    w2 = w.copy()
    w2[:, :4, :] = 0.0
    mesh_gated = marching_cubes(phi, 1.0, (0, 0, 0), weight=w2)
    assert len(mesh_gated.faces) < len(mesh_all.faces)
    assert len(mesh_gated.faces) > 0
    assert mesh_gated.vertices[:, 1].min() >= 3.0  # gated region removed


def test_extract_mesh_from_volume_colors():
    n = 16
    c = (n - 1) / 2.0
    zz, yy, xx = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    r = np.sqrt((xx - c) ** 2 + (yy - c) ** 2 + (zz - c) ** 2)
    dist = (r - 5.0) * 0.1   # negative inside (reference convention), h=0.1
    weight = np.ones((n, n, n))
    color = np.zeros((n, n, n, 3))
    color[..., 0] = 0.9
    mesh = extract_mesh_from_volume(dist, weight, color, 0.1, (0.0, 0.0, 0.0), band=0.6)
    assert len(mesh.vertices) > 0
    assert mesh.colors is not None
    np.testing.assert_allclose(mesh.colors[:, 0], 0.9, atol=1e-6)


def test_gradient_mc_vertex_placement():
    """Gradient-MC variant: vertices at p_lo + phi_lo * ghat_lo
    (GradMarchingCubes.cpp:707-714) — on an exact-SDF sphere all vertices
    must land on the sphere surface."""
    import numpy as np
    from psgradientsdf.ops.marching_cubes import marching_cubes

    n = 24
    h = 0.04
    ax = (np.arange(n) - n / 2 + 0.5) * h
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    r = 0.3
    d = np.sqrt(x * x + y * y + z * z) - r        # negative inside
    phi = (-d).astype(np.float32)                 # positive inside (MC field)
    g = np.stack([x, y, z], -1)
    g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)

    origin = (float(ax[0] / 1), float(ax[0]), float(ax[0]))
    m = marching_cubes(phi, h, origin, grad=g.astype(np.float32))
    assert len(m.vertices) > 100
    radii = np.linalg.norm(m.vertices, axis=-1)
    # every vertex lies on the sphere to first order
    assert np.abs(radii - r).max() < 1e-3
