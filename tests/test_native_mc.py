"""Native C++ marching cubes (native/mc.cpp via ctypes) vs the numpy
reference path: identical triangle geometry on random SDF fields."""

import numpy as np
import pytest

from psgradientsdf.native import get_lib, marching_cubes_native
from psgradientsdf.ops.marching_cubes import Mesh, marching_cubes
from psgradientsdf.ops.mc_tables import TRI_TABLE

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib unavailable")


def canonical_tris(verts, faces, colors=None):
    """Order-independent triangle soup: sorted array of sorted-vertex triples."""
    tris = verts[faces]                      # [F,3,3]
    # canonicalize vertex order within each triangle by lexicographic sort
    order = np.lexsort((tris[..., 2], tris[..., 1], tris[..., 0]), axis=1)
    tris = np.take_along_axis(tris, order[..., None], axis=1)
    flat = tris.reshape(len(tris), -1)
    key = np.lexsort(flat.T[::-1])
    return flat[key]


def sphere_field(n=24, r=0.35):
    ax = (np.arange(n) + 0.5) / n - 0.5
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return r - np.sqrt(x * x + y * y + z * z)   # inside > 0


def test_native_matches_numpy_sphere():
    phi = sphere_field().astype(np.float32)
    w = np.ones_like(phi)
    rng = np.random.default_rng(0)
    col = rng.uniform(0, 1, phi.shape + (3,)).astype(np.float32)

    m_np = marching_cubes(phi, 0.02, (0.1, -0.2, 0.3), weight=w, color=col,
                          use_native=False)
    out = marching_cubes_native(phi, 0.02, (0.1, -0.2, 0.3), 0.0, TRI_TABLE,
                                weight=w, color=col)
    assert out is not None
    v, f, c = out
    assert len(f) == len(m_np.faces)
    assert len(v) == len(m_np.vertices)
    a = canonical_tris(m_np.vertices, m_np.faces)
    b = canonical_tris(v, f)
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert c is not None and c.shape == v.shape

    # colors agree vertex-by-vertex (match vertices by position)
    def color_map(verts, cols):
        return {tuple(np.round(p, 5)): cols[i] for i, p in enumerate(verts)}

    ma, mb = color_map(m_np.vertices, m_np.colors), color_map(v, c)
    assert set(ma) == set(mb)
    for k in ma:
        np.testing.assert_allclose(ma[k], mb[k], atol=1e-4)


def test_native_weight_gate_and_random_field():
    rng = np.random.default_rng(1)
    phi = rng.standard_normal((12, 14, 10)).astype(np.float32)
    w = (rng.uniform(0, 1, phi.shape) > 0.3).astype(np.float32)
    m_np = marching_cubes(phi, 0.05, (0, 0, 0), weight=w, use_native=False)
    out = marching_cubes_native(phi, 0.05, (0, 0, 0), 0.0, TRI_TABLE, weight=w)
    v, f, c = out
    assert len(f) == len(m_np.faces)
    np.testing.assert_allclose(
        canonical_tris(m_np.vertices, m_np.faces), canonical_tris(v, f), atol=1e-5
    )
    assert c is None


def test_default_path_uses_native():
    phi = sphere_field(12).astype(np.float32)
    m = marching_cubes(phi, 0.1, (0, 0, 0))
    assert isinstance(m, Mesh)
    assert len(m.faces) > 0


def test_native_ply_writers_match_python(tmp_path):
    """Native C++ PLY writers must produce byte-identical files to the
    Python fallback (same %g formatting)."""
    import os
    import numpy as np
    from psgradientsdf.io import ply
    from psgradientsdf.native import get_lib

    if get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(3)
    verts = (rng.standard_normal((257, 3)) * 1.75).astype(np.float32)
    faces = rng.integers(0, 257, (133, 3)).astype(np.int32)
    cols = rng.random((257, 3)).astype(np.float32)

    pn = tmp_path / "native_mesh.ply"
    pp = tmp_path / "python_mesh.ply"
    assert ply.write_mesh_ply(str(pn), verts, faces, cols)
    os.environ["PSGSDF_NO_NATIVE"] = "1"
    try:
        assert ply.write_mesh_ply(str(pp), verts, faces, cols)
    finally:
        del os.environ["PSGSDF_NO_NATIVE"]
    assert pn.read_bytes() == pp.read_bytes()

    pts = (rng.standard_normal((191, 3))).astype(np.float32)
    nrm = (rng.standard_normal((191, 3))).astype(np.float32)
    qn = tmp_path / "native_pc.ply"
    qp = tmp_path / "python_pc.ply"
    assert ply.write_pointcloud_ply(str(qn), pts, nrm, cols[:191])
    os.environ["PSGSDF_NO_NATIVE"] = "1"
    try:
        assert ply.write_pointcloud_ply(str(qp), pts, nrm, cols[:191])
    finally:
        del os.environ["PSGSDF_NO_NATIVE"]
    assert qn.read_bytes() == qp.read_bytes()


def test_native_grad_mc_matches_numpy():
    """Gradient-MC vertex placement (GradMarchingCubes.cpp:708-715 minus its
    color-index bug): native core == numpy path on a sphere whose gradients
    are the analytic outward normals."""
    n = 24
    phi = sphere_field(n).astype(np.float32)
    ax = (np.arange(n) + 0.5) / n - 0.5
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    # grad convention: the stored Gradient-SDF gradient is grad(dist)
    # (outward, increasing distance); vertex = lo + phi_lo*ghat = lo -
    # dist*ghat = the surface point (phi = -dist is positive inside)
    g = np.stack([x, y, z], axis=-1)
    g = (g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
         ).astype(np.float32)
    w = np.ones_like(phi)
    rng = np.random.default_rng(3)
    col = rng.uniform(0, 1, phi.shape + (3,)).astype(np.float32)
    h = 1.0 / n

    m_np = marching_cubes(phi, h, (0.0, 0.0, 0.0), weight=w, color=col,
                          grad=g, use_native=False)
    out = marching_cubes_native(phi, h, (0.0, 0.0, 0.0), 0.0, TRI_TABLE,
                                weight=w, color=col, grad=g)
    assert out is not None
    v, f, c = out
    assert len(f) == len(m_np.faces)
    assert len(v) == len(m_np.vertices)
    # grad placement collapses all edges of a corner onto one point, so
    # the soup is full of coordinate ties — round before canonical sorting
    # (float64-vs-float32 rounding between the two paths would otherwise
    # reorder tied rows)
    a = canonical_tris(np.round(m_np.vertices, 5), m_np.faces)
    b = canonical_tris(np.round(v, 5), f)
    np.testing.assert_array_equal(a, b)
    # vertices lie near the analytic sphere (the Gradient-MC promise);
    # sphere center in world coords = index (n-1)/2 at voxel h
    center = (n - 1) / 2 * h
    r = np.linalg.norm(v - center, axis=-1)
    assert np.abs(r - 0.35).max() < 0.6 * h
    np.testing.assert_allclose(sorted(np.round(c.reshape(-1), 4)),
                               sorted(np.round(m_np.colors.reshape(-1), 4)),
                               atol=1e-4)
