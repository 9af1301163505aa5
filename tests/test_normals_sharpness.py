import jax.numpy as jnp
import numpy as np

from psgradientsdf.ops import normals as nrm
from psgradientsdf.ops import sharpness


def test_fals_flat_wall_normal():
    """A fronto-parallel wall must give normals ~ (0,0,1) away from borders."""
    H, W = 64, 64
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], dtype=np.float32)
    cache = nrm.build_fals_cache(H, W, K, window=11)
    depth = jnp.full((H, W), 1.5, dtype=jnp.float32)
    n = np.asarray(nrm.compute_normals(depth, cache, window=11))
    inner = n[16:-16, 16:-16]
    # FALS solves for the plane's inverse-depth normal: fronto-parallel wall
    # -> n parallel to +z (inward convention)
    assert np.abs(inner[..., 2]).min() > 0.99
    nn = np.linalg.norm(inner, axis=-1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-4)


def test_fals_sloped_plane():
    """Plane 1/z = a*x0 + b*y0 + c has FALS normal prop to (a,b,c)."""
    H, W = 64, 64
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], dtype=np.float32)
    cache = nrm.build_fals_cache(H, W, K, window=11)
    a, b, c = 0.1, -0.05, 0.8
    cols = (np.arange(W) - W / 2) / 80.0
    rows = (np.arange(H) - H / 2) / 80.0
    x0, y0 = np.meshgrid(cols, rows)
    z = 1.0 / (a * x0 + b * y0 + c)
    n = np.asarray(nrm.compute_normals(jnp.asarray(z, dtype=jnp.float32), cache))
    expected = np.array([a, b, c])
    expected /= np.linalg.norm(expected)
    inner = n[20:-20, 20:-20].reshape(-1, 3)
    cos = inner @ expected
    assert cos.min() > 0.999


def test_sharpness_orders_blur():
    rng = np.random.RandomState(0)
    sharp = rng.rand(64, 64).astype(np.float32)
    blurred = sharp.copy()
    for _ in range(4):
        blurred = 0.25 * (
            np.roll(blurred, 1, 0) + np.roll(blurred, -1, 0)
            + np.roll(blurred, 1, 1) + np.roll(blurred, -1, 1)
        )
    m_sharp = float(sharpness.modified_laplacian(jnp.asarray(sharp)))
    m_blur = float(sharpness.modified_laplacian(jnp.asarray(blurred)))
    assert m_sharp > m_blur * 2
    assert sharpness.is_sharp(jnp.asarray(sharp), threshold=m_blur)


def test_sharpness_rgb_uses_blue_channel():
    rng = np.random.RandomState(1)
    blue = rng.rand(32, 32).astype(np.float32)
    img = np.zeros((32, 32, 3), dtype=np.float32)
    img[..., 2] = blue
    m_rgb = float(sharpness.modified_laplacian(jnp.asarray(img)))
    m_gray = float(sharpness.modified_laplacian(jnp.asarray(blue)))
    np.testing.assert_allclose(m_rgb, m_gray, rtol=1e-5)


def test_other_measures_finite():
    img = jnp.asarray(np.random.RandomState(2).rand(32, 32).astype(np.float32))
    for fn in (
        sharpness.variance_of_laplacian,
        sharpness.tenengrad,
        sharpness.normalized_graylevel_variance,
    ):
        assert np.isfinite(float(fn(img)))
