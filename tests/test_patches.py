"""Fused 3x3-patch sampling must equal the reference-semantics image ops
bit for bit at in-image coordinates (including every border fallback)."""

import numpy as np
import jax.numpy as jnp

from psgradientsdf.ops.image import bilinear_rgb, image_gradient_rgb
from psgradientsdf.refine.patches import sample_patch_all


def _check(images, uv):
    F = images.shape[0]
    I, g = sample_patch_all(jnp.asarray(images), jnp.asarray(uv))
    for f in range(F):
        r = uv[:, f, 1]
        c = uv[:, f, 0]
        I_ref = bilinear_rgb(jnp.asarray(images[f]), jnp.asarray(r), jnp.asarray(c))
        gu_ref = image_gradient_rgb(
            jnp.asarray(images[f]), jnp.asarray(r), jnp.asarray(c), axis=0)
        gv_ref = image_gradient_rgb(
            jnp.asarray(images[f]), jnp.asarray(r), jnp.asarray(c), axis=1)
        np.testing.assert_array_equal(np.asarray(I[:, f]), np.asarray(I_ref))
        np.testing.assert_array_equal(np.asarray(g[:, f, :, 0]), np.asarray(gu_ref))
        np.testing.assert_array_equal(np.asarray(g[:, f, :, 1]), np.asarray(gv_ref))


def test_patch_equals_image_ops_random():
    rng = np.random.default_rng(0)
    F, H, W, N = 3, 37, 53, 500
    images = rng.random((F, H, W, 3), dtype=np.float32)
    uv = np.stack(
        [rng.uniform(0, W - 1e-3, (N, F)), rng.uniform(0, H - 1e-3, (N, F))],
        axis=-1,
    ).astype(np.float32)
    _check(images, uv)


def test_patch_equals_image_ops_borders():
    """Exercise every border fallback: corners, edges, integer coords."""
    rng = np.random.default_rng(1)
    F, H, W = 2, 11, 13
    images = rng.random((F, H, W, 3), dtype=np.float32)
    special = [0.0, 0.25, 1.0, W - 2.0, W - 1.5, W - 1.0 - 1e-4, W - 1.0]
    special_r = [0.0, 0.25, 1.0, H - 2.0, H - 1.5, H - 1.0 - 1e-4, H - 1.0]
    pts = [(c, r) for c in special for r in special_r]
    uv = np.asarray(pts, dtype=np.float32)[:, None, :].repeat(F, axis=1)
    # W-1.0 / H-1.0 exactly at the far edge is in-image in the reference's
    # convention (m < cols); keep them
    _check(images, uv)


def test_sample_patch_scan_path_bitexact():
    """The memory-bounded per-frame scan path (used when the all-frames span
    table would exceed _SPAN_BYTES_LIMIT — megapixel keyframe sets) matches
    the all-frames vmap path to 1 ulp (different fusion order)."""
    import numpy as np
    import jax.numpy as jnp
    import psgradientsdf.refine.patches as P

    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.random((3, 40, 50, 3), np.float32))
    uv = jnp.asarray(np.stack(
        [rng.uniform(-1, 52, (100, 3)), rng.uniform(-1, 42, (100, 3))], -1
    ).astype(np.float32))
    uv = jnp.clip(uv, 0.0, jnp.asarray([49.0, 39.0]))
    Ia, ga = P.sample_patch_all(imgs, uv)
    old = P._SPAN_BYTES_LIMIT
    try:
        P._SPAN_BYTES_LIMIT = 0
        Ib, gb = P.sample_patch_all(imgs, uv)
    finally:
        P._SPAN_BYTES_LIMIT = old
    assert np.allclose(np.asarray(Ia), np.asarray(Ib), atol=1e-6)
    assert np.allclose(np.asarray(ga), np.asarray(gb), atol=1e-6)
