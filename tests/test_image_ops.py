import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.ops import image


def make_img(h=6, w=8):
    rng = np.random.RandomState(0)
    return jnp.asarray(rng.rand(h, w, 3).astype(np.float32))


def ref_bilinear(img, r, c):
    """Literal transcription of Auxilary.h:41-61 semantics (RGB input)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    x = int(np.floor(r))
    y = int(np.floor(c))
    if (x + 1) < H and (y + 1) < W:
        return (
            (y + 1.0 - c) * (r - x) * img[x + 1, y]
            + (y + 1.0 - c) * (x + 1.0 - r) * img[x, y]
            + (c - y) * (r - x) * img[x + 1, y + 1]
            + (c - y) * (x + 1.0 - r) * img[x, y + 1]
        )
    elif (y + 1) < W and x + 1 >= H:
        return (y + 1.0 - c) * img[x, y] + (c - y) * img[x, y + 1]
    elif y + 1 >= W and (x + 1) < H:
        return (r - x) * img[x + 1, y] + (x + 1.0 - r) * img[x, y]
    else:
        return img[x, y]


@pytest.mark.parametrize(
    "r,c",
    [(2.3, 4.7), (0.0, 0.0), (5.5, 3.2), (5.9, 7.9), (2.5, 7.5), (5.5, 4.0)],
)
def test_bilinear_matches_reference(r, c):
    img = make_img()
    got = image.bilinear_rgb(img, jnp.float32(r), jnp.float32(c))
    want = ref_bilinear(img, r, c)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bilinear_batched():
    img = make_img()
    rs = jnp.array([1.2, 3.4])
    cs = jnp.array([2.5, 6.1])
    out = image.bilinear_rgb(img, rs, cs)
    assert out.shape == (2, 3)
    np.testing.assert_allclose(out[0], ref_bilinear(img, 1.2, 2.5), atol=1e-5)


def test_gradient_on_linear_ramp():
    """For I(r,c) = a*c + b*r the FD gradient is exact: d/dc=a, d/dr=b."""
    H, W = 10, 12
    rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.stack([0.3 * cc + 0.1 * rr] * 3, axis=-1).astype(np.float32)
    img = jnp.asarray(img)
    gx = image.image_gradient_rgb(img, jnp.float32(4.3), jnp.float32(5.6), axis=0)
    gy = image.image_gradient_rgb(img, jnp.float32(4.3), jnp.float32(5.6), axis=1)
    np.testing.assert_allclose(gx, 0.3, atol=1e-5)
    np.testing.assert_allclose(gy, 0.1, atol=1e-5)


def test_backproject_center_pixel():
    K = jnp.array([[100.0, 0, 4.0], [0, 100.0, 3.0], [0, 0, 1]], dtype=jnp.float32)
    depth = jnp.full((7, 9), 2.0, dtype=jnp.float32)
    pts = image.backproject_grid(depth, K)
    # principal point pixel (row=3, col=4) maps to (0,0,z)
    np.testing.assert_allclose(pts[3, 4], [0.0, 0.0, 2.0], atol=1e-6)
    np.testing.assert_allclose(pts[3, 5], [0.02, 0.0, 2.0], atol=1e-6)
