"""Image-sharpness focus measures for keyframe selection.

Port-of-semantics of cpp/include/ps_optimizer/SharpDetector.h:12-73. The
keyframe gate uses the modified-Laplacian (LAPM) measure; LAPV / TENG / GLVN
are also provided for parity (the reference ships but does not use them).

Note: the reference calls cv::mean on a 3-channel image and keeps .val[0],
i.e. only the FIRST (blue) channel of the BGR image enters the decision
(SharpDetector.h:35).  We replicate that: for RGB inputs the measure is
computed on channel 2 (blue).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 3-tap Gaussian from cv::getGaussianKernel(3): [0.25, 0.5, 0.25]
_GAUSS3 = jnp.array([0.25, 0.5, 0.25], dtype=jnp.float32)
_LAP3 = jnp.array([-1.0, 2.0, -1.0], dtype=jnp.float32)


def _sep_filter(img: jax.Array, kx: jax.Array, ky: jax.Array) -> jax.Array:
    """Separable 3-tap filter: kx along columns (x), ky along rows (y),
    reflect-101 borders (cv::sepFilter2D defaults).  Implemented as explicit
    shifted-slice arithmetic: a single-channel conv_general_dilated can pick
    a padded layout under a vmapped megapixel batch, while slices stay in
    the natural layout and fuse (see ops/normals.py _box_filter)."""
    r = 1
    x = jnp.pad(img, ((r, r), (r, r)), mode="reflect")
    W = img.shape[-1]
    H = img.shape[-2]
    x = kx[0] * x[:, 0:W] + kx[1] * x[:, 1:W + 1] + kx[2] * x[:, 2:W + 2]
    x = ky[0] * x[0:H, :] + ky[1] * x[1:H + 1, :] + ky[2] * x[2:H + 2, :]
    return x


def _to_measure_channel(img: jax.Array) -> jax.Array:
    if img.ndim == 3:
        return img[..., 2]  # blue channel of an RGB image == BGR channel 0
    return img


@jax.jit
def modified_laplacian(img: jax.Array) -> jax.Array:
    """LAPM (Nayar89): mean(|Lx| + |Ly|) (SharpDetector.h:22-37)."""
    src = _to_measure_channel(img)
    Lx = _sep_filter(src, _LAP3, _GAUSS3)
    Ly = _sep_filter(src, _GAUSS3, _LAP3)
    return jnp.mean(jnp.abs(Lx) + jnp.abs(Ly))


@jax.jit
def variance_of_laplacian(img: jax.Array) -> jax.Array:
    """LAPV (Pech2000) (SharpDetector.h:40-50)."""
    src = _to_measure_channel(img)
    lap_k = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)
    # cv::Laplacian 3x3 kernel [[0,1,0],[1,-4,1],[0,1,0]]
    r = 1
    x = jnp.pad(src, ((r, r), (r, r)), mode="reflect")
    lap = (
        x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:] - 4.0 * x[1:-1, 1:-1]
    )
    return jnp.var(lap)


@jax.jit
def tenengrad(img: jax.Array) -> jax.Array:
    """TENG (Krotkov86): mean(Gx^2 + Gy^2) with 3x3 Sobel (SharpDetector.h:53-63)."""
    src = _to_measure_channel(img)
    smooth = jnp.array([1.0, 2.0, 1.0], dtype=jnp.float32)
    diff = jnp.array([-1.0, 0.0, 1.0], dtype=jnp.float32)
    gx = _sep_filter(src, diff, smooth)
    gy = _sep_filter(src, smooth, diff)
    return jnp.mean(gx * gx + gy * gy)


@jax.jit
def normalized_graylevel_variance(img: jax.Array) -> jax.Array:
    """GLVN (Santos97) (SharpDetector.h:66-73)."""
    src = _to_measure_channel(img)
    return jnp.var(src) / jnp.mean(src)


def is_sharp(img: jax.Array, threshold: float) -> bool:
    """Keyframe gate (SharpDetector.h:12-18)."""
    return bool(modified_laplacian(img) >= threshold)
