"""FALS surface-normal estimation (Badino et al.) as fused convolutions.

Port-of-semantics of cv::NormalEstimator (cpp/include/normals/
NormalEstimator.h:23-184): per-pixel ray grids and the inverse 3x3 Gram
matrices Q are cached once per intrinsics (in float64, like the reference's
double-precision cache()); per frame, normals come from three box filters of
1/z-weighted ray components followed by the cached closed-form 3x3 solve and
normalization.

Box filters are unnormalized window sums with REFLECT_101 borders (OpenCV
boxFilter defaults), implemented as two separable 1-D convolutions —
elementwise work that XLA fuses.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _box_filter(img: jax.Array, window: int) -> jax.Array:
    """Unnormalized window-sum box filter with reflect-101 borders.

    Separable shifted-slice sums: a single-channel conv_general_dilated
    can pick a padded layout under a vmapped megapixel batch (it ran out of
    device memory on the accelerator the system was first built for), while
    slices stay in the natural layout and fuse."""
    r = window // 2
    x = jnp.pad(img, ((r, r), (r, r)), mode="reflect")
    H, W = img.shape[-2], img.shape[-1]
    acc = x[:, 0:W]
    for j in range(1, window):
        acc = acc + x[:, j:W + j]
    out = acc[0:H, :]
    for i in range(1, window):
        out = out + acc[i:H + i, :]
    return out


class FalsCache(NamedTuple):
    """Per-intrinsics precomputation (NormalEstimator.h cache(), :52-125)."""
    x0_n_sq_inv: jax.Array   # [H,W]
    y0_n_sq_inv: jax.Array   # [H,W]
    n_sq_inv: jax.Array      # [H,W]
    Q: jax.Array             # [H,W,6] packed symmetric (Q11,Q12,Q13,Q22,Q23,Q33)


def build_fals_cache(height: int, width: int, K, window: int = 11) -> FalsCache:
    """Computed in float64 on host (matches the reference's double cache)."""
    K = np.asarray(K, dtype=np.float64)
    fx_inv, fy_inv = 1.0 / K[0, 0], 1.0 / K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    cols = np.arange(width, dtype=np.float64)[None, :] - cx
    rows = np.arange(height, dtype=np.float64)[:, None] - cy
    x0 = np.broadcast_to(fx_inv * cols, (height, width))
    y0 = np.broadcast_to(fy_inv * rows, (height, width))

    n_sq = 1.0 + x0 * x0 + y0 * y0
    n_sq_inv = 1.0 / n_sq
    x0n = x0 * n_sq_inv
    y0n = y0 * n_sq_inv

    def box(a: np.ndarray) -> np.ndarray:
        r = window // 2
        p = np.pad(a, r, mode="reflect")
        c = np.cumsum(np.cumsum(p, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        H, W = a.shape
        out = (
            c[window : window + H, window : window + W]
            - c[0:H, window : window + W]
            - c[window : window + H, 0:W]
            + c[0:H, 0:W]
        )
        return out

    M11 = box(x0 * x0 * n_sq_inv)
    M12 = box(x0 * y0 * n_sq_inv)
    M13 = box(x0n)
    M22 = box(y0 * y0 * n_sq_inv)
    M23 = box(y0n)
    M33 = box(n_sq_inv)

    det = (
        M11 * M22 * M33
        + 2.0 * M12 * M23 * M13
        - (M13 * M13 * M22 + M12 * M12 * M33 + M23 * M23 * M11)
    )
    det_inv = 1.0 / det
    Q11 = det_inv * (M22 * M33 - M23 * M23)
    Q12 = det_inv * (M13 * M23 - M12 * M33)
    Q13 = det_inv * (M12 * M23 - M13 * M22)
    Q22 = det_inv * (M11 * M33 - M13 * M13)
    Q23 = det_inv * (M12 * M13 - M11 * M23)
    Q33 = det_inv * (M11 * M22 - M12 * M12)
    Q = np.stack([Q11, Q12, Q13, Q22, Q23, Q33], axis=-1)

    f32 = lambda a: jnp.asarray(a, dtype=jnp.float32)
    return FalsCache(
        x0_n_sq_inv=f32(x0n),
        y0_n_sq_inv=f32(y0n),
        n_sq_inv=f32(n_sq_inv),
        Q=f32(Q),
    )


@functools.partial(jax.jit, static_argnames=("window",))
def compute_normals(depth: jax.Array, cache: FalsCache, window: int = 11) -> jax.Array:
    """Per-frame FALS normals (NormalEstimator.h compute(), :150-176).

    Returns [H,W,3] unit normals (inward-pointing, like the reference).
    Pixels with zero depth contribute 0 to the window sums.
    """
    z_inv = jnp.where(depth != 0.0, 1.0 / jnp.where(depth == 0.0, 1.0, depth), 0.0)
    b1 = _box_filter(cache.x0_n_sq_inv * z_inv, window)
    b2 = _box_filter(cache.y0_n_sq_inv * z_inv, window)
    b3 = _box_filter(cache.n_sq_inv * z_inv, window)

    Q = cache.Q
    nx = b1 * Q[..., 0] + b2 * Q[..., 1] + b3 * Q[..., 2]
    ny = b1 * Q[..., 1] + b2 * Q[..., 3] + b3 * Q[..., 4]
    nz = b1 * Q[..., 2] + b2 * Q[..., 4] + b3 * Q[..., 5]

    n = jnp.stack([nx, ny, nz], axis=-1)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.maximum(norm, 1e-20)
