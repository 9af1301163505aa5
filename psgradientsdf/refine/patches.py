"""Fused 3x3-patch image sampling for the refinement hot path.

The per-(surface voxel, keyframe) residual/Jacobian kernels need, at each
reprojection (u, v): the bilinear intensity and both finite-difference image
gradients (ops/image.py, mirroring Auxilary.h:41-123).  Evaluated naively
that is ~16 separate row-gathers per pair, and gather cost grows with the
number of index streams, so the lookups dominate the whole refinement
block.

This module fetches everything in THREE gathers per pair, from a column-span
table built on the fly (a streaming pad+concat, fused by XLA):

    span[f, r*W + c] = concat(img[f, r, clip(c-1)], img[f, r, c],
                              img[f, r, clip(c+1)])          # [F, H*W, 9]

For pixel base (r0, c0) = (floor(v), floor(u)), gathering span rows
clip(r0+dr)*W + clip(c0) for dr in {-1, 0, 1} yields the full 3x3x3 patch

    P[..., i, j, :] = img[clip(r0-1+i), clip(c0-1+j)]

with BOTH axes edge-replicated exactly like ops/image.py's per-index clip
(row clip via the gather index, column clip via the span's edge padding).

`sample_patch_all` evaluates the identical arithmetic as ops/image.py
`bilinear_rgb` / `image_gradient_rgb` on the patch (same border fallbacks,
same operation order) — validated for exact equality in tests/test_patches.py.

Memory: when the all-frames span table would be large (megapixel keyframe
sets — e.g. sokrates: 34 x 1709x1139 = a 2.4 GB table, and several are
live at once), `sample_patch_all` switches to a per-frame
lax.scan that keeps exactly ONE [H*W, 9] span table live and emits only the
small [N,3]-shaped per-frame results.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# all-frames span tables above this size take the per-frame scan path
_SPAN_BYTES_LIMIT = 512 * 1024 * 1024


def build_span(images: jax.Array) -> jax.Array:
    """images [F,H,W,3] -> column-span table [F, H*W, 9] (edge-replicated)."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    pad = jnp.pad(images, ((0, 0), (0, 0), (1, 1), (0, 0)), mode="edge")
    parts = [pad[:, :, dc:dc + W] for dc in (0, 1, 2)]
    return jnp.concatenate(parts, axis=-1).reshape(F, H * W, 9)


def fetch_patches(images: jax.Array, uv: jax.Array) -> jax.Array:
    """3x3 RGB patches at uv [N,F,2] (col,row) -> P [N,F,3(row),3(col),3(ch)]
    with P[..., i, j, :] = img[clip(r0-1+i), clip(c0-1+j)]."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    span = build_span(images)
    r0 = jnp.floor(uv[..., 1]).astype(jnp.int32)
    c0 = jnp.clip(jnp.floor(uv[..., 0]).astype(jnp.int32), 0, W - 1)

    def one(tab, r, c):                     # tab [HW,9], r/c [N]
        rows = []
        for dr in (-1, 0, 1):
            lin = jnp.clip(r + dr, 0, H - 1) * W + c
            rows.append(jnp.take(tab, lin, axis=0))      # [N,9]
        return jnp.stack(rows, axis=1)                   # [N,3,9]

    P = jax.vmap(one, in_axes=(0, 1, 1), out_axes=1)(span, r0, c0)
    return P.reshape(P.shape[:-1] + (3, 3))              # [N,F,3,3,3]


def _patch_math(P: jax.Array, uv: jax.Array, H: int, W: int
                ) -> Tuple[jax.Array, jax.Array]:
    """Bilinear intensity + image gradients from a 3x3 patch.

    P [..., 3(row), 3(col), 3(ch)], uv [..., 2] -> (I [..., 3],
    g [..., 3, 2]).  Bitwise-identical to ops.image.bilinear_rgb /
    image_gradient_rgb at every in-image coordinate."""
    r0 = jnp.floor(uv[..., 1]).astype(jnp.int32)
    c0 = jnp.floor(uv[..., 0]).astype(jnp.int32)
    fr = (uv[..., 1] - r0.astype(uv.dtype))[..., None]
    fc = (uv[..., 0] - c0.astype(uv.dtype))[..., None]
    # raw (unclipped) border flags — identical to ops/image.py
    row_ok = (r0 + 1 < H)[..., None]
    col_ok = (c0 + 1 < W)[..., None]

    def v(dr: int, dc: int) -> jax.Array:
        return P[..., dr + 1, dc + 1, :]

    v00, v01, v10, v11 = v(0, 0), v(0, 1), v(1, 0), v(1, 1)

    # --- bilinear (ops/image.py bilinear_rgb) ---
    full = (1 - fc) * (fr * v10 + (1 - fr) * v00) + fc * (fr * v11 + (1 - fr) * v01)
    col_only = (1 - fc) * v00 + fc * v01
    row_only = fr * v10 + (1 - fr) * v00
    I = jnp.where(
        row_ok & col_ok,
        full,
        jnp.where(col_ok, col_only, jnp.where(row_ok, row_only, v00)),
    )

    # --- axis 0 gradient (d/d col) ---
    d_r0 = v01 - v00
    d_r1 = v11 - v10
    b_r0 = v00 - v(0, -1)
    b_r1 = v10 - v(1, -1)
    blended = (1 - fr) * d_r0 + fr * d_r1
    blended_back = (1 - fr) * b_r0 + fr * b_r1
    gu = jnp.where(
        row_ok & col_ok,
        blended,
        jnp.where(~row_ok, d_r0, blended_back),
    )

    # --- axis 1 gradient (d/d row) ---
    d_c0 = v10 - v00
    d_c1 = v11 - v01
    b_c0 = v00 - v(-1, 0)
    b_c1 = v01 - v(-1, 1)
    blended_v = (1 - fc) * d_c0 + fc * d_c1
    blended_back_v = (1 - fc) * b_c0 + fc * b_c1
    gv = jnp.where(
        row_ok & col_ok,
        blended_v,
        jnp.where(~col_ok, d_c0, blended_back_v),
    )

    return I, jnp.stack([gu, gv], axis=-1)


def sample_patch_all(
    images: jax.Array,     # [F,H,W,3]
    uv: jax.Array,         # [N,F,2] (col,row)
) -> Tuple[jax.Array, jax.Array]:
    """One fused fetch -> (intensity [N,F,3], image gradients [N,F,3,2])."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    if F * H * W * 9 * 4 <= _SPAN_BYTES_LIMIT:
        P = fetch_patches(images, uv)
        return _patch_math(P, uv, H, W)

    # memory-bounded path: per-frame scan — one span table live at a time,
    # and only the SMALL per-frame results (never the patch tensor, whose
    # scan-carried layout pads 57x) cross the scan boundary.  Matches the
    # vmap path to 1 ulp (different fusion order).
    def per_frame(_, inp):
        img_f, uv_f = inp                                # [H,W,3], [N,2]
        P_f = fetch_patches(img_f[None], uv_f[:, None, :])[:, 0]  # [N,3,3,3]
        I_f, g_f = _patch_math(P_f, uv_f, H, W)          # [N,3], [N,3,2]
        return None, (I_f, g_f)

    _, (I, g) = jax.lax.scan(
        per_frame, None, (images, jnp.moveaxis(uv, 1, 0))
    )                                                    # [F,N,3], [F,N,3,2]
    return jnp.moveaxis(I, 0, 1), jnp.moveaxis(g, 0, 1)
