"""Shading models + fused residual kernel for the photometric refinement.

One batched kernel computes, for every (surface voxel n, keyframe f):
surface-point projection, bilinear image intensity, rendered intensity
(SH order-1/2 per-keyframe light, PsOptimizerJa.cpp:30-40; or global LED
point light, LedOptimizerJa.cpp:15-29), the residual r = I - render, the
IRLS weight, and the validity mask — the shared structure of
PsOptimizer::computeResidual (PsOptimizerJa.cpp:567-626).

Conventions carried over from the reference:
  * surface point x(v) = c_v - d * normalize(v.grad)  — the *stored*
    volume gradient, not the FD gradient (OptimizerAux.cpp:215);
  * shading normal n(v) = FD gradient of dist, normalized at use
    (renderedIntensity, PsOptimizerJa.cpp:33-35);
  * a voxel-frame pair contributes iff its visibility bit is set AND the
    projection lands inside the image.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.ops.image import bilinear_rgb, image_gradient_rgb
from psgradientsdf.refine import geometry
from psgradientsdf.refine.patches import sample_patch_all
from psgradientsdf.refine.problem import RefineProblem
from psgradientsdf.utils import robust, sh


class ResidualData(NamedTuple):
    r: jax.Array          # [N,F,3] residuals (0 where invalid)
    w: jax.Array          # [N,F,3] IRLS weights (0 where invalid)
    mask: jax.Array       # [N,F] bool contribution mask
    p_cam: jax.Array      # [N,F,3] camera-frame surface points
    uv: jax.Array         # [N,F,2] float pixel coords (col, row)
    g_img: jax.Array      # [N,F,3,2] image gradients (d/du, d/dv) at uv —
                          # computed alongside I by the fused patch fetch
                          # so the Jacobian blocks need no second gather


def surface_points_world(prob: RefineProblem, geom: GridGeometry, dist: jax.Array,
                         grad_stored: jax.Array) -> jax.Array:
    """x(v) = c_v - d * ghat_stored  -> [N,3]."""
    c_v = geom.voxel2world(prob.idx_xyz)
    ghat = geometry.normalize(grad_stored)
    return c_v - dist[:, None] * ghat


def project_to_frames(
    pts_w: jax.Array,    # [N,3]
    poses: jax.Array,    # [F,4,4]
    K: jax.Array,
    img_hw: Tuple[int, int],
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (p_cam [N,F,3], uv [N,F,2] (col,row), in_img [N,F])."""
    H, W = img_hw
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    p_cam = jnp.einsum("fji,nfj->nfi", R, pts_w[:, None, :] - t[None, :, :])
    z = p_cam[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = K[0, 0] * p_cam[..., 0] / safe_z + K[0, 2]
    v = K[1, 1] * p_cam[..., 1] / safe_z + K[1, 2]
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return p_cam, jnp.stack([u, v], axis=-1), in_img


def sample_intensity(images: jax.Array, uv: jax.Array) -> jax.Array:
    """Bilinear sample [F,H,W,3] at uv [N,F,2] -> [N,F,3]."""
    def one_frame(img, uv_f):
        return bilinear_rgb(img, uv_f[:, 1], uv_f[:, 0])
    return jax.vmap(one_frame, in_axes=(0, 1), out_axes=1)(images, uv)


def sample_image_gradients(images: jax.Array, uv: jax.Array) -> jax.Array:
    """Image gradients [N,F,3,2]: last dim = (d/du, d/dv)."""
    def one_frame(img, uv_f):
        gu = image_gradient_rgb(img, uv_f[:, 1], uv_f[:, 0], axis=0)
        gv = image_gradient_rgb(img, uv_f[:, 1], uv_f[:, 0], axis=1)
        return jnp.stack([gu, gv], axis=-1)
    return jax.vmap(one_frame, in_axes=(0, 1), out_axes=1)(images, uv)


def rendered_intensity_sh(
    prob: RefineProblem,
    dist: jax.Array,
    albedo: jax.Array,
    lights: jax.Array,    # [F,B]
    voxel_size: float,
    order: int,
) -> jax.Array:
    """rho_c * (l_f . SH(n_hat)) -> [N,F,3] (PsOptimizerJa.cpp:30-40)."""
    n = geometry.normalize(geometry.fd_grad(prob, dist, voxel_size))
    basis = sh.sh_basis(n, order)                      # [N,B]
    irr = jnp.einsum("nb,fb->nf", basis, lights)       # [N,F]
    return albedo[:, None, :] * irr[..., None]


def rendered_intensity_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: jax.Array,
    albedo: jax.Array,
    grad_stored: jax.Array,
    light: jax.Array,     # [3]
    poses: jax.Array,     # [F,4,4]
    voxel_size: float,
) -> jax.Array:
    """rho_c * l_c * (-n^T R p / |p|^3) -> [N,F,3] (LedOptimizerJa.cpp:15-29)."""
    pts_w = surface_points_world(prob, geom, dist, grad_stored)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    p_cam = jnp.einsum("fji,nfj->nfi", R, pts_w[:, None, :] - t[None, :, :])
    n = geometry.normalize(geometry.fd_grad(prob, dist, voxel_size))
    Rp = jnp.einsum("fij,nfj->nfi", R, p_cam)          # R p (world direction)
    num = -jnp.einsum("ni,nfi->nf", n, Rp)
    pn = jnp.linalg.norm(p_cam, axis=-1)
    irr = num / jnp.maximum(pn, 1e-12) ** 3
    return albedo[:, None, :] * light[None, None, :] * irr[..., None]


def compute_residuals(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: jax.Array,
    albedo: jax.Array,
    grad_stored: jax.Array,
    poses: jax.Array,
    images: jax.Array,     # [F,H,W,3]
    K: jax.Array,
    lights,                # [F,B] (SH) or [3] (LED)
    *,
    model: str,
    order: int,
    loss: int,
    lam: float,
    voxel_size: float,
) -> ResidualData:
    """The fused residual/weight/mask kernel (PsOptimizerJa.cpp:567-626)."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    pts_w = surface_points_world(prob, geom, dist, grad_stored)
    p_cam, uv, in_img = project_to_frames(pts_w, poses, K, (H, W))
    # fused 3x3-patch fetch: intensity + image gradients in 3 gathers/pair
    # instead of ~16 (identical values — see refine/patches.py)
    I, g_img = sample_patch_all(images, uv)

    if model == "LED":
        rendered = rendered_intensity_led(
            prob, geom, dist, albedo, grad_stored, lights, poses, voxel_size
        )
    else:
        rendered = rendered_intensity_sh(prob, dist, albedo, lights, voxel_size, order)

    mask = prob.vis & in_img & prob.valid[:, None]
    r = jnp.where(mask[..., None], I - rendered, 0.0)
    w = jnp.where(mask[..., None], robust.irls_weight(r, loss, lam), 0.0)
    return ResidualData(r=r, w=w, mask=mask, p_cam=p_cam, uv=uv, g_img=g_img)


def ps_energy(
    prob: RefineProblem, rd: ResidualData, *, loss: int, lam: float
) -> jax.Array:
    """sum of robust losses over visible pairs / n_surface
    (PsOptimizer.cpp:47-78)."""
    per = jnp.sum(robust.loss_value(rd.r, loss, lam), axis=-1)  # [N,F]
    total = jnp.sum(jnp.where(rd.mask, per, 0.0))
    return total / jnp.maximum(prob.n_surface.astype(total.dtype), 1.0)


def normal_energy(prob: RefineProblem, dist: jax.Array, voxel_size: float) -> jax.Array:
    """mean (||grad d|| - 1)^2 (Optimizer.cpp:86-103)."""
    g = geometry.fd_grad(prob, dist, voxel_size)
    e = (jnp.linalg.norm(g, axis=-1) - 1.0) ** 2
    return jnp.sum(jnp.where(prob.valid, e, 0.0)) / jnp.maximum(
        prob.n_surface.astype(e.dtype), 1.0
    )


def laplacian_energy(prob: RefineProblem, dist: jax.Array, voxel_size: float) -> jax.Array:
    """mean (lap d)^2 (Optimizer.cpp:106-119)."""
    l = geometry.fd_laplacian(prob, dist, voxel_size)
    return jnp.sum(jnp.where(prob.valid, l * l, 0.0)) / jnp.maximum(
        prob.n_surface.astype(l.dtype), 1.0
    )


def albedo_reg_energy(prob: RefineProblem, albedo: jax.Array, voxel_size: float) -> jax.Array:
    """mean over voxels of sum of per-channel grad norms (Optimizer.cpp:122-136)."""
    g = geometry.fd_albedo_grad(prob, albedo, voxel_size)   # [N,3(axis),3(chan)]
    # reference: row-wise norms of the 3x3 (channel-major) gradient,
    # i.e. per-channel norm over axes
    per_chan = jnp.linalg.norm(g, axis=1)                   # [N,3(chan)]
    e = jnp.sum(per_chan, axis=-1)
    return jnp.sum(jnp.where(prob.valid, e, 0.0)) / jnp.maximum(
        prob.n_surface.astype(e.dtype), 1.0
    )
