"""Analytic Jacobian blocks for the photometric refinement (SH + LED).

Dense batched re-derivations of the reference's per-(voxel,frame) sparse
Jacobian assembly (cpp/include/ps_optimizer/PsOptimizerJa.cpp:61-289 for SH,
LedOptimizerJa.cpp:32-218 for LED).  Instead of triplet lists + O(N)
std::find column lookups, every block is a dense [N,F,...] tensor whose
sparse structure (self + <=3 stencil neighbors for distance) is realized by
precomputed compact neighbor indices — the scatter/gather work of applying
J^T is in solvers.py.

Shared pieces:
  image_pi_grad [N,F,3,3]: dI/dx = (image gradient at the reprojection) o
  (projection Jacobian) — PsOptimizerJa.cpp:78-90.

Deviations from the reference (documented, deliberate):
  * LED distance Jacobian: the reference flips the sign of the neighbor
    normal-perturbation directions vs the SH path (LedOptimizerJa.cpp:
    157-167 uses += where PsOptimizerJa.cpp:200-210 uses -=); the SH
    convention is the mathematically correct derivative of the one-sided FD
    normal, so both models use it here (validated against jax.grad in
    tests/test_refine_jacobians.py; experimentally, the LED alternating
    loop reaches ~42% lower PS energy with this convention than with the
    reference's on a 3-view near-field scene —
    tests/test_led_convention.py, trace 2.111 -> 0.0037 vs -> 0.0064).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.refine import geometry
from psgradientsdf.refine.problem import RefineProblem
from psgradientsdf.refine.render import (
    ResidualData,
    surface_points_world,
)
from psgradientsdf.utils import se3, sh


def image_pi_grad(
    images: jax.Array,   # [F,H,W,3] (unused — gradients ride the residual
    rd: ResidualData,    #  fetch; kept for call-site stability)
    K: jax.Array,
) -> jax.Array:
    """dI/dx_cam [N,F,3,3]: image gradient composed with projection gradient
    (PsOptimizerJa.cpp:78-90)."""
    del images
    g_img = rd.g_img                                  # [N,F,3,2] (du, dv)
    fx, fy = K[0, 0], K[1, 1]
    z = rd.p_cam[..., 2]
    z_inv = 1.0 / jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    z_inv_sq = z_inv * z_inv
    # G[...,c,:] = gu*row_u + gv*row_v with row_u = [fx/z, 0, -fx*px/z^2],
    # row_v = [0, fy/z, -fy*py/z^2] — expanded directly (a materialized
    # [N,F,2,3] pi intermediate is a large extra buffer under a padded
    # minor-dim layout; at the upsampled sokrates scale it reached 18 GB)
    gu = g_img[..., 0]                                # [N,F,3]
    gv = g_img[..., 1]
    gx = gu * (fx * z_inv)[..., None]
    gy = gv * (fy * z_inv)[..., None]
    gz = -(
        gu * (fx * rd.p_cam[..., 0] * z_inv_sq)[..., None]
        + gv * (fy * rd.p_cam[..., 1] * z_inv_sq)[..., None]
    )
    return jnp.stack([gx, gy, gz], axis=-1)


def pose_jacobian_sh(
    G: jax.Array,        # [N,F,3,3] image_pi_grad
    rd: ResidualData,
    poses: jax.Array,    # [F,4,4]
) -> jax.Array:
    """J_c [N,F,3,6] = [-G R^T | G skew(p_cam)] (PsOptimizerJa.cpp:109-110)."""
    R = poses[:, :3, :3]
    left = -jnp.einsum("nfcx,fyx->nfcy", G, R)   # -G R^T
    right = jnp.einsum("nfcx,nfxy->nfcy", G, se3.hat(rd.p_cam))
    return jnp.concatenate([left, right], axis=-1)


def pose_jacobian_led(
    G: jax.Array,
    rd: ResidualData,
    poses: jax.Array,
    albedo: jax.Array,        # [N,3]
    grad_stored: jax.Array,   # [N,3]
    light: jax.Array,         # [3]
) -> jax.Array:
    """LED pose Jacobian with the near-field extra terms
    (LedOptimizerJa.cpp:63-78), in the corrected form (documented
    deviation — see module docstring):

    The irradiance m = -n^T R p / |p|^3 depends on the pose only through
    the world ray x - t = R p_cam (|p_cam| = |x - t|), so
      * translation: d(rendered)/dxi_t = rho l (-n/L^3 + 3 (n.d) d / L^5)
        with d = R p_cam — the reference carries only the first term and
        parks the radius-falloff in a rotation expression;
      * rotation: m is INVARIANT (R p_cam independent of the R update) —
        the reference's extra rotation term hat(p) p is identically the
        zero vector (p x p), so dropping it changes nothing numerically.
    Validated against jax autodiff through the full residual
    (tests/test_refine_jacobians.py::test_pose_jacobian_matches_autodiff).
    As everywhere in the refinement, n is the normalized stored gradient,
    which the reference's updateGrad keeps equal to the FD shading normal
    after every distance update."""
    R = poses[:, :3, :3]
    base_left = -jnp.einsum("nfcx,fyx->nfcy", G, R)
    base_right = jnp.einsum("nfcx,nfxy->nfcy", G, se3.hat(rd.p_cam))

    normal = geometry.normalize(grad_stored)          # [N,3]
    pn = jnp.linalg.norm(rd.p_cam, axis=-1)           # [N,F]
    l3 = jnp.maximum(pn, 1e-12) ** 3
    l5 = jnp.maximum(pn, 1e-12) ** 5
    rho_l = albedo * light[None, :]                   # [N,3]
    Rp = jnp.einsum("fij,nfj->nfi", R, rd.p_cam)      # world ray x - t
    nRp = jnp.einsum("ni,nfi->nf", normal, Rp)
    term_vec = (
        -normal[:, None, :] / l3[..., None]
        + 3.0 * nRp[..., None] * Rp / l5[..., None]
    )                                                 # [N,F,3vec]
    led_t = rho_l[:, None, :, None] * term_vec[:, :, None, :]
    return jnp.concatenate([base_left + led_t, base_right], axis=-1)


def albedo_jacobian_sh(
    prob: RefineProblem, grad_stored: jax.Array, lights: jax.Array, order: int
) -> jax.Array:
    """J_rho [N,F] scalar (same for all channels): -l_f . SH(ghat_stored)
    (PsOptimizerJa.cpp:118-122)."""
    n = geometry.normalize(grad_stored)
    basis = sh.sh_basis(n, order)               # [N,B]
    return -jnp.einsum("nb,fb->nf", basis, lights)


def albedo_jacobian_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: jax.Array,
    grad_stored: jax.Array,
    poses: jax.Array,
    light: jax.Array,
) -> jax.Array:
    """LED J_rho [N,F,3]: +(n^T R p / |p|^3) * l (LedOptimizerJa.cpp:85-99)."""
    refl = _led_reflectance(prob, geom, dist, grad_stored, poses)   # [N,F]
    return refl[..., None] * light[None, None, :]


def light_jacobian_sh(
    prob: RefineProblem, albedo: jax.Array, grad_stored: jax.Array, order: int
) -> jax.Array:
    """J_l [N,F=broadcast,3,B]: channel c row = -rho_c SH(ghat_stored)
    (PsOptimizerJa.cpp:132-143). Frame-independent -> [N,3,B]."""
    n = geometry.normalize(grad_stored)
    basis = sh.sh_basis(n, order)               # [N,B]
    return -albedo[..., None] * basis[:, None, :]


def light_jacobian_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: jax.Array,
    grad_stored: jax.Array,
    albedo: jax.Array,
    poses: jax.Array,
) -> jax.Array:
    """LED J_light [N,F,3]: +(n^T R p / |p|^3) * rho_c
    (LedOptimizerJa.cpp:101-115)."""
    refl = _led_reflectance(prob, geom, dist, grad_stored, poses)
    return refl[..., None] * albedo[:, None, :]


def _led_reflectance(prob, geom, dist, grad_stored, poses):
    """(n^T R p) / |p|^3 with n = ghat_stored (LedOptimizerJa.cpp:93-95)."""
    n = geometry.normalize(grad_stored)
    pts_w = surface_points_world(prob, geom, dist, grad_stored)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    p_cam = jnp.einsum("fji,nfj->nfi", R, pts_w[:, None, :] - t[None, :, :])
    Rp = jnp.einsum("fij,nfj->nfi", R, p_cam)
    num = jnp.einsum("ni,nfi->nf", n, Rp)
    pn = jnp.linalg.norm(p_cam, axis=-1)
    return num / jnp.maximum(pn, 1e-12) ** 3


class DistJacobian(NamedTuple):
    J0: jax.Array    # [N,F,3] d r / d d_self
    Ji: jax.Array    # [N,3,F,3] d r / d d_neighbor(axis)


def dist_jacobian_sh(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: jax.Array,
    albedo: jax.Array,
    grad_stored: jax.Array,
    lights: jax.Array,
    G: jax.Array,          # [N,F,3,3] image_pi_grad
    poses: jax.Array,
    voxel_size: float,
    order: int,
) -> DistJacobian:
    """SH distance Jacobian: reprojection-shift + shading-normal coupling
    over the 4-voxel stencil (PsOptimizerJa.cpp:160-289)."""
    grad_fd = geometry.fd_grad(prob, dist, voxel_size)        # [N,3]
    dn_d0, dn_di = geometry.dn_stencil(prob, grad_fd, voxel_size)  # [N,3], [N,3,3]
    ghat_stored = geometry.normalize(grad_stored)

    R = poses[:, :3, :3]
    GRt = jnp.einsum("nfcx,fyx->nfcy", G, R)                  # G R^T

    dx_d0 = -ghat_stored - dist[:, None] * dn_d0              # [N,3]
    dI0 = jnp.einsum("nfcy,ny->nfc", GRt, dx_d0)
    dx_di = -dist[:, None, None] * dn_di                      # [N,3,3]
    dIi = jnp.einsum("nfcy,nay->nfac", GRt, dx_di)            # [N,F,3(axis),3(chan)]
    dIi = jnp.moveaxis(dIi, 2, 1)                             # [N,3,F,3]

    if order == 1:
        # dR [N,F,3,3]: row c = rho_c * l_f[1:4]
        dR = albedo[:, None, :, None] * lights[None, :, None, 1:4]
        shade0 = jnp.einsum("nfcy,ny->nfc", dR, dn_d0)
        shadei = jnp.einsum("nfcy,nay->nafc", dR, dn_di)
    else:
        dsh = sh.dsh_dn(geometry.normalize(grad_fd), 2)        # [N,3,9]
        dSH0 = jnp.einsum("nyb,ny->nb", dsh, dn_d0)            # [N,9]
        dSHi = jnp.einsum("nyb,nay->nab", dsh, dn_di)          # [N,3,9]
        dR = albedo[:, None, :, None] * lights[None, :, None, :]   # [N,F,3,9]
        shade0 = jnp.einsum("nfcb,nb->nfc", dR, dSH0)
        shadei = jnp.einsum("nfcb,nab->nafc", dR, dSHi)

    J0 = dI0 - shade0
    Ji = dIi - shadei
    return DistJacobian(J0=J0, Ji=Ji)


def dist_jacobian_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: jax.Array,
    albedo: jax.Array,
    grad_stored: jax.Array,
    light: jax.Array,
    G: jax.Array,
    poses: jax.Array,
    voxel_size: float,
) -> DistJacobian:
    """LED distance Jacobian with attenuation chain rule
    (LedOptimizerJa.cpp:117-218; neighbor-direction sign corrected, see
    module docstring)."""
    grad_fd = geometry.fd_grad(prob, dist, voxel_size)
    n_fd = geometry.normalize(grad_fd)
    dn_d0, dn_di = geometry.dn_stencil(prob, grad_fd, voxel_size)
    ghat_stored = geometry.normalize(grad_stored)

    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    pts_w = surface_points_world(prob, geom, dist, grad_stored)
    p_cam = jnp.einsum("fji,nfj->nfi", R, pts_w[:, None, :] - t[None, :, :])
    GRt = jnp.einsum("nfcx,fyx->nfcy", G, R)

    dx_d0 = -ghat_stored - dist[:, None] * dn_d0
    dI0 = jnp.einsum("nfcy,ny->nfc", GRt, dx_d0)
    dx_di = -dist[:, None, None] * dn_di                      # [N,3(axis),3]
    dIi = jnp.moveaxis(jnp.einsum("nfcy,nay->nfac", GRt, dx_di), 2, 1)

    Rp = jnp.einsum("fij,nfj->nfi", R, p_cam)                 # [N,F,3]
    pn = jnp.maximum(jnp.linalg.norm(p_cam, axis=-1), 1e-12)
    radius = pn ** 3
    m_val = jnp.einsum("ni,nfi->nf", n_fd, Rp)                # n_fd^T R p

    def m_terms(dn, dx):
        # dn [N,3], dx [N,3] -> dm [N,F]
        t1 = jnp.einsum("ny,nfy->nf", dn, Rp)
        t2 = jnp.einsum("ny,ny->n", n_fd, dx)[:, None]
        num = t1 + t2
        # radius part: -3 (p^T R^T dx)/|p|^5 = -3 (Rp . dx)/|p|^5
        pRtdx = jnp.einsum("nfi,ni->nf", Rp, dx)
        rad = -3.0 * pRtdx / pn ** 5
        return num / radius + rad * m_val

    dm0 = m_terms(dn_d0, dx_d0)
    dR_vec = albedo * light[None, :]                          # [N,3]
    J0 = dI0 + dR_vec[:, None, :] * dm0[..., None]

    Ji_list = []
    for ax in range(3):
        dmi = m_terms(dn_di[:, ax], dx_di[:, ax])
        Ji_list.append(dIi[:, ax] + dR_vec[:, None, :] * dmi[..., None])
    return DistJacobian(J0=J0, Ji=jnp.stack(Ji_list, axis=1))
