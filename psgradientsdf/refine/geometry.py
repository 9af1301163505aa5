"""Finite-difference stencil geometry on the compacted surface set.

The shared building blocks of the refinement energies/Jacobians:
one-sided distance/albedo gradients (Optimizer.cpp computeDistGrad:287-364,
computeAlbedoGrad:396-460), the 6-point Laplacian (computeDistLaplacian:
368-393), and the normal-from-distance Jacobians (normalJacobian:251-284).

All functions are dense over [N] compacted surface voxels; frozen
(non-surface) stencil neighbors come from precomputed constants in
RefineProblem — no searches, no scatter, pure gathers.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.refine.problem import RefineProblem


def gather_nbr(x: jax.Array, nbr_idx: jax.Array, const: jax.Array) -> jax.Array:
    """x[nbr] with frozen fallback: nbr_idx [N,K] (-1 -> const), x [N] or [N,C].

    Returns [N,K] (or [N,K,C])."""
    safe = jnp.maximum(nbr_idx, 0)
    g = x[safe]
    if x.ndim == 2:
        return jnp.where((nbr_idx >= 0)[..., None], g, const)
    return jnp.where(nbr_idx >= 0, g, const)


def fd_grad(prob: RefineProblem, dist: jax.Array, voxel_size: float) -> jax.Array:
    """One-sided FD gradient n_i = dir_i * (d_nbr_i - d0) / h -> [N,3]."""
    d_nbr = gather_nbr(dist, prob.nbr_idx, prob.nbr_dist_const)   # [N,3]
    return prob.nbr_dir * (d_nbr - dist[:, None]) / voxel_size


def fd_albedo_grad(prob: RefineProblem, albedo: jax.Array, voxel_size: float) -> jax.Array:
    """One-sided FD albedo gradient -> [N,3,3] = [voxel, axis, channel]."""
    a_nbr = gather_nbr(albedo, prob.nbr_idx, prob.nbr_albedo_const)  # [N,3,3]
    return prob.nbr_dir[..., None] * (a_nbr - albedo[:, None, :]) / voxel_size


def fd_laplacian(prob: RefineProblem, dist: jax.Array, voxel_size: float) -> jax.Array:
    """(d_x+ + d_x- + d_y+ + d_y- + d_z+ + d_z- - 6 d) / h^2 -> [N]."""
    d_nbr = gather_nbr(dist, prob.lap_idx, prob.lap_dist_const)   # [N,6]
    return (jnp.sum(d_nbr, axis=-1) - 6.0 * dist) / (voxel_size * voxel_size)


def normalize(v: jax.Array, eps: float = 1e-12) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def normal_jacobian(
    grad: jax.Array, direction: jax.Array, voxel_size: float, lag: bool = False
) -> jax.Array:
    """d(normalized FD grad)/d(dist entry) for a perturbation `direction`.

    Mirrors Optimizer::normalJacobian (Optimizer.cpp:269-284):
      n_d   = -direction / h
      N_inv = 1 / max(||grad||, 1e-3)
      J     = N_inv * n_d - N_inv^3 (n_d . grad) grad     (lag=False)

    grad, direction: [...,3].
    """
    n_d = -direction / voxel_size
    gnorm = jnp.linalg.norm(grad, axis=-1, keepdims=True)
    N_inv = 1.0 / jnp.maximum(gnorm, 1e-3)
    if lag:
        return N_inv * n_d
    dN = (N_inv ** 3) * jnp.sum(n_d * grad, axis=-1, keepdims=True)
    return N_inv * n_d - dN * grad


def dn_stencil(
    prob: RefineProblem, grad: jax.Array, voxel_size: float
) -> Tuple[jax.Array, jax.Array]:
    """Normal Jacobians for the 4-entry FD stencil.

    Returns (dn_d0 [N,3], dn_di [N,3,3]) where dn_d0 is d n_hat/d d0
    (direction = +pos, PsOptimizerJa.cpp:198) and dn_di[:,i] is d n_hat/d d_i
    (direction = -pos_i e_i, PsOptimizerJa.cpp:200-210).
    """
    pos = prob.nbr_dir                       # [N,3]
    dn_d0 = normal_jacobian(grad, pos, voxel_size)
    eye = jnp.eye(3, dtype=grad.dtype)
    # direction for neighbor i: -pos_i * e_i
    dirs = -pos[..., None] * eye[None, :, :]      # [N,3(axis i),3(vec)]
    dn_di = normal_jacobian(grad[:, None, :], dirs, voxel_size)
    return dn_d0, dn_di
