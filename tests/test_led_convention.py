"""LED neighbor-sign convention experiment (VERDICT round-1 weak #6).

The reference's LED distance Jacobian builds the neighbor normal-perturbation
directions with the OPPOSITE sign from its own SH path
(LedOptimizerJa.cpp:146-167 `n_d1[a] += dir[a]` vs PsOptimizerJa.cpp:200-210
`-=`); this repo deliberately uses the SH convention — the true derivative of
the one-sided FD normal — for both models (refine/jacobians.py docstring,
validated against jax.grad in test_refine_jacobians.py).

Every neighbor term in dist_jacobian_led is linear-homogeneous in the
perturbation direction (dIi via dx_di = -d*dn_di; the m-term via dn and dx),
so the reference's convention is exactly DistJacobian(J0, -Ji).  This test
runs the LED alternating loop under both conventions on a nontrivial
multi-view near-field scene and asserts the corrected convention reaches
equal-or-better energy — the experimental evidence the deviation note
promises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.config import OptimizerConfig, LED
from psgradientsdf.refine import jacobians, solvers
from psgradientsdf.refine.jacobians import DistJacobian
from psgradientsdf.refine.optimizer import (
    PhotometricRefiner, _albedo_block, _light_block, _pose_block, _residuals,
)
from psgradientsdf.utils import robust, se3

from helpers import wavy_scene
from test_refine_led_upsample import led_images


@functools.partial(
    jax.jit,
    static_argnames=("geom", "loss", "lam", "voxel_size", "reg_weight_n",
                     "reg_weight_l", "damping", "neighbor_sign"),
)
def _dist_block_signed(prob, geom, dist, albedo, grad_stored, poses, images,
                       K, lights, *, loss, lam, voxel_size, reg_weight_n,
                       reg_weight_l, damping, neighbor_sign):
    """_dist_block for the LED model with a selectable neighbor-direction
    sign: +1 = this repo's (SH-consistent) convention, -1 = the reference's
    LedOptimizerJa.cpp:146-167 convention."""
    rd = _residuals.__wrapped__(
        prob, geom, dist, albedo, grad_stored, poses, images, K, lights,
        model=LED, order=1, loss=loss, lam=lam, voxel_size=voxel_size,
    )
    G = jacobians.image_pi_grad(images, rd, K)
    DJ = jacobians.dist_jacobian_led(
        prob, geom, dist, albedo, grad_stored, lights, G, poses, voxel_size)
    DJ = DistJacobian(J0=DJ.J0, Ji=neighbor_sign * DJ.Ji)
    delta = solvers.solve_distance(
        prob, rd, DJ, dist, voxel_size,
        reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l, damping=damping,
        laplacian_diag_only=False,
    )
    return solvers.update_distance(prob, dist, delta, voxel_size)


def _make_refiner():
    # three camera poses -> multi-view visibility, curvature + varying albedo
    poses = [jnp.eye(4, dtype=jnp.float32)]
    for dx, dy, yaw in ((0.06, -0.04, 0.05), (-0.05, 0.05, -0.04)):
        xi = jnp.array([dx, dy, 0.0, 0.0, yaw, 0.0], dtype=jnp.float32)
        poses.append(se3.se3_exp(xi))
    sc = wavy_scene(dim=48, h=0.03, H=64, W=64, f=60.0, poses=poses)
    light_gt = jnp.array([1.2, 1.0, 0.9], dtype=jnp.float32)
    images = led_images(sc["frames"], np.asarray(sc["K"]), light_gt)
    cfg = OptimizerConfig(
        max_it=4, conv_threshold=1e-6, damping=1.0, lam=0.2,
        reg_weight_n=0.1, reg_weight_l=0.0, reg_weight_rho=0.0,
        order=1, upsample=False, model=LED, loss=robust.CAUCHY,
    )
    ref = PhotometricRefiner(
        sc["vol"], sc["geom"], cfg, np.asarray(sc["K"]),
        truncation=sc["truncation"],
    )
    ref.set_keyframes(
        images, jnp.stack(poses), list(range(len(poses))),
        [f"{i:03d}" for i in range(len(poses))],
    )
    ref.init()
    ref.init_albedo()
    return ref


def _run_alternating(ref, state, neighbor_sign, iters=4):
    """Alternating {albedo, light, dist(sign), pose} loop from a fixed
    initial state; returns the PS-energy trace (incl. the initial energy)."""
    dist, albedo, grad_stored, poses, lights = state
    kw = dict(loss=robust.CAUCHY, lam=0.2, voxel_size=ref.geom.voxel_size)
    full_kw = dict(model=LED, order=1, **kw)
    args = lambda: (ref.prob, ref.geom, dist, albedo, grad_stored, poses,
                    ref.images, ref.K, lights)

    def ps_energy():
        from psgradientsdf.refine import render
        rd = _residuals(*args(), **full_kw)
        return float(render.ps_energy(ref.prob, rd, loss=robust.CAUCHY,
                                      lam=0.2))

    trace = [ps_energy()]
    for _ in range(iters):
        albedo = _albedo_block(*args(), **full_kw, reg_weight_rho=0.0,
                               damping=1.0)
        lights = _light_block(*args(), **full_kw, damping=1.0)
        dist, grad_stored = _dist_block_signed(
            *args(), **kw, reg_weight_n=0.1, reg_weight_l=0.0, damping=1.0,
            neighbor_sign=neighbor_sign)
        poses = _pose_block(*args(), **full_kw, damping=1.0)
        trace.append(ps_energy())
    return trace


def test_led_convention_equal_or_better():
    ref = _make_refiner()
    state = (ref.dist, ref.albedo, ref.grad_stored, ref.poses, ref.lights)

    ours = _run_alternating(ref, state, neighbor_sign=1.0)
    ref_conv = _run_alternating(ref, state, neighbor_sign=-1.0)

    # identical starting energy (same initial state)
    assert ours[0] == pytest.approx(ref_conv[0], rel=1e-6)
    assert np.isfinite(ours).all(), ours
    # the corrected convention must make real progress on the scene ...
    assert min(ours) < 0.5 * ours[0], ours
    # ... and end equal-or-better than the reference's convention
    # (allow a hair of tolerance; the claim is "equal or better")
    assert min(ours) <= min(ref_conv) * 1.02 + 1e-9, (ours, ref_conv)
    assert ours[-1] <= ref_conv[-1] * 1.02 + 1e-9, (ours, ref_conv)
