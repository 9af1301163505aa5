import jax.numpy as jnp
import numpy as np

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import make_volume, fuse_frame
from psgradientsdf.tracking.tracker import track_frame
from psgradientsdf.utils import se3


def build_fused_scene(dim=64, h=0.02):
    """Fuse a generic wavy heightfield at z~1.2 (constrains all 6 DOF —
    planes/spheres leave the GN Hessian rank-deficient)."""
    geom = GridGeometry(dims=(dim, dim, dim), voxel_size=h, shift=(0.0, 0.0, 1.2))
    T = 5 * h
    vol = make_volume(geom, truncation=T, frame_cap=32)
    H = W = 96
    f = 90.0
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=jnp.float32)
    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    rows = jnp.arange(H, dtype=jnp.float32)[:, None]
    x0 = jnp.broadcast_to((cols - W / 2) / f, (H, W))
    y0 = jnp.broadcast_to((rows - H / 2) / f, (H, W))
    depth = (
        1.2 + 0.08 * jnp.sin(6 * x0) * jnp.cos(5 * y0) + 0.05 * jnp.sin(3 * (x0 + y0))
    ).astype(jnp.float32)
    color = jnp.ones((H, W, 3), dtype=jnp.float32) * 0.5
    dzdx = 0.08 * 6 * jnp.cos(6 * x0) * jnp.cos(5 * y0) + 0.15 * jnp.cos(3 * (x0 + y0))
    dzdy = -0.08 * 5 * jnp.sin(6 * x0) * jnp.sin(5 * y0) + 0.15 * jnp.cos(3 * (x0 + y0))
    n = jnp.stack([-dzdx, -dzdy, jnp.ones_like(dzdx)], axis=-1)
    normals = (n / jnp.linalg.norm(n, axis=-1, keepdims=True)).astype(jnp.float32)
    n_sq_inv = (1.0 / (1.0 + x0 ** 2 + y0 ** 2)).astype(jnp.float32)
    pose = jnp.eye(4, dtype=jnp.float32)
    vol = fuse_frame(
        vol, geom, color, depth, normals, n_sq_inv, K, pose, jnp.int32(0),
        truncation=T, zmin=0.1, zmax=5.0,
    )
    return geom, vol, K, depth, T


def test_tracker_recovers_small_perturbation():
    geom, vol, K, depth, T = build_fused_scene()
    # true pose = identity; start from a small offset
    xi = jnp.array([0.01, -0.008, 0.012, 0.004, -0.006, 0.005], dtype=jnp.float32)
    init = se3.se3_exp(xi)
    res = track_frame(
        vol, geom, depth, K, init,
        truncation=T, zmin=0.1, zmax=5.0, num_iterations=50,
        conv_threshold_sq=1e-10, damping=1.0,
    )
    # recovered pose should be closer to identity than the init
    err_init = float(jnp.linalg.norm(se3.se3_log(init)))
    err_final = float(jnp.linalg.norm(se3.se3_log(res.pose)))
    assert int(res.num_valid) > 100
    assert err_final < 0.3 * err_init, (err_init, err_final)


def test_tracker_identity_is_fixed_point():
    geom, vol, K, depth, T = build_fused_scene()
    res = track_frame(
        vol, geom, depth, K, jnp.eye(4, dtype=jnp.float32),
        truncation=T, zmin=0.1, zmax=5.0, num_iterations=10,
        conv_threshold_sq=1e-6, damping=1.0,
    )
    # pose barely moves (the query's discretization bias keeps a tiny drift,
    # so assert small motion rather than strict convergence)
    assert float(jnp.linalg.norm(se3.se3_log(res.pose))) < 1e-2


def test_tracker_stride():
    geom, vol, K, depth, T = build_fused_scene()
    res = track_frame(
        vol, geom, depth, K, jnp.eye(4, dtype=jnp.float32),
        truncation=T, zmin=0.1, zmax=5.0, num_iterations=5,
        conv_threshold_sq=1e-12, damping=1.0, stride=2,
    )
    assert int(res.num_valid) > 0

def test_tracker_regather_every_matches_exact():
    """Frozen-correspondence rounds (regather_every>1) must land at the same
    pose as the exact per-iteration regather (RigidPointOptimizer semantics):
    late GN steps move points far less than a voxel, so the nearest-voxel
    assignments — and hence the piecewise-linear psi — are identical."""
    geom, vol, K, depth, T = build_fused_scene()
    xi = jnp.array([0.01, -0.008, 0.012, 0.004, -0.006, 0.005], dtype=jnp.float32)
    init = se3.se3_exp(xi)
    # reference-default convergence threshold ||xi|| < 1e-3
    # (RigidOptimizer.h:43): frozen rounds and exact regather converge to
    # the same pose
    kw = dict(truncation=T, zmin=0.1, zmax=5.0, num_iterations=50,
              conv_threshold_sq=1e-6, damping=1.0)
    exact = track_frame(vol, geom, depth, K, init, **kw)
    for R in (2, 5):
        froz = track_frame(vol, geom, depth, K, init, regather_every=R, **kw)
        diff = float(jnp.linalg.norm(
            se3.se3_log(jnp.linalg.inv(exact.pose) @ froz.pose)))
        assert diff < 5e-4, (R, diff)
        assert float(froz.energy) < 1.5 * max(float(exact.energy), 1e-6)
    # pathologically tight threshold (never converges, 50-iter cap, flat
    # discretization basin): still lands at the same energy level
    kwt = dict(kw, conv_threshold_sq=1e-10)
    exact_t = track_frame(vol, geom, depth, K, init, **kwt)
    froz_t = track_frame(vol, geom, depth, K, init, regather_every=5, **kwt)
    assert float(froz_t.energy) < 1.2 * float(exact_t.energy)
    # R=1 must be bit-exact with the default path
    r1 = track_frame(vol, geom, depth, K, init, regather_every=1, **kw)
    assert np.allclose(np.asarray(r1.pose), np.asarray(exact.pose), atol=0.0)


def test_tracker_regather_fixed_trip():
    """Fixed-trip (early_exit=False) variant with rounds: same pose as the
    while_loop variant when the budget is exhausted without convergence."""
    geom, vol, K, depth, T = build_fused_scene()
    # tiny offset: every frozen step stays inside the trust region, so the
    # fixed-trip round count consumes the budget exactly
    xi = jnp.array([3e-4, 2e-4, -3e-4, 1e-4, -2e-4, 1e-4], dtype=jnp.float32)
    init = se3.se3_exp(xi)
    kw = dict(truncation=T, zmin=0.1, zmax=5.0, num_iterations=6,
              conv_threshold_sq=0.0, damping=1.0, regather_every=3)
    a = track_frame(vol, geom, depth, K, init, early_exit=True, **kw)
    b = track_frame(vol, geom, depth, K, init, early_exit=False, **kw)
    # threshold 0 keeps GN jittering in the flat discretization basin, so
    # trust-region stalls may make the fixed-trip variant finish early at a
    # nearby basin iterate — assert agreement at basin scale (~voxel/10)
    assert np.allclose(np.asarray(a.pose), np.asarray(b.pose), atol=3e-3)
    assert int(a.iterations) == 6
    assert 0 < int(b.iterations) <= 6
    # R=1 fixed-trip is bit-exact with the while_loop variant
    kw1 = dict(kw, regather_every=1)
    a1 = track_frame(vol, geom, depth, K, init, early_exit=True, **kw1)
    b1 = track_frame(vol, geom, depth, K, init, early_exit=False, **kw1)
    assert np.allclose(np.asarray(a1.pose), np.asarray(b1.pose), atol=0.0)
    assert int(a1.iterations) == int(b1.iterations) == 6
