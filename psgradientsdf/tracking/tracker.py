"""Rigid camera tracking: per-frame Gauss-Newton on the point-to-SDF objective.

Accelerator-oriented redesign of RigidPointOptimizer (cpp/include/sdf_tracker/
RigidPointOptimizer.cpp:12-124).  The reference's serial per-pixel loop
becomes one fused dense kernel per GN iteration:

    per pixel: backproject -> world -> Gradient-SDF query psi, ghat
               J_xi = [ghat; p x ghat]
    reduce:    E = sum psi^2, g = sum psi*J, H = sum J J^T   (a 6+36-wide
               masked reduction — exactly a psum when sharded)

wrapped in a lax.while_loop with the reference's early exit
(||xi||^2 < conv_threshold^2 checked *after* the solve, *before* the pose
update — RigidPointOptimizer.cpp:66-74).  The whole ≤50-iteration solve runs
on-device in a single jit; only the final pose returns to host.

The per-pixel reduction is also exposed as `gn_terms` for the sharded
tracker in parallel/shard.py (per-slab partial sums + psum).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import (
    GradSdfVolume,
    PackedVolume,
    pack_tracking_payload,
    sdf_query,
    sdf_records_packed,
)
from psgradientsdf.utils import se3


class TrackResult(NamedTuple):
    pose: jax.Array        # [4,4] refined camera-to-world pose
    converged: jax.Array   # bool
    iterations: jax.Array  # int32 — GN iterations executed
    energy: jax.Array      # mean psi^2 at the last evaluated iterate
    num_valid: jax.Array   # int32 — pixels contributing to the last solve


def gn_terms(
    vol: GradSdfVolume,
    geom: GridGeometry,
    pts_cam: jax.Array,    # [N,3] valid-depth camera-frame points
    valid_z: jax.Array,    # [N] bool depth-range mask
    pose: jax.Array,       # [4,4]
    truncation: float,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-pixel residual/Jacobian terms reduced to (E, g[6], H[6,6], count).

    Mirrors the hot loop of RigidPointOptimizer.cpp:38-60.
    """
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_w = pts_cam @ R.T + t
    psi, ghat, w, valid = sdf_query(vol, geom, p_w, truncation)
    m = valid_z & (w > 0.0) & valid
    mf = m.astype(psi.dtype)

    J = jnp.concatenate([ghat, jnp.cross(p_w, ghat)], axis=-1)  # [N,6]
    psi_m = psi * mf
    E = jnp.sum(psi_m * psi)
    g = J.T @ psi_m
    H = (J * mf[:, None]).T @ J
    count = jnp.sum(m)
    return E, g, H, count


def run_gn_rounds(
    geom: GridGeometry,
    gather_records,
    masked_gram,
    init_pose: jax.Array,
    *,
    num_iterations: int,
    conv_threshold_sq: float,
    damping: float,
    regather_every: int = 1,
    early_exit: bool = True,
    records_flagged: bool = False,
):
    """The frozen-correspondence GN driver shared by the single-device and
    sharded trackers (identical step semantics — the sharded tracker differs
    only in that its `masked_gram` psums the Gram reduction over the mesh).

    gather_records(pose) -> rec (opaque pytree of frozen correspondences);
    masked_gram(pose, rec) -> (E, g[6], H[6,6], count).

    With records_flagged=True, gather_records returns (rec, flag) and the
    driver ORs every round's flag into the returned `flag` (the resident
    tracker's exactness bit, core/resident.py).

    Returns (pose, converged, failed, E_mean, count, iters, flag).  See
    track_frame for the semantics of rounds / freshness / trust region.
    """
    # GN step: updates are MASKED once converged/failed/out-of-budget (pose
    # frozen at the first converged iterate, step not applied — matching the
    # reference's return-before-update, RigidPointOptimizer.cpp:66-74).
    #
    # `fresh` marks the iteration right after a correspondence gather.
    # GLOBAL convergence may only be declared on fresh iterations: a frozen
    # round solves its piecewise-linear subproblem exactly, so a non-fresh
    # ||xi|| ~ 0 merely says the *subproblem* is done ("stalled") — the next
    # round regathers and re-checks against fresh correspondences.
    def gn_step(carry, rec, fresh):
        pose, conv, fail, stalled, E_mean, count, iters = carry
        active = (~conv) & (~fail) & (~stalled) & (iters < num_iterations)
        E, g, Hm, cnt = masked_gram(pose, rec)
        fail_now = cnt < 0.5
        # Gauss-Newton step via Cholesky (cpp:66); relative jitter guards
        # PD-ness on degenerate scenes (the reference's bare llt would
        # silently produce garbage there).
        Hj = Hm + (1e-6 * jnp.trace(Hm) / 6.0 + 1e-12) * jnp.eye(6, dtype=Hm.dtype)
        chol = jax.scipy.linalg.cho_factor(Hj)
        xi = damping * jax.scipy.linalg.cho_solve(chol, g)
        small = jnp.sum(xi * xi) < conv_threshold_sq
        if fresh:
            conv_now = small
            stall_now = jnp.bool_(False)
            trust = jnp.bool_(True)
        else:
            # trust region for frozen correspondences: a frozen step is only
            # applied while it moves every point by well under a voxel
            # (displacement bound ||v|| + lever * ||w||); larger steps end
            # the round so the next gather refreshes the correspondences.
            # Valid points lie inside the grid, so the grid bounding sphere
            # is the rotation lever.
            lever = (
                sum(s * s for s in geom.shift) ** 0.5
                + 0.867 * max(geom.dims) * geom.voxel_size
            )
            disp = jnp.linalg.norm(xi[:3]) + lever * jnp.linalg.norm(xi[3:])
            trust = disp < 0.25 * geom.voxel_size
            conv_now = jnp.bool_(False)
            stall_now = small | ~trust
        # converged -> keep pose (reference returns before applying the step)
        step_ok = active & trust & ~(small | fail_now)
        new_pose = jnp.where(step_ok, se3.se3_exp(-xi) @ pose, pose)
        # a stalling frozen iteration performs no reference-visible work:
        # it does not consume GN budget
        counted = active & ~stall_now
        return (
            new_pose,
            jnp.where(active, conv_now, conv),
            jnp.where(active, fail_now, fail),
            jnp.where(active, stall_now, stalled),
            jnp.where(counted, E / jnp.maximum(cnt, 1.0), E_mean),
            jnp.where(counted, cnt.astype(jnp.int32), count),
            iters + counted.astype(jnp.int32),
        )

    def round_body(carry):
        """One gather + `regather_every` frozen GN steps."""
        if records_flagged:
            rec, rflag = gather_records(carry[0])
        else:
            rec, rflag = gather_records(carry[0]), jnp.bool_(False)
        flag = carry[7] | rflag
        carry = gn_step(carry[:7], rec, fresh=True)
        for _ in range(regather_every - 1):
            carry = gn_step(carry, rec, fresh=False)
        # clear the round-local stall flag
        return carry[:3] + (jnp.bool_(False),) + carry[4:] + (flag,)

    init = (
        init_pose,
        jnp.bool_(False),   # converged
        jnp.bool_(False),   # failed
        jnp.bool_(False),   # stalled (round-local)
        jnp.float32(0.0),
        jnp.int32(0),
        jnp.int32(0),
        jnp.bool_(False),   # records flag accumulator
    )
    if early_exit:
        pose, conv, fail, _, E_mean, count, iters, flag = jax.lax.while_loop(
            lambda c: (c[6] < num_iterations) & (~c[1]) & (~c[2]),
            round_body,
            init,
        )
    else:
        # fixed-trip: ceil(num/R) rounds exhaust the budget when no round
        # stalls (always true at conv_threshold_sq=0, the static-control-flow
        # use case); with a nonzero threshold a stalled round under-consumes
        # budget and the solve finishes early at the stalled iterate.
        # fully unrolled: no per-trip exit test, so the program has static
        # control flow and pipelines freely
        n_rounds = -(-num_iterations // regather_every)
        pose, conv, fail, _, E_mean, count, iters, flag = jax.lax.fori_loop(
            0, n_rounds, lambda k, c: round_body(c), init, unroll=True
        )
    return pose, conv, fail, E_mean, count, iters, flag


@functools.partial(
    jax.jit,
    static_argnames=(
        "geom", "truncation", "zmin", "zmax", "num_iterations", "stride",
        "early_exit", "regather_every",
    ),
)
def track_frame(
    vol: GradSdfVolume,
    geom: GridGeometry,
    depth: jax.Array,     # [H,W]
    K: jax.Array,         # [3,3]
    init_pose: jax.Array, # [4,4]
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    stride: int = 1,
    early_exit: bool = True,
    regather_every: int = 1,
) -> TrackResult:
    """Full GN tracking solve for one frame (optimize_sampled, cpp:12-79).

    `early_exit=True` (default) uses a lax.while_loop with the reference's
    ||xi||^2 < eps exit (RigidPointOptimizer.cpp:68-71) — skipping unneeded
    iterations saves a full correspondence gather each.  `early_exit=False`
    runs a fixed-trip unrolled loop with masked updates (identical results) for
    contexts that need static control flow (e.g. shard_map collectives
    must execute the same collective sequence on every device).

    `regather_every=R` (frozen-correspondence GN): the per-pixel voxel
    payload gather — the dominant per-iteration cost — runs once per R
    iterations; the R-1 intermediate iterations re-linearize against the
    *frozen* nearest-voxel records (d, ghat, c_v).  Because the reference's psi(p) = d +
    ghat.(c_v - p) is itself piecewise-linear in p with pieces = nearest-
    voxel cells (VolumetricGradSdf.h:76-87), a frozen iteration is EXACT
    whenever no pixel's nearest voxel changes within the round — late GN
    steps move p by far less than a voxel, so in practice only the first
    round differs and the fixed point is the same (validated to sub-1e-4
    pose agreement on the e2e tracking tests).  R=1 reproduces the
    reference's semantics bit-exactly."""
    if stride > 1:
        # pixel sub-sampling (optimize_sampled's `sampling` knob); the
        # original pixel coordinates are reconstructed via `* stride` below.
        depth = depth[::stride, ::stride]
    H_img, W_img = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = (jnp.arange(W_img, dtype=jnp.float32) * stride)[None, :]
    rows = (jnp.arange(H_img, dtype=jnp.float32) * stride)[:, None]
    x0 = (cols - cx) / fx
    y0 = (rows - cy) / fy
    z = depth
    pts_cam = jnp.stack(
        [jnp.broadcast_to(x0, z.shape) * z, jnp.broadcast_to(y0, z.shape) * z, z], axis=-1
    ).reshape(-1, 3)
    valid_z = ((z > zmin) & (z < zmax)).reshape(-1)

    # one row-gatherable [V,8] (dist, grad, weight) table: a PackedVolume
    # already stores its float state in exactly this layout (zero-copy —
    # the streaming hot path), a GradSdfVolume pays one concat per call
    if isinstance(vol, PackedVolume):
        payload = vol.payload.reshape(-1, 8)
    else:
        payload = pack_tracking_payload(vol)

    def gather_records(pose):
        """The hot gather: per-pixel nearest-voxel records at `pose`.

        Returns (d, ghat, c_v, ok) — everything psi/J need; ok folds the
        grid-validity and w>0 gates (RigidPointOptimizer.cpp:47-50)."""
        R = pose[:3, :3]
        t = pose[:3, 3]
        p_w = pts_cam @ R.T + t
        d, ghat, c_v, w, valid = sdf_records_packed(payload, geom, p_w)
        ok = valid & (w > 0.0) & valid_z
        return d, ghat, c_v, ok

    def masked_gram(pose, rec):
        """(E, g, H, count) from frozen records + ONE 8x8 Gram matmul:
        G rows = mask * [ghat(3), p x ghat(3), psi, 1]; S = G^T G packs
        H = S[:6,:6], g = S[:6,6], E = S[6,6], count = S[7,7]."""
        d, ghat, c_v, ok = rec
        R = pose[:3, :3]
        t = pose[:3, 3]
        p_w = pts_cam @ R.T + t
        psi = d + jnp.sum(ghat * (c_v - p_w), axis=-1)
        mf = ok.astype(psi.dtype)
        G = jnp.concatenate(
            [ghat, jnp.cross(p_w, ghat), psi[:, None], jnp.ones_like(psi)[:, None]],
            axis=-1,
        ) * mf[:, None]
        S = G.T @ G
        return S[6, 6], S[:6, 6], S[:6, :6], S[7, 7]

    pose, conv, fail, E_mean, count, iters, _ = run_gn_rounds(
        geom, gather_records, masked_gram, init_pose,
        num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
        damping=damping, regather_every=regather_every, early_exit=early_exit,
    )
    return TrackResult(
        pose=pose,
        converged=conv & (~fail),
        iterations=iters,
        energy=E_mean,
        num_valid=count,
    )


@functools.partial(jax.jit, static_argnames=("geom", "truncation"))
def energy(
    vol: GradSdfVolume,
    geom: GridGeometry,
    depth: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    *,
    truncation: float,
) -> jax.Array:
    """0.5 * sum psi^2 over valid pixels at a *given* pose
    (RigidPointOptimizer.cpp:81-124; note it inverts the pose convention)."""
    Himg, Wimg = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = jnp.arange(Wimg, dtype=jnp.float32)[None, :]
    rows = jnp.arange(Himg, dtype=jnp.float32)[:, None]
    pts_cam = jnp.stack(
        [((cols - cx) / fx) * depth, ((rows - cy) / fy) * depth, depth], axis=-1
    ).reshape(-1, 3)
    valid_z = (depth > 0.0).reshape(-1)
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_w = (pts_cam - t) @ R  # R^T (p - t)
    psi, _, w, valid = sdf_query(vol, geom, p_w, truncation)
    m = (valid_z & (w > 0.0) & valid).astype(psi.dtype)
    return 0.5 * jnp.sum(psi * psi * m)
