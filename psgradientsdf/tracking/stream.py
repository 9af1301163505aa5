"""Chunked frame-stream executor: pipelined async dispatch of track -> fuse.

The reference processes frames one at a time from a host loop
(cpp/voxel_ps/src/main_ps.cpp:162-277).  On an accelerator, host<->device
round trips can dwarf the per-frame compute, so the executor's job is to
keep the dispatch queue full and the device free of data-dependent control
flow:

  * ONE batched preprocessing dispatch per chunk computes FALS normals
    (NormalEstimator.h:150-176) and the LAPM sharpness measure
    (SharpDetector.h:22-37) for all C frames;
  * C chained dispatches of ONE static-control-flow executable
    (`_chunk_step`) run the fixed-trip masked GN tracking solve
    (RigidPointOptimizer.cpp:27-76) seeded from the previous frame's pose
    and a GATED fusion (VolumetricGradSdf.cpp:51-138) that is a masked
    no-op unless tracking converged (main_ps.cpp:239-243) — or fuses at
    the given GT pose in GT mode (main_ps.cpp:216-220);
  * results come back in ONE device->host fence per chunk.

Fusion gating is jnp.where-masked rather than lax.cond (both branches of a
cond would be cheap here anyway, and masking keeps one static program);
the GN solve keeps the reference's early exit (skipping unneeded GN
iterations saves a full correspondence gather each).  Ragged chunk tails are padded and masked via
`valid` (padding frames leave the volume and pose untouched), so every
chunk reuses the same compiled executables.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import (
    GradSdfVolume,
    fuse_frame,
    fuse_frame_culled,
)
from psgradientsdf.ops.normals import FalsCache, compute_normals
from psgradientsdf.ops.sharpness import modified_laplacian
from psgradientsdf.tracking.tracker import track_frame


class ChunkResult(NamedTuple):
    poses: jax.Array       # [C,4,4] pose after each frame (tracked or GT)
    converged: jax.Array   # [C] bool — tracking converged (True in GT mode)
    fused: jax.Array       # [C] bool — frame was fused into the volume
    iterations: jax.Array  # [C] int32 GN iterations to convergence (0 in GT mode)
    energy: jax.Array      # [C] mean psi^2 at the last tracked iterate
    num_valid: jax.Array   # [C] int32 pixels in the last GN solve
    sharpness: jax.Array   # [C] LAPM focus measure of the color image
    fuse_overflow: jax.Array  # [C] bool — row-culled fusion hit capacity;
                              # the frame's update is incomplete and the
                              # caller must redo the chunk (pipeline keeps
                              # the pre-chunk volume)


def _to_metric(depths: jax.Array, colors: jax.Array, depth_unit: float):
    """On-device raw->metric conversion: uint8 RGB -> [0,1] f32, integer
    depth -> meters.  Float inputs pass through untouched (depth_unit must
    be 1.0 then).  Identical arithmetic to the host loaders' conversions."""
    if colors.dtype == jnp.uint8:
        colors = colors.astype(jnp.float32) / 255.0
    if not jnp.issubdtype(depths.dtype, jnp.floating):
        depths = depths.astype(jnp.float32) * np.float32(depth_unit)
    return depths, colors


@functools.partial(jax.jit, static_argnames=("window", "depth_unit"))
def _preprocess(depths: jax.Array, colors: jax.Array, fals: FalsCache,
                *, window: int, depth_unit: float = 1.0):
    depths, colors = _to_metric(depths, colors, depth_unit)
    normals = jax.vmap(lambda d: compute_normals(d, fals, window=window))(depths)
    sharp = jax.vmap(modified_laplacian)(colors)
    return normals, sharp


@functools.partial(
    jax.jit,
    static_argnames=(
        "geom", "truncation", "zmin", "zmax", "num_iterations", "stride",
        "use_gt", "depth_unit", "regather_every", "early_exit", "mesh",
        "fuse_row_capacity", "interleave_z",
    ),
)
def _chunk_step(
    vol: GradSdfVolume,
    pose: jax.Array,       # [4,4] carried pose estimate
    color: jax.Array,      # [H,W,3]
    depth: jax.Array,      # [H,W]
    n_img: jax.Array,      # [H,W,3] FALS normals
    n_sq_inv: jax.Array,   # [H,W]
    K: jax.Array,          # [3,3]
    fid: jax.Array,        # scalar int32 visibility bit
    ok: jax.Array,         # scalar bool — False for padding frames
    gtp: jax.Array,        # [4,4] GT pose (ignored unless use_gt)
    *,
    geom: GridGeometry,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int,
    conv_threshold_sq: float,
    damping: float,
    stride: int,
    use_gt: bool,
    depth_unit: float = 1.0,
    regather_every: int = 1,
    early_exit: bool = True,
    mesh=None,
    fuse_row_capacity: int = 0,
    interleave_z: bool = False,
):
    """One frame: masked GN track + gated fuse, all static control flow.

    With `mesh` set (a jax.sharding.Mesh with a "z" axis), tracking runs as
    the shard_map/psum GN solver over Z-slab volume shards and the fused
    volume's Z-slab sharding is pinned with with_sharding_constraint — the
    multi-chip product path (SURVEY §5.7-5.8)."""
    depth, color = _to_metric(depth, color, depth_unit)
    if use_gt:
        new_pose = gtp
        conv = ok
        iters = jnp.int32(0)
        energy = jnp.float32(0.0)
        nvalid = jnp.int32(0)
    else:
        if mesh is not None:
            from psgradientsdf.parallel.shard import sharded_tracker_fn

            if stride > 1:
                depth_t = depth[::stride, ::stride]
            else:
                depth_t = depth
            track = sharded_tracker_fn(
                mesh, geom, depth_t.shape,
                truncation=truncation, zmin=zmin, zmax=zmax,
                num_iterations=num_iterations,
                conv_threshold_sq=conv_threshold_sq, damping=damping,
                regather_every=regather_every, early_exit=False,
                stride=stride, interleave_z=interleave_z,
            )
            res = track(vol, depth_t, K, pose)
        else:
            res = track_frame(
                vol, geom, depth, K, pose,
                truncation=truncation, zmin=zmin, zmax=zmax,
                num_iterations=num_iterations,
                conv_threshold_sq=conv_threshold_sq,
                damping=damping, stride=stride, regather_every=regather_every,
                early_exit=early_exit,
            )
        new_pose = jnp.where(ok, res.pose, pose)
        conv = res.converged & ok
        iters, energy, nvalid = res.iterations, res.energy, res.num_valid

    do_fuse = conv if not use_gt else ok
    if fuse_row_capacity > 0 and mesh is None:
        # row-culled fusion (exact-superset cull, core/volume.py) — the
        # gather index count drops from Z*Y*X to row_capacity*X
        vol, overflow = fuse_frame_culled(
            vol, geom, color, depth, n_img, n_sq_inv, K, new_pose, fid,
            do_fuse, truncation=truncation, zmin=zmin, zmax=zmax,
            row_capacity=fuse_row_capacity,
        )
    elif fuse_row_capacity > 0:
        # mesh mode: per-slab cull under shard_map (capacity split across
        # the Z shards; parallel/shard.py)
        from psgradientsdf.parallel.mesh import Z_AXIS
        from psgradientsdf.parallel.shard import (
            sharded_fuse_frame_culled_fn,
        )

        cap_shard = -(-fuse_row_capacity // mesh.shape[Z_AXIS])
        fuse_sh = sharded_fuse_frame_culled_fn(
            mesh, geom, truncation=truncation, zmin=zmin, zmax=zmax,
            row_capacity=cap_shard, interleave_z=interleave_z,
        )
        vol, overflow = fuse_sh(
            vol, color, depth, n_img, n_sq_inv, K, new_pose, fid, do_fuse)
    else:
        vol = fuse_frame(
            vol, geom, color, depth, n_img, n_sq_inv, K, new_pose, fid, do_fuse,
            truncation=truncation, zmin=zmin, zmax=zmax,
        )
        overflow = jnp.bool_(False)
    if mesh is not None:
        from jax.sharding import NamedSharding
        from psgradientsdf.parallel.mesh import volume_specs

        vol = jax.lax.with_sharding_constraint(
            vol, GradSdfVolume(*(NamedSharding(mesh, s)
                                 for s in volume_specs())))
    # non-converged tracking still advances the pose estimate
    # (the reference's pose_ member retains the last GN iterate)
    pose_out = jnp.where(ok, new_pose, pose)
    return vol, pose_out, conv, do_fuse, iters, energy, nvalid, overflow


def process_chunk(
    vol: GradSdfVolume,
    geom: GridGeometry,
    colors: jax.Array,      # [C,H,W,3]
    depths: jax.Array,      # [C,H,W]
    K: jax.Array,           # [3,3]
    init_pose: jax.Array,   # [4,4] tracking seed (pose after previous chunk)
    frame_ids: jax.Array,   # [C] int32 visibility bit per frame
    valid: jax.Array,       # [C] bool — False for ragged-tail padding
    gt_poses: jax.Array,    # [C,4,4] (ignored unless use_gt)
    fals: FalsCache,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    stride: int = 1,
    window: int = 11,
    use_gt: bool = False,
    depth_unit: float = 1.0,
    regather_every: int = 1,
    early_exit: bool = True,
    mesh=None,
    fuse_row_capacity: int = 0,
    interleave_z: bool = False,
) -> Tuple[GradSdfVolume, ChunkResult]:
    """Track + fuse a chunk of frames with pipelined dispatch.

    Host Python drives the chain, but nothing synchronizes until the caller
    reads the results: every dispatched program is while/cond-free, so the
    device works through the queue back-to-back.
    """
    C = int(colors.shape[0])
    colors = jnp.asarray(colors)    # may be uint8 (raw wire format)
    depths = jnp.asarray(depths)    # may be uint16
    normals, sharp = _preprocess(depths, colors, fals, window=window,
                                 depth_unit=depth_unit)

    step = functools.partial(
        _chunk_step,
        geom=geom, truncation=truncation, zmin=zmin, zmax=zmax,
        num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
        damping=damping, stride=stride, use_gt=use_gt, depth_unit=depth_unit,
        regather_every=regather_every, early_exit=early_exit, mesh=mesh,
        fuse_row_capacity=fuse_row_capacity, interleave_z=interleave_z,
    )
    pose = init_pose
    outs = []
    for j in range(C):
        vol, pose, conv, fused, iters, energy, nvalid, overflow = step(
            vol, pose, colors[j], depths[j], normals[j], fals.n_sq_inv, K,
            frame_ids[j], valid[j], gt_poses[j],
        )
        outs.append((pose, conv, fused, iters, energy, nvalid, overflow))

    poses, conv, fused, iters, energy, nvalid, overflow = (
        jnp.stack([o[k] for o in outs]) for k in range(7)
    )
    return vol, ChunkResult(
        poses=poses, converged=conv, fused=fused, iterations=iters,
        energy=energy, num_valid=nvalid, sharpness=sharp,
        fuse_overflow=overflow,
    )
