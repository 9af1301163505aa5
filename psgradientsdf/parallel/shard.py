"""Sharded execution paths: multi-chip fusion, tracking, and refinement.

Three parallelization idioms, each used where it fits (SURVEY §5.7-5.8):

  1. GSPMD auto-partitioning (fusion, refinement blocks): annotate input
     shardings (Z-slabs for the volume / compacted surface arrays, optional
     keyframe sharding for images) and jit — XLA inserts the collectives.
     Fusion is purely voxel-local so it lowers to zero communication.
  2. Explicit shard_map + psum (tracking): the per-pixel Gradient-SDF
     gather is data-dependent, so each shard gathers only the points that
     land in its Z-slab (masked local gather) and the 6x6 GN normal
     equations reduce with a single psum per iteration — the reference's
     serial pixel loop (RigidPointOptimizer.cpp:38-60) was "literally a
     psum" (SURVEY §5.8).
  3. shard_map + ppermute halos (dense stencils): 1-voxel Z halos for
     finite differences, see halo.py.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import GradSdfVolume, fuse_frame
from psgradientsdf.parallel.halo import padded_slab
from psgradientsdf.parallel.mesh import FRAME_AXIS, Z_AXIS, volume_specs
from psgradientsdf.tracking.tracker import TrackResult, run_gn_rounds
from psgradientsdf.utils import se3


# ------------------------------------------------------------ fusion (GSPMD)

def sharded_fuse_frame(mesh: Mesh, geom: GridGeometry, **static_kwargs):
    """Returns a jitted fusion step with Z-slab output shardings pinned.

    Voxel-local computation: under GSPMD this partitions with no
    communication (each slab gathers from the replicated image maps)."""
    specs = volume_specs()
    out_shardings = GradSdfVolume(
        *(NamedSharding(mesh, s) for s in specs)
    )

    @functools.partial(jax.jit, out_shardings=out_shardings)
    def step(vol, color, depth, normals, n_sq_inv, K, pose, frame_idx):
        return fuse_frame(
            vol, geom, color, depth, normals, n_sq_inv, K, pose, frame_idx,
            **static_kwargs,
        )

    return step


def sharded_fuse_frame_culled_fn(
    mesh: Mesh,
    geom: GridGeometry,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    row_capacity: int,
    interleave_z: bool = False,
):
    """Per-slab row-culled fusion under shard_map (traceable; compose inside
    jitted programs).  Each Z-slab runs the level-1 cull on its own rows
    (core/volume._row_activity with the slab offset) and the shared level-2
    compact/gather/update/scatter — all slab-local, zero communication
    except ONE psum of the overflow flag.  `row_capacity` is PER SHARD.

    interleave_z=True assigns shard k the STRIDED global planes
    {k, k+n_z, k+2*n_z, ...} instead of a contiguous slab (the volume must
    be stored in the interleaved layout — parallel/mesh.interleave_volume).
    Fusion is purely per-voxel, so any plane assignment is valid with the
    same zero communication; striding balances the per-chip active-row
    counts on frustum scenes where contiguous slabs are up to ~7x skewed
    (tests/test_scaling_model.py checks both) — the camera frustum
    concentrates in a few contiguous Z-slabs but touches every residue
    class nearly equally.

    Returns fn(vol, color, depth, normals, n_sq_inv, K, pose, frame_idx,
    gate=None) -> (vol, overflowed)."""
    from psgradientsdf.core.volume import (
        _fuse_culled_slab, _row_activity, pack_pixel_payload,
    )

    Zg = geom.shape_zyx[0]
    n_z = mesh.shape[Z_AXIS]
    assert Zg % n_z == 0, f"grid Z={Zg} not divisible by mesh z={n_z}"
    Zl = Zg // n_z
    v_specs = volume_specs()
    in_specs = (v_specs, P(), P(), P(), P(), P(), P(), P(), P())
    out_specs = (v_specs, P())

    def body(vol_slab, color, depth, normals, n_sq_inv, K, pose, frame_idx,
             gate):
        k = jax.lax.axis_index(Z_AXIS)
        if interleave_z:
            z_idx = k + n_z * jnp.arange(Zl, dtype=jnp.int32)
            z0, z_map = None, z_idx
            active = _row_activity(
                geom, depth, K, pose, truncation=truncation, zmin=zmin,
                zmax=zmax, z_rows=Zl, z_idx=z_idx)
        else:
            z0, z_map = k * Zl, None
            active = _row_activity(
                geom, depth, K, pose, truncation=truncation, zmin=zmin,
                zmax=zmax, z0=z0, z_rows=Zl)
        gate_s = gate[0]
        active = active & gate_s
        pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)
        new_slab, overflow = _fuse_culled_slab(
            vol_slab, geom, z0, Zl, active, pix_payload, K, pose,
            depth.shape, frame_idx, gate_s,
            truncation=truncation, zmin=zmin, zmax=zmax,
            cos_thresh_sq=cos_thresh_sq, row_capacity=row_capacity,
            z_map=z_map,
        )
        ov = jax.lax.psum(overflow.astype(jnp.int32), Z_AXIS) > 0
        return new_slab, ov

    mapped = shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs)

    def fuse(vol, color, depth, normals, n_sq_inv, K, pose, frame_idx,
             gate=None):
        if gate is None:
            gate = jnp.bool_(True)
        return mapped(vol, color, depth, normals, n_sq_inv, K, pose,
                      frame_idx, gate[None])

    return fuse


# ---------------------------------------------------------- tracking (psum)

def sharded_tracker_fn(
    mesh: Mesh,
    geom: GridGeometry,
    img_shape: Tuple[int, int],
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    regather_every: int = 1,
    early_exit: bool = False,
    stride: int = 1,
    interleave_z: bool = False,
):
    """The shard_map'd multi-chip GN tracker over Z-slab volume shards —
    traceable, so it composes inside larger jitted programs (the stream
    executor's chunk step); make_sharded_tracker wraps it in its own jit.

    Per GN iteration each shard computes (E, g, H, count) from the pixels
    whose world points fall inside its slab, then one psum over the "z"
    axis reassembles the global normal equations; the 6x6 solve and pose
    update run replicated.  Single collective per iteration, of
    4*(1+6+36+1) floats.

    Control flow and step semantics are SHARED with the single-device
    tracker (tracking/tracker.run_gn_rounds): `early_exit=False` (default)
    emits a fixed-trip unrolled program — a static program keeps the
    collective sequence identical on every device and needs no per-trip
    exit test.  `regather_every=R` runs the hot slab gather once per R
    iterations against frozen nearest-voxel records (see track_frame).
    """
    Zg = geom.shape_zyx[0]
    n_z = mesh.shape[Z_AXIS]
    assert Zg % n_z == 0, f"grid Z={Zg} not divisible by mesh z={n_z}"
    Zl = Zg // n_z
    H, W = img_shape

    v_specs = volume_specs()
    in_specs = (v_specs, P(), P(), P())
    out_specs = (P(), P(), P(), P(), P())

    def tracker_body(vol_slab: GradSdfVolume, depth, K, init_pose):
        shard_k = jax.lax.axis_index(Z_AXIS)
        z0 = shard_k * Zl
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        # `depth` arrives pre-subsampled when stride > 1; reconstruct the
        # original pixel coordinates (track_frame's optimize_sampled knob)
        cols = (jnp.arange(W, dtype=jnp.float32) * stride)[None, :]
        rows = (jnp.arange(H, dtype=jnp.float32) * stride)[:, None]
        x0 = (cols - cx) / fx
        y0 = (rows - cy) / fy
        pts_cam = jnp.stack(
            [jnp.broadcast_to(x0, depth.shape) * depth,
             jnp.broadcast_to(y0, depth.shape) * depth, depth], axis=-1
        ).reshape(-1, 3)
        valid_z = ((depth > zmin) & (depth < zmax)).reshape(-1)

        dims_f = jnp.array(geom.dims, dtype=jnp.float32)

        # packed slab payload: one row-gather per pixel (see
        # core/volume.pack_tracking_payload)
        payload = jnp.concatenate(
            [
                vol_slab.dist[..., None],
                vol_slab.grad,
                vol_slab.weight[..., None],
                jnp.zeros(vol_slab.dist.shape + (3,), vol_slab.dist.dtype),
            ],
            axis=-1,
        ).reshape(-1, 8)
        X, Y = geom.dims[0], geom.dims[1]

        def gather_records(pose):
            """Frozen-correspondence gather, slab-local: each shard fetches
            records only for the pixels whose nearest voxel lies in its
            Z-slab (`in_slab` folds into ok; other shards contribute zero
            rows to the Gram psum)."""
            R = pose[:3, :3]
            t = pose[:3, 3]
            p_w = pts_cam @ R.T + t
            f = geom.world2voxelf(p_w)
            valid = jnp.all((f > 0.0) & (f < dims_f - 1.0), axis=-1)
            idx = jnp.floor(f + 0.5).astype(jnp.int32)
            zi = idx[..., 2]
            if interleave_z:
                # strided plane assignment (see sharded_fuse_frame_culled_fn)
                in_slab = (zi % n_z) == shard_k
                zl = jnp.clip(zi // n_z, 0, Zl - 1)
            else:
                in_slab = (zi >= z0) & (zi < z0 + Zl)
                zl = jnp.clip(zi - z0, 0, Zl - 1)
            yi = jnp.clip(idx[..., 1], 0, Y - 1)
            xi = jnp.clip(idx[..., 0], 0, X - 1)
            rows = jnp.take(payload, (zl * Y + yi) * X + xi, axis=0)
            d = rows[..., 0]
            g3 = rows[..., 1:4]
            w = rows[..., 4]
            gnorm = jnp.linalg.norm(g3, axis=-1, keepdims=True)
            ghat = g3 / jnp.maximum(gnorm, 1e-12)
            c_v = geom.voxel2world(idx)
            ok = valid & in_slab & (w > 0.0) & valid_z
            return d, ghat, c_v, ok

        def masked_gram(pose, rec):
            """Local Gram + ONE psum — same op order as the single-device
            tracker's masked_gram, with the reduction split shard-then-psum."""
            d, ghat, c_v, ok = rec
            R = pose[:3, :3]
            t = pose[:3, 3]
            p_w = pts_cam @ R.T + t
            psi = d + jnp.sum(ghat * (c_v - p_w), axis=-1)
            mf = ok.astype(psi.dtype)
            G = jnp.concatenate(
                [ghat, jnp.cross(p_w, ghat), psi[:, None],
                 jnp.ones_like(psi)[:, None]],
                axis=-1,
            ) * mf[:, None]
            S = G.T @ G
            # the one collective of the iteration
            S = jax.lax.psum(S, Z_AXIS)
            return S[6, 6], S[:6, 6], S[:6, :6], S[7, 7]

        pose, conv, fail, E_mean, cnt, iters, _ = run_gn_rounds(
            geom, gather_records, masked_gram, init_pose,
            num_iterations=num_iterations,
            conv_threshold_sq=conv_threshold_sq, damping=damping,
            regather_every=regather_every, early_exit=early_exit,
        )
        return pose, conv & (~fail), iters, E_mean, cnt

    mapped = shard_map(
        tracker_body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
    )

    def track(vol, depth, K, init_pose) -> TrackResult:
        pose, conv, k, E, cnt = mapped(vol, depth, K, init_pose)
        return TrackResult(pose=pose, converged=conv, iterations=k,
                           energy=E, num_valid=cnt)

    return track


def make_sharded_tracker(mesh: Mesh, geom: GridGeometry,
                         img_shape: Tuple[int, int], **hyp):
    """Jitted standalone wrapper of sharded_tracker_fn (see its docstring)."""
    return jax.jit(sharded_tracker_fn(mesh, geom, img_shape, **hyp))


# ------------------------------------------------- dense stencils (halos)

def make_sharded_eikonal_energy(mesh: Mesh, geom: GridGeometry, voxel_size: float,
                                band: float):
    """Mean (||forward-diff grad d|| - 1)^2 over the surface band of a
    Z-slab-sharded dense grid, with ppermute halo exchange for the z+1 term.

    The representative dense-stencil collective pattern: every FD/Laplacian
    op on the sharded grid uses the same halo."""
    n_z = mesh.shape[Z_AXIS]
    Zg = geom.shape_zyx[0]
    assert Zg % n_z == 0
    inv_h = 1.0 / voxel_size

    def body(dist_slab):
        padded = padded_slab(dist_slab, Z_AXIS, fill=0.0)  # [Zl+2, Y, X]
        d = dist_slab
        dz = (padded[2:] - d) * inv_h                      # uses halo above
        dy = (jnp.roll(d, -1, axis=1) - d) * inv_h
        dx = (jnp.roll(d, -1, axis=2) - d) * inv_h
        g = jnp.stack([dx, dy, dz], axis=-1)
        in_band = jnp.abs(d) <= band
        e = (jnp.linalg.norm(g, axis=-1) - 1.0) ** 2
        num = jnp.sum(jnp.where(in_band, e, 0.0))
        cnt = jnp.sum(in_band)
        num, cnt = jax.lax.psum((num, cnt), Z_AXIS)
        return num / jnp.maximum(cnt.astype(num.dtype), 1.0)

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(Z_AXIS, None, None),), out_specs=P(),
    )
    return jax.jit(mapped)


# ------------------------------------------------- refinement (GSPMD)

def shard_refine_arrays(mesh: Mesh, prob, images):
    """Place a RefineProblem + keyframe images on the mesh: surface-voxel
    axis N sharded over "z", images sharded over "frames" when divisible.

    The refinement blocks then run under plain jit: GSPMD inserts the
    psums (voxel reductions for pose/light) and all-gathers (frame
    reductions against N-sharded residuals) automatically."""
    n_z = mesh.shape[Z_AXIS]
    n_f = mesh.shape[FRAME_AXIS]

    def put(arr, spec):
        return jax.device_put(arr, NamedSharding(mesh, spec))

    def n_spec(a):
        if a.ndim == 0 or a.shape[0] % n_z != 0:
            return P()
        return P(Z_AXIS, *([None] * (a.ndim - 1)))

    prob_sharded = type(prob)(*(put(a, n_spec(a)) for a in prob))
    if images.shape[0] % n_f == 0 and n_f > 1:
        img_spec = P(FRAME_AXIS, None, None, None)
    else:
        img_spec = P()
    return prob_sharded, put(images, img_spec)
