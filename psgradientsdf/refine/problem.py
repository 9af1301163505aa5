"""Refinement problem extraction: surface compaction + stencil structure.

Replaces the reference's dynamic `surface_points_` index vector and its
O(N) `std::find` neighbor lookups (cpp/include/ps_optimizer/Optimizer.cpp:
462-474, PsOptimizerJa.cpp:523-541) with precomputed, statically-shaped
index arrays:

  * surface voxels are compacted to a padded capacity N (power-of-two
    bucket) so every per-voxel loop is a dense masked kernel;
  * the one-sided finite-difference direction per axis (forward iff the
    +1 neighbor is inside the grid AND in the surface set — the
    `ifValidDirection` rule, Optimizer.cpp:287-364) is fixed for the
    whole refinement, since surface membership doesn't change between
    upsamplings;
  * each stencil neighbor is either another surface voxel (compact index
    >= 0 — its distance/albedo is a *variable*) or a non-surface voxel
    (compact index -1 — its values are frozen at extraction and stored
    as constants, exactly like the reference which reads them from the
    full grid but never assigns them Jacobian columns).

Extraction runs ON DEVICE (masked compaction + stencil index arithmetic are
pure gather/nonzero work — round-2 VERDICT #5): one tiny jitted program
counts the surface set (the only D2H sync, to pick the padded capacity on
host), then one jitted program builds every problem array.  The original
numpy path survives as extract_problem_host — the parity oracle
(tests/test_problem_device.py asserts bit-identical results).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import GradSdfVolume


class RefineProblem(NamedTuple):
    # --- compacted surface voxels (length N, padded) ---
    valid: jax.Array        # [N] bool padding mask
    idx_xyz: jax.Array      # [N,3] int32 voxel coords (x,y,z)
    dist: jax.Array         # [N] f32
    albedo: jax.Array       # [N,3] f32
    grad_stored: jax.Array  # [N,3] f32 — the volume's stored gradient (v.grad)
    vis: jax.Array          # [N,F] bool — visibility re-indexed to keyframes
    # --- one-sided FD stencil (dist & albedo share it) ---
    nbr_dir: jax.Array      # [N,3] f32 in {+1,-1}
    nbr_idx: jax.Array      # [N,3] int32 compact index of FD neighbor, -1 if frozen
    nbr_dist_const: jax.Array    # [N,3] f32 frozen neighbor distances
    nbr_albedo_const: jax.Array  # [N,3,3] f32 frozen neighbor albedo [axis, channel]
    # --- Laplacian stencil (+1/-1 per axis) ---
    lap_idx: jax.Array      # [N,6] int32 compact index (x+,x-,y+,y-,z+,z-), -1 if frozen
    lap_dist_const: jax.Array    # [N,6] f32 frozen values
    n_surface: jax.Array    # scalar int32 — true (unpadded) surface count


def _pad_cap(n: int, minimum: int = 1024) -> int:
    """Padded capacity: next power of two, or 1.5x a power of two when that
    suffices — pure pow2 rounding wastes up to 2x memory on the [N,F,...]
    residual tensors, which matters after the 8x upsample (e.g. 329k surface
    voxels -> 393k instead of 524k)."""
    cap = minimum
    while cap < n:
        if n <= cap * 3 // 2:
            return cap * 3 // 2
        cap *= 2
    return cap


def _kf_bit_arrays(keyframe_indices: Sequence[int], n_words: int):
    """Host-side bit bookkeeping for select_vis: per-keyframe (word, bit)
    plus the per-word OR-mask of all keyframe bits (for the `seen` test).

    Frame counters beyond the volume's visibility capacity alias the LAST
    bit — the same rule the fusion side applies (pipeline._vis_frame_id),
    so an overflowed keyframe's visibility is read from exactly the slot
    its fusion wrote."""
    kf = np.minimum(np.asarray(keyframe_indices, dtype=np.int64),
                    n_words * 32 - 1)
    words = (kf // 32).astype(np.int32)
    bits = (np.uint32(1) << (kf % 32).astype(np.uint32)).astype(np.uint32)
    word_masks = np.zeros(n_words, dtype=np.uint32)
    for w, b in zip(words, bits):
        word_masks[w] |= b
    return words, bits, word_masks


@functools.partial(jax.jit, static_argnames=("voxel_size",))
def _surface_count(dist, vis, word_masks, *, voxel_size):
    """Unpadded surface-set size: |d| <= sqrt(3) h AND seen in >= 1 keyframe
    (OptimizerAux.cpp:237-257 + the select_vis keyframe re-indexing)."""
    band = jnp.abs(dist) <= jnp.sqrt(jnp.float32(3.0)) * voxel_size
    seen = jnp.any(
        (vis & word_masks[:, None, None, None]) != 0, axis=0)
    return jnp.sum(band & seen)


@functools.partial(
    jax.jit, static_argnames=("dims", "voxel_size", "capacity"))
def _extract_device(dist3, grad3, color3, vis4, kf_words, kf_bits, word_masks,
                    *, dims, voxel_size, capacity):
    """The whole problem build as one device program (static capacity).

    Matches extract_problem_host bit-for-bit: same nonzero (ascending ==
    z-major iteration) order, same border clipping on frozen-neighbor
    reads, same padded-row fill values."""
    X, Y, Z = dims
    V = X * Y * Z
    dist = dist3.reshape(-1)
    color = color3.reshape(-1, 3)
    grad = grad3.reshape(-1, 3)

    band = jnp.abs(dist) <= jnp.sqrt(jnp.float32(3.0)) * voxel_size
    seen = jnp.any(
        (vis4 & word_masks[:, None, None, None]) != 0, axis=0).reshape(-1)
    surf = band & seen
    n = jnp.sum(surf.astype(jnp.int32))

    (lin,) = jnp.nonzero(surf, size=capacity, fill_value=V)
    valid = lin < V
    safe = jnp.minimum(lin, V - 1)
    xi = (safe % X).astype(jnp.int32)
    yi = ((safe // X) % Y).astype(jnp.int32)
    zi = (safe // (X * Y)).astype(jnp.int32)

    def pad0(a):     # padded rows carry the host path's zero fill
        mask = valid.reshape((capacity,) + (1,) * (a.ndim - 1))
        return jnp.where(mask, a, jnp.zeros_like(a))

    idx_xyz = pad0(jnp.stack([xi, yi, zi], axis=-1))
    d_out = pad0(jnp.take(dist, safe))
    alb = pad0(jnp.take(color, safe, axis=0))
    g_out = pad0(jnp.take(grad, safe, axis=0))

    # vis re-indexed to keyframes: gather each voxel's words, then pick the
    # per-keyframe word and test its bit
    vis_nw = jnp.take(vis4.reshape(vis4.shape[0], V), safe, axis=1)  # [Wv,N]
    vis_sel = jnp.take(vis_nw, kf_words, axis=0)                     # [F,N]
    vis_out = ((vis_sel & kf_bits[:, None]) != 0).T & valid[:, None]

    # compact map: -1 everywhere, compact index at surface voxels
    cmap = jnp.full((V,), -1, dtype=jnp.int32).at[lin].set(
        jnp.arange(capacity, dtype=jnp.int32), mode="drop")

    base = jnp.stack([xi, yi, zi], axis=-1)                          # [N,3]
    dims_v = jnp.array([X, Y, Z], dtype=jnp.int32)

    def flat_idx(coords):
        return (coords[:, 2] * Y + coords[:, 1]) * X + coords[:, 0]

    nbr_dirs, nbr_idxs, nbr_dcs, nbr_acs = [], [], [], []
    for ax in range(3):
        step = jnp.zeros((3,), jnp.int32).at[ax].set(1)
        fwd = base + step
        in_b = fwd[:, ax] < dims_v[ax]
        fwd_c = jnp.clip(fwd, 0, dims_v - 1)
        fwd_compact = jnp.take(cmap, flat_idx(fwd_c))
        use_fwd = in_b & (fwd_compact >= 0)
        dirs = jnp.where(use_fwd, 1.0, -1.0).astype(jnp.float32)
        nbr = jnp.clip(base + step * dirs.astype(jnp.int32)[:, None],
                       0, dims_v - 1)  # border guard (§2.3 bug 3)
        nl = flat_idx(nbr)
        ci = jnp.take(cmap, nl)
        frozen = ci < 0
        nbr_dirs.append(jnp.where(valid, dirs, 1.0))
        nbr_idxs.append(jnp.where(valid, ci, -1))
        nbr_dcs.append(pad0(jnp.where(frozen, jnp.take(dist, nl), 0.0)))
        nbr_acs.append(pad0(jnp.where(frozen[:, None],
                                      jnp.take(color, nl, axis=0), 0.0)))
    nbr_dir = jnp.stack(nbr_dirs, axis=-1)
    nbr_idx = jnp.stack(nbr_idxs, axis=-1)
    nbr_dc = jnp.stack(nbr_dcs, axis=-1)
    nbr_ac = jnp.stack(nbr_acs, axis=1)          # [N, axis, channel]

    lap_idxs, lap_dcs = [], []
    for ax in range(3):
        for sign in (+1, -1):
            step = jnp.zeros((3,), jnp.int32).at[ax].set(sign)
            nbr = jnp.clip(base + step, 0, dims_v - 1)
            nl = flat_idx(nbr)
            ci = jnp.take(cmap, nl)
            lap_idxs.append(jnp.where(valid, ci, -1))
            lap_dcs.append(pad0(jnp.where(ci < 0, jnp.take(dist, nl), 0.0)))
    lap_idx = jnp.stack(lap_idxs, axis=-1)
    lap_dc = jnp.stack(lap_dcs, axis=-1)

    return RefineProblem(
        valid=valid, idx_xyz=idx_xyz, dist=d_out, albedo=alb,
        grad_stored=g_out, vis=vis_out, nbr_dir=nbr_dir, nbr_idx=nbr_idx,
        nbr_dist_const=nbr_dc, nbr_albedo_const=nbr_ac, lap_idx=lap_idx,
        lap_dist_const=lap_dc, n_surface=n.astype(jnp.int32),
    )


def extract_problem(
    vol: GradSdfVolume,
    geom: GridGeometry,
    keyframe_indices: Sequence[int],
    capacity: int = None,
) -> RefineProblem:
    """select_vis + getSurfaceVoxel + stencil precomputation, on device.

    `keyframe_indices` are frame counters (bit positions in vol.vis),
    mirroring Optimizer::select_vis (Optimizer.cpp:30-47).  The only host
    sync is the surface count (capacity bucketing); the problem arrays are
    built by one jitted program and never leave the device.
    """
    Z, Y, X = vol.dist.shape
    kf_words, kf_bits, word_masks = _kf_bit_arrays(
        keyframe_indices, vol.vis.shape[0])
    if capacity is None:
        n = int(_surface_count(vol.dist, vol.vis, jnp.asarray(word_masks),
                               voxel_size=geom.voxel_size))
        capacity = _pad_cap(n)
    prob = _extract_device(
        vol.dist, vol.grad, vol.color, vol.vis, jnp.asarray(kf_words),
        jnp.asarray(kf_bits), jnp.asarray(word_masks),
        dims=(X, Y, Z), voxel_size=geom.voxel_size, capacity=capacity,
    )
    n = int(prob.n_surface)
    if n > capacity:
        raise ValueError(f"surface count {n} exceeds capacity {capacity}")
    return prob


def extract_problem_host(
    vol: GradSdfVolume,
    geom: GridGeometry,
    keyframe_indices: Sequence[int],
    capacity: int = None,
) -> RefineProblem:
    """Host (numpy) reference implementation of extract_problem — kept as
    the parity oracle for the device path (and for environments where the
    volume is already host-resident)."""
    dist = np.asarray(vol.dist)
    grad = np.asarray(vol.grad)
    color = np.asarray(vol.color)
    vis_packed = np.asarray(vol.vis)
    Z, Y, X = dist.shape
    h = geom.voxel_size

    F = len(keyframe_indices)
    kvis = np.zeros((Z, Y, X, F), dtype=bool)
    for f, frame in enumerate(keyframe_indices):
        word, bit = frame // 32, frame % 32
        kvis[..., f] = (vis_packed[word] & np.uint32(1 << bit)) != 0

    band = np.abs(dist) <= np.sqrt(3.0) * h
    seen = kvis.any(axis=-1)
    surf = band & seen
    zz, yy, xx = np.nonzero(surf)      # i-fastest order == reference iteration order
    n = zz.size
    if capacity is None:
        capacity = _pad_cap(n)
    if n > capacity:
        raise ValueError(f"surface count {n} exceeds capacity {capacity}")

    # compact map
    cmap = np.full((Z, Y, X), -1, dtype=np.int32)
    cmap[zz, yy, xx] = np.arange(n, dtype=np.int32)

    def padded(shape_tail=(), dtype=np.float32, fill=0):
        return np.full((capacity,) + shape_tail, fill, dtype=dtype)

    idx_xyz = padded((3,), np.int32)
    idx_xyz[:n] = np.stack([xx, yy, zz], axis=-1)
    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = True

    d_out = padded()
    d_out[:n] = dist[zz, yy, xx]
    alb = padded((3,))
    alb[:n] = color[zz, yy, xx]
    g_out = padded((3,))
    g_out[:n] = grad[zz, yy, xx]
    vis_out = np.zeros((capacity, F), dtype=bool)
    vis_out[:n] = kvis[zz, yy, xx]

    # --- FD stencil: forward iff +1 in bounds and in surface set ---
    dims = np.array([X, Y, Z])
    nbr_dir = np.ones((capacity, 3), dtype=np.float32)
    nbr_idx = np.full((capacity, 3), -1, dtype=np.int32)
    nbr_dc = padded((3,))
    nbr_ac = padded((3, 3))
    base = np.stack([xx, yy, zz], axis=-1)  # [n,3] (x,y,z)
    for ax in range(3):
        fwd = base.copy()
        fwd[:, ax] += 1
        in_b = fwd[:, ax] < dims[ax]
        fwd_c = np.clip(fwd, 0, dims - 1)
        fwd_compact = cmap[fwd_c[:, 2], fwd_c[:, 1], fwd_c[:, 0]]
        use_fwd = in_b & (fwd_compact >= 0)
        dirs = np.where(use_fwd, 1.0, -1.0).astype(np.float32)
        nbr = base.copy()
        nbr[:, ax] += dirs.astype(np.int32)
        nbr = np.clip(nbr, 0, dims - 1)   # border guard (reference reads OOB, §2.3 bug 3)
        ci = cmap[nbr[:, 2], nbr[:, 1], nbr[:, 0]]
        nbr_dir[:n, ax] = dirs
        nbr_idx[:n, ax] = ci
        frozen = ci < 0
        nbr_dc[:n, ax] = np.where(frozen, dist[nbr[:, 2], nbr[:, 1], nbr[:, 0]], 0.0)
        nbr_ac[:n, ax] = np.where(
            frozen[:, None], color[nbr[:, 2], nbr[:, 1], nbr[:, 0]], 0.0
        )

    # --- Laplacian stencil ---
    lap_idx = np.full((capacity, 6), -1, dtype=np.int32)
    lap_dc = padded((6,))
    for ax in range(3):
        for s, sign in enumerate((+1, -1)):
            col = 2 * ax + s
            nbr = base.copy()
            nbr[:, ax] += sign
            nbr = np.clip(nbr, 0, dims - 1)
            ci = cmap[nbr[:, 2], nbr[:, 1], nbr[:, 0]]
            lap_idx[:n, col] = ci
            lap_dc[:n, col] = np.where(
                ci < 0, dist[nbr[:, 2], nbr[:, 1], nbr[:, 0]], 0.0
            )

    j = jnp.asarray
    return RefineProblem(
        valid=j(valid),
        idx_xyz=j(idx_xyz),
        dist=j(d_out),
        albedo=j(alb),
        grad_stored=j(g_out),
        vis=j(vis_out),
        nbr_dir=j(nbr_dir),
        nbr_idx=j(nbr_idx),
        nbr_dist_const=j(nbr_dc),
        nbr_albedo_const=j(nbr_ac),
        lap_idx=j(lap_idx),
        lap_dist_const=j(lap_dc),
        n_surface=jnp.int32(n),
    )


def writeback(
    vol: GradSdfVolume, prob: RefineProblem, dist: jax.Array, albedo: jax.Array,
    grad_stored: jax.Array,
) -> GradSdfVolume:
    """Scatter refined per-surface-voxel values back into the dense volume."""
    idx = prob.idx_xyz
    zi, yi, xi = idx[:, 2], idx[:, 1], idx[:, 0]
    m = prob.valid
    # mask padded rows by scattering their own current values
    cur_d = vol.dist[zi, yi, xi]
    cur_a = vol.color[zi, yi, xi]
    cur_g = vol.grad[zi, yi, xi]
    new_d = jnp.where(m, dist, cur_d)
    new_a = jnp.where(m[:, None], albedo, cur_a)
    new_g = jnp.where(m[:, None], grad_stored, cur_g)
    return vol._replace(
        dist=vol.dist.at[zi, yi, xi].set(new_d),
        color=vol.color.at[zi, yi, xi].set(new_a),
        grad=vol.grad.at[zi, yi, xi].set(new_g),
    )
