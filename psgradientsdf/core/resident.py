"""Resident streaming volume: chunk-compact state for the track+fuse loop.

STATUS: this design was built to amortize the culled-fusion state-row
movement by keeping the active rows compact across a chunk.  On the
accelerator the system was first built for, the shipped per-frame kernel
(which overlaps the row movement with the pixel gather) beat every
resident variant, so the streaming executors do NOT use it.  It has not
been measured on the GPU.  The module stays as a tested capability and
as the reference implementation of the at-scale
layout rules (2-D carries, vis-derived ledger, transposed record table)
that any future compact-state design must follow.

The original design, still accurate for the semantics (re-implementing
/root/reference/cpp/include/sdf_tracker/VolumetricGradSdf.cpp:78-134 on
a chunk-resident compact state, with tracking between frames — the
K-frame batched kernel in core/volume.py is GT-pose only):

  ResidentVolume
    rows      [CAPR, S*8] f32    compact payload rows (slot-major; slots
                                 0..n_used-1 live, the rest free; 2-D so
                                 the loop carry avoids minor-dim-8 tile
                                 padding — see the class docstring)
    vis_rows  [Wc, CAPR, S] u32  bit-packed visibility for resident rows
    row_slot  [NSEG] i32         slot of grid row r (CAPR = unresident)
    slot_rows [CAPR] i32         grid row of slot s (NSEG = free)
    n_used    scalar i32
    fused_ever [NSEG] bool       rows that ever stored weight > 0 — the
                                 tracker-exactness ledger (see below)
    flags     scalar i32         sticky error bits (see FLAG_*)

Within a chunk the membership grows monotonically: `resident_alloc` admits
rows entering the cull's active set (gathering their canonical state — a
static DELTA capacity, ~1-2% of rows per frame), `fuse_frame_resident`
updates resident rows IN PLACE (the exact _fuse_voxel_update), and at
chunk boundaries `resident_flush` scatters everything back to the
canonical PackedVolume and `resident_refresh` restarts from the current
pose's active set.  State movement per frame drops from 2x the full
active set to the delta + (flush+refresh)/chunk_len.

Tracking reads ONLY the compact rows (`track_frame_resident`): a pixel
whose nearest voxel is unresident is treated as weight 0.  That is
equivalent to the canonical tracker (same masks, same record values;
cross-program float emission differs by ~ULP — tests/test_resident.py)
unless the row both (a) stored weight from an earlier epoch and (b) left
the resident set, which is what `fused_ever` detects: `miss_bad`
(FLAG_TRACK_MISS) rises iff an excluded pixel's row is in the ledger, and
the caller must redo the chunk on the canonical path.  The tracker moves
the pose AWAY from the pose its rows were admitted at, so tracker-prep
allocation passes motion margins (margin_px/margin_t) to pre-admit the
rows the GN path may query; the flag is the correctness net behind the
margins.

All ops are jit-composable pure functions over the NamedTuple — the
streaming executors carry the whole state inside one program (scalar
outputs only; see core/volume.py PackedVolume).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import (
    PackedVolume,
    _fuse_voxel_update,
    _row_activity,
    _row_world_coords,
    pack_pixel_payload,
)

# Segment granularity (seg_x): the resident slot unit can be an S-voxel
# X-SEGMENT instead of a whole X-row.  The non-resident seg_x experiment
# lost (measured and rejected, round 4) because its
# per-FRAME state gather paid per-row overhead on shorter rows; here the
# state is resident — the per-frame costs are the pixel-payload gather and
# the elementwise update, both proportional to the resident VOXEL count —
# so the segment cull's 25-41% index cut (256^3/512^3) is pure win.  The
# slot length S is carried in rows.shape[1]; only resident_refresh takes
# seg_x explicitly (it creates the state).

FLAG_CAPACITY = 1      # resident row capacity exhausted
FLAG_DELTA = 2         # per-frame delta capacity exhausted
FLAG_COVERAGE = 4      # fusion-active row was unresident at update time
FLAG_TRACK_MISS = 8    # tracker excluded a fused-ever unresident row


class ResidentVolume(NamedTuple):
    # rows is carried 2-D [CAPR, S*8] (not [CAPR, S, 8]): loop carries
    # materialize in a real layout, and a trailing dim of 8 tile-pads
    # 16x under T(8,128) — a 19 GB carry at 512^3.  The 3-D view is a
    # contiguous reshape taken transiently inside the update, where XLA
    # fuses it (same pattern as fuse_frame_culled_packed's gathered rows).
    rows: jax.Array        # [CAPR, S*8] f32
    vis_rows: jax.Array    # [Wc, CAPR, S] u32
    row_slot: jax.Array    # [NSEG] i32 (CAPR = unresident)
    slot_rows: jax.Array   # [CAPR] i32 (NSEG = free)
    n_used: jax.Array      # scalar i32
    fused_ever: jax.Array  # [NSEG] bool
    flags: jax.Array       # scalar i32 sticky FLAG_* bits


def _shapes(pvol: PackedVolume, seg_x: Optional[int] = None):
    """(vis words, slot count, slot length) at the chosen granularity.

    Accepts the canonical 4-D PackedVolume OR a pre-reshaped streaming
    state (payload [NSEG, S*8], vis [Wc, NSEG, S]).  The streaming
    executors pre-reshape ONCE outside the hot loops: carrying the 4-D
    canonical shape through a fori_loop makes every 2-D view a
    non-tile-trivial reshape, and XLA materializes full payload copies
    per chunk (2x 4 GB at 512^3 — measured round 4)."""
    if pvol.vis.ndim == 3:
        Wc, NSEG, S = pvol.vis.shape
        assert seg_x is None or seg_x == S, (seg_x, S)
        assert pvol.payload.shape == (NSEG, S * 8), pvol.payload.shape
        return Wc, NSEG, S
    Wc, Z, Y, X = pvol.vis.shape
    S = X if seg_x is None else seg_x
    assert X % S == 0, f"seg_x={S} must divide X={X}"
    return Wc, Z * Y * (X // S), S


def to_streaming(pvol: PackedVolume, seg_x: Optional[int] = None
                 ) -> PackedVolume:
    """Reshape the canonical 4-D state to the slot-granularity streaming
    shapes (payload [NSEG, S*8], vis [Wc, NSEG, S]) — do this once,
    OUTSIDE the streaming program's loops (see _shapes)."""
    Wc, NSEG, S = _shapes(pvol, seg_x)
    return PackedVolume(payload=pvol.payload.reshape(NSEG, S * 8),
                        vis=pvol.vis.reshape(Wc, NSEG, S))


def from_streaming(pvol: PackedVolume, dims) -> PackedVolume:
    """Inverse of to_streaming: back to the canonical [Z,Y,X,8]/[Wc,Z,Y,X]."""
    X, Y, Z = dims
    Wc = pvol.vis.shape[0]
    return PackedVolume(payload=pvol.payload.reshape(Z, Y, X, 8),
                        vis=pvol.vis.reshape(Wc, Z, Y, X))


def _act_flat(geom, depth, K, pose, *, truncation, zmin, zmax, S,
              margin_px=0.0, margin_t=0.0):
    """Flattened slot-granularity activity mask ([NSEG] at slot length S)."""
    seg = None if S == geom.dims[0] else S
    return _row_activity(geom, depth, K, pose, truncation=truncation,
                         zmin=zmin, zmax=zmax, seg_x=seg,
                         margin_px=margin_px, margin_t=margin_t).reshape(-1)


def fused_ever_from_vis(pvol: PackedVolume, seg_x: Optional[int] = None
                        ) -> jax.Array:
    """[NSEG] bool: slots that ever stored fusion weight, derived from the
    visibility words — _fuse_voxel_update sets a vis bit exactly when it
    adds weight (same mask), so any-bit-set <=> weight ever stored.  Reads
    only the u32 vis table: computing this from payload[..., 4] forces XLA
    to materialize the full payload in an unpacked minor-dim-8 layout
    (16x tile padding = 64 GB at 512^3 — the round-4 compile OOM)."""
    Wc, NSEG, S = _shapes(pvol, seg_x)
    v = pvol.vis.reshape(Wc, NSEG, S)
    return jnp.any(jnp.any(v != 0, axis=0), axis=-1)


def resident_refresh(
    pvol: PackedVolume,
    geom: GridGeometry,
    depth: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    capacity: int,
    seg_x: Optional[int] = None,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
) -> ResidentVolume:
    """Start a resident epoch: gather the rows (or S-voxel X-segments, with
    seg_x) active at `pose` from the canonical volume.  `pvol` must be
    CURRENT (freshly flushed).  margins: see resident_alloc."""
    Wc, NSEG, S = _shapes(pvol, seg_x)
    act = _act_flat(geom, depth, K, pose, truncation=truncation,
                    zmin=zmin, zmax=zmax, S=S, margin_px=margin_px,
                    margin_t=margin_t)
    n_act = jnp.sum(act.astype(jnp.int32))
    (ridx,) = jnp.nonzero(act, size=capacity, fill_value=NSEG)
    ok = ridx < NSEG
    safe = jnp.minimum(ridx, NSEG - 1)

    # canonical access via the 3-D [NSEG, S, 8] view — the packed kernel's
    # proven gather pattern; a 2-D [NSEG, S*8] view of the 4-D canonical
    # materializes a full payload copy per loop iteration (round 4)
    state3 = pvol.payload.reshape(NSEG, S, 8)
    rows = jnp.take(state3, safe, axis=0).reshape(capacity, S * 8)
    vis_rows = jnp.take(pvol.vis.reshape(Wc, NSEG, S), safe, axis=1)
    # free slots must not alias live rows' content semantics: they are
    # ignored via slot_rows == NSEG, so duplicated gathers are harmless

    slot_ids = jnp.arange(capacity, dtype=jnp.int32)
    row_slot = jnp.full((NSEG,), capacity, jnp.int32).at[ridx].set(
        jnp.where(ok, slot_ids, capacity), mode="drop")
    slot_rows = jnp.where(ok, ridx, NSEG).astype(jnp.int32)
    fused_ever = fused_ever_from_vis(pvol, seg_x)
    flags = jnp.where(n_act > capacity, FLAG_CAPACITY, 0).astype(jnp.int32)
    return ResidentVolume(
        rows=rows, vis_rows=vis_rows, row_slot=row_slot,
        slot_rows=slot_rows, n_used=jnp.minimum(n_act, capacity),
        fused_ever=fused_ever, flags=flags,
    )


def resident_flush(res: ResidentVolume, pvol: PackedVolume) -> PackedVolume:
    """Scatter the resident rows back into the canonical volume."""
    Wc = pvol.vis.shape[0]
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NSEG = res.row_slot.shape[0]
    state3 = pvol.payload.reshape(NSEG, S, 8)   # 3-D view: see refresh
    new3 = state3.at[res.slot_rows].set(
        res.rows.reshape(CAPR, S, 8), mode="drop")
    vis3 = pvol.vis.reshape(Wc, NSEG, S)
    # scatter per word plane (Wc is tiny — 1-8 words)
    new_vis = vis3.at[:, res.slot_rows].set(res.vis_rows, mode="drop")
    return PackedVolume(payload=new3.reshape(pvol.payload.shape),
                        vis=new_vis.reshape(pvol.vis.shape))


def resident_alloc(
    res: ResidentVolume,
    pvol: PackedVolume,
    geom: GridGeometry,
    depth: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    delta_capacity: int,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
) -> ResidentVolume:
    """Admit rows newly active at `pose`, pulling their state from the
    canonical volume (which is current for unresident rows — resident
    rows' canonical copies are stale, but those are not gathered).

    margin_px / margin_t inflate the cull (_row_activity) so the admitted
    set also covers the rows a tracking solve may query while it moves
    the pose away from `pose` — the tracker-prep allocation passes the
    expected inter-frame motion here (reprojection pixels / camera-depth
    meters); the fusion-prep allocation at the known tracked pose passes
    zero."""
    Wc = pvol.vis.shape[0]
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NSEG = res.row_slot.shape[0]
    act = _act_flat(geom, depth, K, pose, truncation=truncation,
                    zmin=zmin, zmax=zmax, S=S, margin_px=margin_px,
                    margin_t=margin_t)
    new_mask = act & (res.row_slot >= CAPR)
    n_new = jnp.sum(new_mask.astype(jnp.int32))
    (didx,) = jnp.nonzero(new_mask, size=delta_capacity, fill_value=NSEG)
    d_ok = (didx < NSEG) & (jnp.arange(delta_capacity) < n_new)
    slots_new = res.n_used + jnp.arange(delta_capacity, dtype=jnp.int32)
    d_ok = d_ok & (slots_new < CAPR)
    safe_d = jnp.minimum(didx, NSEG - 1)
    write_slot = jnp.where(d_ok, slots_new, CAPR)      # CAPR drops

    state3 = pvol.payload.reshape(NSEG, S, 8)   # 3-D view: see refresh
    rows_d = jnp.take(state3, safe_d, axis=0).reshape(delta_capacity, S * 8)
    vis_d = jnp.take(pvol.vis.reshape(Wc, NSEG, S), safe_d, axis=1)

    rows = res.rows.at[write_slot].set(rows_d, mode="drop")
    vis_rows = res.vis_rows.at[:, write_slot].set(vis_d, mode="drop")
    row_slot = res.row_slot.at[didx].set(
        jnp.where(d_ok, slots_new, res.row_slot[safe_d]), mode="drop")
    slot_rows = res.slot_rows.at[write_slot].set(
        jnp.where(d_ok, didx, NSEG), mode="drop")
    n_adm = jnp.minimum(n_new, jnp.minimum(delta_capacity, CAPR - res.n_used))
    flags = res.flags | jnp.where(
        n_new > delta_capacity, FLAG_DELTA, 0
    ) | jnp.where(res.n_used + n_new > CAPR, FLAG_CAPACITY, 0)
    return res._replace(rows=rows, vis_rows=vis_rows, row_slot=row_slot,
                        slot_rows=slot_rows, n_used=res.n_used + n_adm,
                        flags=flags.astype(jnp.int32))


def fuse_frame_resident(
    res: ResidentVolume,
    geom: GridGeometry,
    color: jax.Array,
    depth: jax.Array,
    normals: jax.Array,
    n_sq_inv: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    frame_idx: jax.Array,
    gate: Optional[jax.Array] = None,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    update_ledger: bool = True,
) -> ResidentVolume:
    """One frame fused IN PLACE on the resident rows — the exact per-voxel
    update (shared _fuse_voxel_update, bit-identical to fuse_frame on the
    resident rows), gated per slot by this frame's level-1 cull.  An
    active-but-unresident row raises FLAG_COVERAGE (the update would be
    incomplete; the caller must redo on the canonical path).

    update_ledger=False skips the fused_ever scatter (an [NSEG]-sized op
    per frame) — valid whenever the caller does not use the compact-only
    tracker (e.g. the stale-map streaming executor, which tracks against
    the full canonical volume instead)."""
    X, Y, Zd = geom.dims
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NS = X // S
    NSEG = res.row_slot.shape[0]
    H, W = depth.shape

    act = _act_flat(geom, depth, K, pose, truncation=truncation,
                    zmin=zmin, zmax=zmax, S=S)
    if gate is not None:
        act = act & gate
    coverage_bad = jnp.any(act & (res.row_slot >= CAPR))

    act_pad = jnp.concatenate([act, jnp.zeros((1,), act.dtype)])
    slot_act = act_pad[jnp.minimum(res.slot_rows, NSEG)]   # [CAPR]
    slot_live = res.slot_rows < NSEG
    row_gate = (slot_act & slot_live)[:, None]

    pixp = pack_pixel_payload(color, depth, normals, n_sq_inv)
    safe_rows = jnp.minimum(res.slot_rows, NSEG - 1)
    # voxel centers via the SHARED producer (_row_world_coords): an
    # iota-based local formula here constant-folds with different rounding
    # than the data-dependent arithmetic in the culled kernels, and 1-ULP
    # p_w differences flip nearest-pixel rounding at pixel boundaries
    # (~0.1% of voxels) — identical expression trees keep the programs
    # agreeing to the bit on the projection.
    p_w = _row_world_coords(geom, safe_rows, None, S, NS, CAPR)

    word = frame_idx // 32
    bit = (jnp.uint32(1) << jnp.uint32(frame_idx % 32))
    rows = res.rows.reshape(CAPR, S, 8)   # transient 3-D view (see rows doc)
    nd, ng, nw, nc, vis_or = _fuse_voxel_update(
        p_w, rows[..., 0], rows[..., 1:4], rows[..., 4], rows[..., 5:8],
        pixp, K, pose, (H, W), bit, row_gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq,
    )
    new_rows = jnp.concatenate([nd[..., None], ng, nw[..., None], nc],
                               axis=-1).reshape(CAPR, S * 8)
    vplane = jax.lax.dynamic_index_in_dim(res.vis_rows, word, axis=0,
                                          keepdims=False)
    vis_rows = jax.lax.dynamic_update_index_in_dim(
        res.vis_rows, vplane | vis_or, word, axis=0)

    if update_ledger:
        # exact fused-ever ledger: rows whose update stored weight this frame
        fused_now = jnp.any(vis_or != 0, axis=-1)          # [CAPR]
        fe_pad = jnp.concatenate(
            [res.fused_ever, jnp.zeros((1,), jnp.bool_)])
        fused_ever = fe_pad.at[jnp.where(fused_now, res.slot_rows, NSEG)].set(
            True, mode="drop")[:NSEG]
    else:
        fused_ever = res.fused_ever

    flags = res.flags | jnp.where(coverage_bad, FLAG_COVERAGE, 0)
    return res._replace(rows=new_rows, vis_rows=vis_rows,
                        fused_ever=fused_ever,
                        flags=flags.astype(jnp.int32))


def resident_records(
    res: ResidentVolume, geom: GridGeometry, pts: jax.Array
):
    """Nearest-voxel tracking records from the COMPACT rows only:
    (d, ghat, c_v, w, valid, miss_px).  Unresident rows read as weight 0;
    miss_px marks pixels whose (valid, unresident) row is in the
    fused_ever ledger — the result could then differ from the canonical
    tracker (see module docstring); callers AND it with their own pixel
    mask and reduce."""
    X, Y = geom.dims[0], geom.dims[1]
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NS = X // S
    NSEG = res.row_slot.shape[0]
    idx, valid = geom.nearest_info(pts)
    lin_row = (idx[..., 2] * Y + idx[..., 1]) * NS + idx[..., 0] // S
    slot = res.row_slot[lin_row]
    resident = slot < CAPR
    cl = jnp.minimum(slot, CAPR - 1) * S + idx[..., 0] % S
    # transposed-table gather: a [CAPR*S, 8] reshape of the 2-D carry is
    # not tile-trivial, and XLA materializes it minor-dim-8 padded (16x =
    # 15.7 GB at 512^3 — round-4 compile OOM).  The [8, V] transpose is
    # unpadded (minor dim V), costs one HBM-rate copy per gather round,
    # and its column gather IS the fast transposed-gather pattern.
    rowsT = res.rows.reshape(CAPR, S, 8).transpose(2, 0, 1).reshape(
        8, CAPR * S)
    recs = jnp.take(rowsT, cl.reshape(-1), axis=1)       # [8, Npts]
    lead = cl.shape
    d = recs[0].reshape(lead)
    g = jnp.stack([recs[1].reshape(lead), recs[2].reshape(lead),
                   recs[3].reshape(lead)], axis=-1)
    w = jnp.where(resident, recs[4].reshape(lead), 0.0)
    gnorm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    ghat = g / jnp.maximum(gnorm, 1e-12)
    c_v = geom.voxel2world(idx)
    miss_px = valid & ~resident & res.fused_ever[lin_row]
    return d, ghat, c_v, w, valid, miss_px


def track_frame_resident(
    res: ResidentVolume,
    geom: GridGeometry,
    depth: jax.Array,
    K: jax.Array,
    init_pose: jax.Array,
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
):
    """track_frame against the resident rows (tracking/tracker.py semantics;
    compact-only reads).  Returns (TrackResult, miss_bad) — miss_bad is the
    OR over every gather round's exactness flag."""
    from psgradientsdf.tracking.tracker import TrackResult, run_gn_rounds

    if stride > 1:
        depth = depth[::stride, ::stride]
    H_img, W_img = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = (jnp.arange(W_img, dtype=jnp.float32) * stride)[None, :]
    rows_px = (jnp.arange(H_img, dtype=jnp.float32) * stride)[:, None]
    x0 = (cols - cx) / fx
    y0 = (rows_px - cy) / fy
    z = depth
    pts_cam = jnp.stack(
        [jnp.broadcast_to(x0, z.shape) * z,
         jnp.broadcast_to(y0, z.shape) * z, z], axis=-1).reshape(-1, 3)
    valid_z = ((z > zmin) & (z < zmax)).reshape(-1)

    def gather_records(pose):
        R = pose[:3, :3]
        t = pose[:3, 3]
        p_w = pts_cam @ R.T + t
        d, ghat, c_v, w, valid, miss_px = resident_records(res, geom, p_w)
        ok = valid & (w > 0.0) & valid_z
        return (d, ghat, c_v, ok), jnp.any(miss_px & valid_z)

    def masked_gram(pose, rec):
        d, ghat, c_v, ok = rec
        R = pose[:3, :3]
        t = pose[:3, 3]
        p_w = pts_cam @ R.T + t
        psi = d + jnp.sum(ghat * (c_v - p_w), axis=-1)
        mf = ok.astype(psi.dtype)
        G = jnp.concatenate(
            [ghat, jnp.cross(p_w, ghat), psi[:, None],
             jnp.ones_like(psi)[:, None]], axis=-1) * mf[:, None]
        S_ = G.T @ G
        return S_[6, 6], S_[:6, 6], S_[:6, :6], S_[7, 7]

    pose, conv, fail, E_mean, count, iters, miss = run_gn_rounds(
        geom, gather_records, masked_gram, init_pose,
        num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
        damping=damping, regather_every=regather_every,
        early_exit=early_exit, records_flagged=True,
    )
    return (
        TrackResult(pose=pose, converged=conv & (~fail), iterations=iters,
                    energy=E_mean, num_valid=count),
        miss,
    )
