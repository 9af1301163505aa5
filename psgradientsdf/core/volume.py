"""Gradient-SDF volume: SoA arrays + the volumetric fusion kernel.

Accelerator-oriented redesign of VolumetricGradSdf (cpp/include/sdf_tracker/
VolumetricGradSdf.{h,cpp}).  The reference's AoS `SdfVoxel*` heap array plus
ragged per-voxel `std::vector<bool>` visibility becomes five dense,
statically-shaped arrays (a JAX pytree):

    dist    [Z,Y,X]     truncated signed distance (negative inside)
    grad    [Z,Y,X,3]   accumulated (unnormalized) Gradient-SDF gradient
    weight  [Z,Y,X]     fusion confidence
    color   [Z,Y,X,3]   running-mean RGB
    vis     [W,Z,Y,X]   uint32 bit-packed per-frame visibility
                        (bit f%32 of word f//32 == "voxel updated in frame f")

Fusion (`fuse_frame`) evaluates the reference's per-voxel update
(VolumetricGradSdf.cpp:51-138) for *all* voxels in one fused elementwise +
gather kernel: transform to camera, project to nearest pixel, gate
(z-range / fusion weight / normal validity / viewing angle), then masked
running-mean updates.  No scatter is needed — the loop is over voxels, not
pixels, so everything is a gather from the image maps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry


def _state_rows_gather(table2d: jax.Array, idx: jax.Array, impl: str):
    """Gather CAP contiguous state rows from a [NSEG, R] 2-D view.

    impl selects the movement engine:
      "xla"    caller keeps its inline jnp.take (this helper unused) —
               XLA fuses the update arithmetic into the gather.
      "xla2d"  jnp.take on the 2-D row view fenced with
               optimization_barrier so the movement compiles as a
               standalone row copy.
    """
    if impl == "xla2d":
        return jax.lax.optimization_barrier(jnp.take(table2d, idx, axis=0))
    raise ValueError(impl)


def _state_rows_scatter(table2d: jax.Array, idx: jax.Array, rows: jax.Array,
                        impl: str):
    """Scatter rows back into the [NSEG, R] 2-D view at idx (see gather).

    idx may contain duplicates ONLY if their rows carry identical data
    (the culled kernels' padding contract)."""
    rows = jax.lax.optimization_barrier(rows)
    if impl == "xla2d":
        return table2d.at[idx].set(rows)
    raise ValueError(impl)


class GradSdfVolume(NamedTuple):
    dist: jax.Array      # [Z,Y,X] f32
    grad: jax.Array      # [Z,Y,X,3] f32
    weight: jax.Array    # [Z,Y,X] f32
    color: jax.Array     # [Z,Y,X,3] f32
    vis: jax.Array       # [W,Z,Y,X] uint32 bit-packed visibility


def make_volume(geom: GridGeometry, truncation: float, frame_cap: int = 256) -> GradSdfVolume:
    """Fresh volume: dist = +T everywhere (VolumetricGradSdf.cpp:14-38)."""
    zyx = geom.shape_zyx
    n_words = (frame_cap + 31) // 32
    return GradSdfVolume(
        dist=jnp.full(zyx, truncation, dtype=jnp.float32),
        grad=jnp.zeros(zyx + (3,), dtype=jnp.float32),
        weight=jnp.zeros(zyx, dtype=jnp.float32),
        color=jnp.zeros(zyx + (3,), dtype=jnp.float32),
        vis=jnp.zeros((n_words,) + zyx, dtype=jnp.uint32),
    )


def fusion_weight(sdf: jax.Array, T: float) -> jax.Array:
    """Asymmetric fusion weight (Sdf.h:48-66): 1 in front of the surface
    (sdf >= 0), linear ramp 1 + sdf/T on [-T, 0), 0 behind."""
    return jnp.where(sdf >= 0.0, 1.0, jnp.where(sdf >= -T, 1.0 + sdf / T, 0.0))


def _fuse_voxel_update(
    p_w: jax.Array,        # [...,3] voxel-center world coords
    dist: jax.Array,       # [...] current state (same leading shape)
    grad: jax.Array,       # [...,3]
    weight: jax.Array,     # [...]
    color_v: jax.Array,    # [...,3]
    pix_payload: jax.Array,  # [H*W,8] packed (depth, normal, color, nsq)
    K: jax.Array,
    pose: jax.Array,
    img_hw: Tuple[int, int],
    bit: jax.Array,        # uint32 visibility bit value
    gate: Optional[jax.Array],
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float,
):
    """The per-voxel fusion update (VolumetricGradSdf.cpp:78-134) on an
    arbitrary-shaped batch of voxels — shared verbatim by the full-grid
    kernel (fuse_frame) and the row-culled kernel (fuse_frame_culled), so
    the two are arithmetically identical by construction.

    Returns (new_dist, new_grad, new_weight, new_color, vis_or [uint32]).

    The state inputs and outputs are optimization_barrier-fenced so the
    update compiles as the SAME fusion island in every caller: without the
    fences, kernels whose state movement is itself fenced (rows_impl !=
    "xla") saw XLA make different FMA-contraction choices inside the grad
    update than fuse_frame did, producing 1-ULP grad differences and
    breaking the kernels' bit-identity contract (round 4).  The fences
    also decouple state movement from update arithmetic, which is what
    lets the movement compile as real row copies instead of element
    gathers."""
    dist, grad, weight, color_v = jax.lax.optimization_barrier(
        (dist, grad, weight, color_v))
    H, W = img_hw
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = pose[:3, :3]
    t = pose[:3, 3]

    p_c = jnp.einsum("ij,...j->...i", R.T, p_w - t)
    pz = p_c[..., 2]
    in_front = pz > 0.0

    safe_z = jnp.where(in_front, pz, 1.0)
    # nearest-pixel projection with +0.5 rounding via int cast
    # (VolumetricGradSdf.cpp:87-88 static_cast<int> truncates toward zero,
    # which accepts the [-0.5, 0) sliver as pixel 0 — floor would not)
    u = (cx + fx * p_c[..., 0] / safe_z + 0.5).astype(jnp.int32)
    v = (cy + fy * p_c[..., 1] / safe_z + 0.5).astype(jnp.int32)
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc = jnp.clip(u, 0, W - 1)
    vc = jnp.clip(v, 0, H - 1)

    # all eight per-pixel quantities ride ONE row-gather of a packed
    # payload (one index stream instead of one per map).
    rows = jnp.take(pix_payload, vc * W + uc, axis=0)   # [...,8]
    z = rows[..., 0]
    n_img = rows[..., 1:4]
    col = rows[..., 4:7]
    nsq = rows[..., 7]

    z_ok = (z > zmin) & (z < zmax)

    sdf = z - pz
    w = fusion_weight(sdf, truncation)

    n_valid = jnp.sum(n_img * n_img, axis=-1) >= 0.1

    # viewing-angle gate: cos^2(angle between normal and ray) >= cos_thresh_sq
    # (VolumetricGradSdf.cpp:114-116)
    xy_hom = p_c / safe_z[..., None]
    ndot = jnp.sum(n_img * xy_hom, axis=-1)
    angle_ok = ndot * ndot * nsq >= cos_thresh_sq

    mask = in_front & in_img & z_ok & (w > 0.0) & n_valid & angle_ok
    if gate is not None:
        mask = mask & gate
    wm = jnp.where(mask, w, 0.0)

    new_weight = weight + wm
    safe_W = jnp.maximum(new_weight, 1e-12)
    tr_sdf = jnp.clip(sdf, -truncation, truncation)
    new_dist = dist + (tr_sdf - dist) * wm / safe_W
    # normals are inward-pointing -> accumulate -w * R * n (cpp:123)
    n_world = jnp.einsum("ij,...j->...i", R, n_img)
    new_grad = grad - wm[..., None] * n_world
    new_color = color_v + (col - color_v) * (wm / safe_W)[..., None]
    vis_or = jnp.where(mask, bit, jnp.uint32(0))
    return jax.lax.optimization_barrier(
        (new_dist, new_grad, new_weight, new_color, vis_or))


def pack_pixel_payload(color, depth, normals, n_sq_inv):
    """[H*W,8] packed per-pixel fusion payload (one row-gatherable table)."""
    H, W = depth.shape
    return jnp.concatenate(
        [depth[..., None], normals, color, n_sq_inv[..., None]], axis=-1
    ).reshape(H * W, 8)


@functools.partial(
    jax.jit, static_argnames=("geom", "truncation", "zmin", "zmax", "cos_thresh_sq")
)
def fuse_frame(
    vol: GradSdfVolume,
    geom: GridGeometry,
    color: jax.Array,      # [H,W,3] RGB in [0,1]
    depth: jax.Array,      # [H,W] meters
    normals: jax.Array,    # [H,W,3] unit inward normals (FALS)
    n_sq_inv: jax.Array,   # [H,W] cached 1/(1+x0^2+y0^2) from the FALS cache
    K: jax.Array,          # [3,3]
    pose: jax.Array,       # [4,4] camera-to-world
    frame_idx: jax.Array,  # scalar int32 — visibility bit to set
    gate: Optional[jax.Array] = None,  # scalar bool — False => no-op update
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
) -> GradSdfVolume:
    """One fused depth/color frame (VolumetricGradSdf.cpp:51-138).

    `gate` makes the whole update a masked no-op when False — the static-
    control-flow alternative to wrapping the call in lax.cond (dynamic
    conditionals block cross-frame dispatch pipelining)."""
    H, W = depth.shape
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)
    p_w = geom.world_coords()                      # [Z,Y,X,3]

    word = frame_idx // 32
    bit = (jnp.uint32(1) << jnp.uint32(frame_idx % 32))
    new_dist, new_grad, new_weight, new_color, vis_or = _fuse_voxel_update(
        p_w, vol.dist, vol.grad, vol.weight, vol.color, pix_payload, K, pose,
        (H, W), bit, gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq,
    )
    new_vis = vol.vis.at[word].set(vol.vis[word] | vis_or)
    return GradSdfVolume(
        dist=new_dist, grad=new_grad, weight=new_weight, color=new_color, vis=new_vis
    )


def _row_activity(
    geom: GridGeometry,
    depth: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    z0: Optional[jax.Array] = None,   # slab z-offset (sharded slabs)
    z_rows: Optional[int] = None,     # slab z extent (default: whole grid)
    z_idx: Optional[jax.Array] = None,  # [z_rows] explicit global z per
                                        # local plane (interleaved slabs;
                                        # overrides z0)
    seg_x: Optional[int] = None,      # X-segment length (None = whole row)
    margin_px: float = 0.0,           # extra pixel margin on the image test
    margin_t: float = 0.0,            # extra meters on the carve/behind tests
) -> jax.Array:
    """Level-1 cull of fuse_frame_culled: conservative activity mask at
    X-row granularity ([z_rows, Y], seg_x=None) or X-SEGMENT granularity
    ([z_rows, Y, X//seg_x]) — the endpoint bounds are exact for any x
    interval (u, v are Moebius in x with constant derivative sign where
    pz > 0), so segments just evaluate them at the segment ends.  Segment
    culling cuts the level-2 gather index count a further 25% at 256^3 /
    41% at 512^3 on the bench scene (long rows only graze the frustum or
    the truncation band).  With (z0, z_rows) the mask covers a Z-slab —
    the per-shard form used under shard_map.

    margin_px / margin_t inflate the image-footprint and depth-band tests
    so the mask stays a superset of the active set under pose motion
    bounded by ~(margin_px pixels of reprojection, margin_t meters of
    camera-depth change) — the resident allocator (core/resident.py) uses
    this to pre-admit the rows a tracking solve may query while it moves
    the pose away from its seed.  Zero margins reproduce the historical
    exact-frame cull."""
    H, W = depth.shape
    X, Y, Zd = geom.dims
    if z_rows is None:
        z_rows = Zd
    S = X if seg_x is None else seg_x
    assert X % S == 0, f"seg_x={S} must divide X={X}"
    NS = X // S
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = pose[:3, :3]
    t = pose[:3, 3]
    origin = jnp.array(geom.origin, dtype=jnp.float32)
    h = geom.voxel_size
    if z_idx is not None:
        zi = z_idx.astype(jnp.float32)[:, None, None]           # [Zl,1,1]
    else:
        zi = jnp.arange(z_rows, dtype=jnp.float32)[:, None, None]
        if z0 is not None:
            zi = zi + z0.astype(jnp.float32)
    yi = jnp.arange(Y, dtype=jnp.float32)[None, :, None]        # [1,Y,1]

    def endpoint_cam(x_idx):                                    # [1,1,NS]
        px = origin[0] + h * x_idx
        py = origin[1] + h * yi
        pz_w = origin[2] + h * zi
        pw = jnp.stack(
            [jnp.broadcast_to(px, (z_rows, Y, NS)),
             jnp.broadcast_to(py, (z_rows, Y, NS)),
             jnp.broadcast_to(pz_w, (z_rows, Y, NS))], axis=-1)
        return jnp.einsum("ij,zysj->zysi", R.T, pw - t)

    sx = jnp.arange(NS, dtype=jnp.float32)[None, None, :] * S
    p0 = endpoint_cam(sx)
    p1 = endpoint_cam(sx + (S - 1))
    pz0, pz1 = p0[..., 2], p1[..., 2]
    eps_z = 1e-5 * (jnp.abs(pz0) + jnp.abs(pz1)) + 1e-6
    both_behind = (pz0 <= eps_z - margin_t) & (pz1 <= eps_z - margin_t)
    both_front = (pz0 > eps_z) & (pz1 > eps_z)
    mixed = ~both_behind & ~both_front

    sz0 = jnp.where(pz0 > 0, pz0, 1.0)
    sz1 = jnp.where(pz1 > 0, pz1, 1.0)
    u0 = cx + fx * p0[..., 0] / sz0
    u1 = cx + fx * p1[..., 0] / sz1
    v0 = cy + fy * p0[..., 1] / sz0
    v1 = cy + fy * p1[..., 1] / sz1
    mu = 0.01 + 1e-5 * (jnp.abs(u0) + jnp.abs(u1)) + margin_px
    mv_ = 0.01 + 1e-5 * (jnp.abs(v0) + jnp.abs(v1)) + margin_px
    u_min = jnp.minimum(u0, u1) - mu
    u_max = jnp.maximum(u0, u1) + mu
    v_min = jnp.minimum(v0, v1) - mv_
    v_max = jnp.maximum(v0, v1) + mv_
    # exact in_img (after +0.5 int-cast rounding): -1.5 < u_f < W - 0.5
    img_possible = (
        (u_max > -1.5) & (u_min < W - 0.5) & (v_max > -1.5) & (v_min < H - 0.5)
    )

    # per-image-row max VALID depth + RMQ sparse table for range maxima
    z_valid = jnp.where((depth > zmin) & (depth < zmax), depth, -jnp.inf)
    row_max = jnp.max(z_valid, axis=1)                    # [H]
    levels = max(1, (H - 1).bit_length())
    st = [row_max]
    for l in range(1, levels):
        half = 1 << (l - 1)
        idx = jnp.minimum(jnp.arange(H) + half, H - 1)
        st.append(jnp.maximum(st[-1], st[-1][idx]))
    st = jnp.stack(st)                                    # [L,H]

    v_lo = jnp.clip(jnp.floor(v_min - 1.0), 0, H - 1).astype(jnp.int32)
    v_hi = jnp.clip(jnp.ceil(v_max + 1.0), 0, H - 1).astype(jnp.int32)
    span = jnp.maximum(v_hi - v_lo + 1, 1)
    k = jnp.clip(
        jnp.floor(jnp.log2(span.astype(jnp.float32)) + 1e-6), 0, levels - 1
    ).astype(jnp.int32)
    pow_k = (jnp.int32(1) << k)
    flat = st.reshape(-1)
    q1 = jnp.take(flat, k * H + v_lo)
    q2 = jnp.take(flat, k * H + jnp.maximum(v_hi - pow_k + 1, 0))
    z_fp_max = jnp.maximum(q1, q2)                        # [Z,Y]
    z_fp_max = jnp.where(mixed, jnp.max(row_max), z_fp_max)

    pz_min = jnp.minimum(pz0, pz1) - eps_z
    carve_ok = pz_min - truncation - margin_t <= z_fp_max  # -inf -> cull

    act = ~both_behind & (img_possible | mixed) & carve_ok
    if seg_x is None:
        return act[..., 0]            # [Zl, Y] — the historical row form
    return act                        # [Zl, Y, NS]


def count_active_rows(
    geom: GridGeometry,
    depth: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    seg_x: Optional[int] = None,
) -> jax.Array:
    """Number of rows (or X-segments, with seg_x) fuse_frame_culled would
    process for this frame — the capacity-sizing probe for callers
    choosing row_capacity."""
    return jnp.sum(_row_activity(
        geom, depth, K, pose, truncation=truncation, zmin=zmin, zmax=zmax,
        seg_x=seg_x).astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=(
        "geom", "truncation", "zmin", "zmax", "cos_thresh_sq",
        "row_capacity", "seg_x", "rows_impl",
    ),
)
def fuse_frame_culled(
    vol: GradSdfVolume,
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
    row_capacity: int,
    seg_x: Optional[int] = None,
    rows_impl: str = "xla",
) -> Tuple[GradSdfVolume, jax.Array]:
    """Two-level-culled fusion: exact fuse_frame semantics at a fraction of
    the gather cost.

    The reference (and fuse_frame) gathers a pixel payload for ALL Z*Y*X
    voxels every frame (VolumetricGradSdf.cpp:78) even though most fail the
    frustum/z-range/truncation gates.  Gather cost scales with the index
    count, so this kernel cuts the index count by culling at X-row
    granularity:

      1. For each of the Z*Y grid rows (contiguous [1,1,X] lines, so state
         moves as whole rows — no transpose), bound the row's camera-space
         depth pz (linear in x -> endpoint min/max) and its projected
         pixel-coordinate interval (u, v are Moebius in x with CONSTANT
         derivative sign where pz > 0 -> endpoint bounds are exact).
         Cull the row if (a) entirely behind the camera, (b) its projected
         interval misses the image, or (c) it lies more than the truncation
         T behind every observable depth in its v-footprint — the depth
         bound comes from a per-image-row max table with an RMQ sparse
         table for O(1) range queries.  All tests carry float-safety
         margins, so culling is a strict SUPERSET of the active set and
         the per-voxel result is bit-identical (shared _fuse_voxel_update).
      2. Compact the surviving rows to a STATIC row_capacity (the gather
         index count becomes row_capacity * X), gather their volume-state
         rows, run the exact per-voxel update, scatter the rows back.

    With `seg_x=S` both levels run at X-SEGMENT granularity instead of
    whole rows (row_capacity then counts S-voxel segments): the endpoint
    bounds are exact for any x interval, and segments cut the gather
    index count a further ~25% at 256^3 / ~41% at 512^3 (long rows only
    graze the frustum or the truncation band).

    Returns (new_volume, overflowed): when more rows survive culling than
    row_capacity the update is INCOMPLETE — the caller must retry with a
    larger capacity or the exact kernel (the stream executor surfaces the
    flag per frame; the pipeline re-runs the chunk from its kept pre-chunk
    volume).
    """
    active = _row_activity(
        geom, depth, K, pose, truncation=truncation, zmin=zmin, zmax=zmax,
        seg_x=seg_x)
    if gate is not None:
        active = active & gate
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)
    return _fuse_culled_slab(
        vol, geom, None, geom.dims[2], active, pix_payload, K, pose,
        depth.shape, frame_idx, gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq, row_capacity=row_capacity, seg_x=seg_x,
        rows_impl=rows_impl,
    )


def _fuse_culled_slab(
    vol: GradSdfVolume,       # slab-shaped fields [Zl,Y,X] (Zl = z_rows)
    geom: GridGeometry,
    z0,                       # slab z-offset (None -> 0; traced scalar ok)
    z_rows: int,
    active: jax.Array,        # [Zl,Y] (rows) or [Zl,Y,NS] (segments)
    pix_payload: jax.Array,
    K: jax.Array,
    pose: jax.Array,
    img_hw,
    frame_idx: jax.Array,
    gate,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float,
    row_capacity: int,
    seg_x: Optional[int] = None,
    rows_impl: str = "xla",
    z_map: Optional[jax.Array] = None,  # [z_rows] global z per local plane
                                        # (interleaved slabs; overrides z0)
) -> Tuple[GradSdfVolume, jax.Array]:
    """Level 2 of the culled fusion on a Z-slab: compact active rows (or
    S-voxel X-segments with seg_x — contiguous state slices either way)
    to the static capacity, gather their state slices, run the exact
    per-voxel update, scatter back.  Shared by the single-device kernel
    (z0=None, z_rows=Z) and the shard_map per-slab body.

    rows_impl: state-row movement engine — see fuse_frame_culled_packed."""
    H, W = img_hw
    X, Y = geom.dims[0], geom.dims[1]
    S = X if seg_x is None else seg_x
    NS = X // S
    NSEG = z_rows * Y * NS
    origin = jnp.array(geom.origin, dtype=jnp.float32)
    h = geom.voxel_size

    active_flat = active.reshape(-1)
    n_active = jnp.sum(active_flat.astype(jnp.int32))
    overflow = n_active > row_capacity
    (rows_idx,) = jnp.nonzero(active_flat, size=row_capacity, fill_value=NSEG)
    slot_ok = rows_idx < NSEG
    if rows_impl == "xla":
        safe_rows = jnp.minimum(rows_idx, NSEG - 1)
        row_gate = slot_ok[:, None]
    else:
        # duplicate-first-active padding (see fuse_frame_culled_packed)
        first = jnp.minimum(rows_idx[0], NSEG - 1)
        safe_rows = jnp.where(slot_ok, jnp.minimum(rows_idx, NSEG - 1), first)
        row_gate = None
    if gate is not None:
        row_gate = gate if row_gate is None else (row_gate & gate)

    word = frame_idx // 32
    bit = (jnp.uint32(1) << jnp.uint32(frame_idx % 32))
    vis_word = jax.lax.dynamic_index_in_dim(
        vol.vis.reshape(-1, NSEG, S), word, axis=0, keepdims=False)
    if rows_impl == "xla":
        d_r = jnp.take(vol.dist.reshape(NSEG, S), safe_rows, axis=0)
        g_r = jnp.take(vol.grad.reshape(NSEG, S, 3), safe_rows, axis=0)
        w_r = jnp.take(vol.weight.reshape(NSEG, S), safe_rows, axis=0)
        c_r = jnp.take(vol.color.reshape(NSEG, S, 3), safe_rows, axis=0)
        vw_r = jnp.take(vis_word, safe_rows, axis=0)
    else:
        d_r = _state_rows_gather(vol.dist.reshape(NSEG, S), safe_rows,
                                 rows_impl)
        g_r = _state_rows_gather(vol.grad.reshape(NSEG, S * 3), safe_rows,
                                 rows_impl).reshape(row_capacity, S, 3)
        w_r = _state_rows_gather(vol.weight.reshape(NSEG, S), safe_rows,
                                 rows_impl)
        c_r = _state_rows_gather(vol.color.reshape(NSEG, S * 3), safe_rows,
                                 rows_impl).reshape(row_capacity, S, 3)
        vw_r = _state_rows_gather(vis_word, safe_rows, "xla2d")

    rz_l = safe_rows // (Y * NS)                          # [A] slab-local z
    if z_map is not None:
        rz = z_map[jnp.minimum(rz_l, z_rows - 1)].astype(jnp.float32)
    else:
        rz = rz_l.astype(jnp.float32)
        if z0 is not None:
            rz = rz + z0.astype(jnp.float32)
    ry = ((safe_rows // NS) % Y).astype(jnp.float32)
    rx0 = (safe_rows % NS).astype(jnp.float32) * S        # segment x origin
    rx = rx0[:, None] + jnp.arange(S, dtype=jnp.float32)[None, :]
    p_w = jnp.stack(
        [origin[0] + h * rx,
         origin[1] + h * jnp.broadcast_to(ry[:, None], (row_capacity, S)),
         origin[2] + h * jnp.broadcast_to(rz[:, None], (row_capacity, S))],
        axis=-1)

    nd, ng, nw, nc, vis_or = _fuse_voxel_update(
        p_w, d_r, g_r, w_r, c_r, pix_payload, K, pose, (H, W), bit, row_gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq,
    )
    nvw = vw_r | vis_or

    if rows_impl == "xla":
        # scatter slices back (fill index NSEG out of range -> mode='drop')
        new_dist = vol.dist.reshape(NSEG, S).at[rows_idx].set(
            nd, mode="drop").reshape(vol.dist.shape)
        new_grad = vol.grad.reshape(NSEG, S, 3).at[rows_idx].set(
            ng, mode="drop").reshape(vol.grad.shape)
        new_weight = vol.weight.reshape(NSEG, S).at[rows_idx].set(
            nw, mode="drop").reshape(vol.weight.shape)
        new_color = vol.color.reshape(NSEG, S, 3).at[rows_idx].set(
            nc, mode="drop").reshape(vol.color.shape)
        new_vis_word = vis_word.at[rows_idx].set(nvw, mode="drop")
    else:
        new_dist = _state_rows_scatter(
            vol.dist.reshape(NSEG, S), safe_rows, nd, rows_impl
        ).reshape(vol.dist.shape)
        new_grad = _state_rows_scatter(
            vol.grad.reshape(NSEG, S * 3), safe_rows,
            ng.reshape(row_capacity, S * 3), rows_impl).reshape(vol.grad.shape)
        new_weight = _state_rows_scatter(
            vol.weight.reshape(NSEG, S), safe_rows, nw, rows_impl
        ).reshape(vol.weight.shape)
        new_color = _state_rows_scatter(
            vol.color.reshape(NSEG, S * 3), safe_rows,
            nc.reshape(row_capacity, S * 3), rows_impl
        ).reshape(vol.color.shape)
        new_vis_word = _state_rows_scatter(vis_word, safe_rows, nvw, "xla2d")
    new_vis = jax.lax.dynamic_update_index_in_dim(
        vol.vis.reshape(-1, NSEG, S), new_vis_word, word, axis=0
    ).reshape(vol.vis.shape)

    return (
        GradSdfVolume(dist=new_dist, grad=new_grad, weight=new_weight,
                      color=new_color, vis=new_vis),
        overflow,
    )


def _fuse_frames_batched_core(
    p_w: jax.Array,          # [CAP,S,3] voxel-center world coords
    d_r, g_r, w_r, c_r,      # gathered state rows [CAP,S]/[CAP,S,3]
    colors, depths, normals, n_sq_invs,   # stacked frames [K,...]
    K: jax.Array,
    poses: jax.Array,        # [K,4,4]
    frame_ids: jax.Array,    # [K] int32, ascending, spanning <= 2 vis words
    gates,                   # [K] bool or None
    slot_ok: jax.Array,      # [CAP] bool (capacity padding slots)
    img_hw: Tuple[int, int],
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float,
):
    """Apply K frames' per-voxel fusion updates to once-gathered state rows.

    The reference's per-voxel update (VolumetricGradSdf.cpp:121-131) is a
    weighted running mean + OR'd visibility, so applying the K per-frame
    updates IN ORDER on the gathered rows is arithmetically identical —
    bit-identical, same op order — to K sequential fuse_frame calls, while
    the state rows move between HBM and the kernel once instead of K times
    (VERDICT round-3 #3).  A row in the union cull set but inactive for
    frame k passes no per-voxel gate for k (the cull is a conservative
    superset per frame), so its frame-k update is the identity.

    Visibility bits accumulate into at most TWO words (acc_lo for
    frame_ids[0]'s word, acc_hi for the next); bits for frames outside
    that span are DROPPED — callers pass consecutive ids (the returned
    `bad_words` flag reports violations).

    Returns ((d,g,w,c), acc_lo, acc_hi, word_lo, bad_words)."""
    KF = depths.shape[0]
    word_lo = frame_ids[0] // 32
    ws = frame_ids // 32
    bad_words = jnp.any((ws != word_lo) & (ws != word_lo + 1))

    def body(k, carry):
        d, g, w, c, acc_lo, acc_hi = carry
        pixp = pack_pixel_payload(colors[k], depths[k], normals[k],
                                  n_sq_invs[k])
        fid = frame_ids[k]
        bit = jnp.uint32(1) << jnp.uint32(fid % 32)
        row_gate = slot_ok[:, None]
        if gates is not None:
            row_gate = row_gate & gates[k]
        nd, ng, nw, nc, vis_or = _fuse_voxel_update(
            p_w, d, g, w, c, pixp, K, poses[k], img_hw, bit, row_gate,
            truncation=truncation, zmin=zmin, zmax=zmax,
            cos_thresh_sq=cos_thresh_sq,
        )
        in_lo = (fid // 32) == word_lo
        acc_lo = acc_lo | jnp.where(in_lo, vis_or, jnp.uint32(0))
        acc_hi = acc_hi | jnp.where(in_lo, jnp.uint32(0), vis_or)
        return nd, ng, nw, nc, acc_lo, acc_hi

    zero_u32 = jnp.zeros(d_r.shape, jnp.uint32)
    d, g, w, c, acc_lo, acc_hi = jax.lax.fori_loop(
        0, KF, body, (d_r, g_r, w_r, c_r, zero_u32, zero_u32))
    return (d, g, w, c), acc_lo, acc_hi, word_lo, bad_words


@functools.partial(
    jax.jit,
    static_argnames=(
        "geom", "truncation", "zmin", "zmax", "cos_thresh_sq", "row_capacity",
    ),
)
def fuse_frames_culled(
    vol: GradSdfVolume,
    geom: GridGeometry,
    colors: jax.Array,      # [K,H,W,3]
    depths: jax.Array,      # [K,H,W]
    normals: jax.Array,     # [K,H,W,3]
    n_sq_invs: jax.Array,   # [K,H,W]
    K: jax.Array,
    poses: jax.Array,       # [K,4,4]
    frame_ids: jax.Array,   # [K] int32 ascending, spanning <= 2 vis words
    gates: Optional[jax.Array] = None,   # [K] bool
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    row_capacity: int,
) -> Tuple[GradSdfVolume, jax.Array]:
    """K-frame batched row-culled fusion: bit-identical to K sequential
    fuse_frame_culled calls (shared _fuse_voxel_update applied per frame in
    order), with ONE state-row gather/scatter for the whole batch.

    The cull is the UNION of the per-frame level-1 row culls, so
    row_capacity must cover the union (overflow flag otherwise — also set
    if frame_ids span more than two visibility words).

    This is the GT-pose fusion fast path (main_ps.cpp:216-220: fusion at
    given poses, no tracker feedback between frames).  Under tracking the
    per-frame kernel remains the product path — fusing a chunk at once
    would give the tracker a K-frame-stale map."""
    X, Y, Zd = geom.dims
    S = X
    NSEG = Zd * Y
    H, W = depths.shape[1], depths.shape[2]

    def act_k(d, p, g):
        a = _row_activity(geom, d, K, p, truncation=truncation, zmin=zmin,
                          zmax=zmax)
        return a & g if g is not None else a

    if gates is not None:
        acts = jax.vmap(act_k)(depths, poses, gates)
    else:
        acts = jax.vmap(lambda d, p: act_k(d, p, None))(depths, poses)
    active = jnp.any(acts, axis=0)

    active_flat = active.reshape(-1)
    n_active = jnp.sum(active_flat.astype(jnp.int32))
    overflow = n_active > row_capacity
    (rows_idx,) = jnp.nonzero(active_flat, size=row_capacity, fill_value=NSEG)
    slot_ok = rows_idx < NSEG
    safe_rows = jnp.minimum(rows_idx, NSEG - 1)

    d_r = jnp.take(vol.dist.reshape(NSEG, S), safe_rows, axis=0)
    g_r = jnp.take(vol.grad.reshape(NSEG, S, 3), safe_rows, axis=0)
    w_r = jnp.take(vol.weight.reshape(NSEG, S), safe_rows, axis=0)
    c_r = jnp.take(vol.color.reshape(NSEG, S, 3), safe_rows, axis=0)

    p_w = _row_world_coords(geom, safe_rows, None, S, 1, row_capacity)

    (nd, ng, nw, nc), acc_lo, acc_hi, word_lo, bad_words = (
        _fuse_frames_batched_core(
            p_w, d_r, g_r, w_r, c_r, colors, depths, normals, n_sq_invs,
            K, poses, frame_ids, gates, slot_ok, (H, W),
            truncation=truncation, zmin=zmin, zmax=zmax,
            cos_thresh_sq=cos_thresh_sq,
        ))

    new_dist = vol.dist.reshape(NSEG, S).at[rows_idx].set(
        nd, mode="drop").reshape(vol.dist.shape)
    new_grad = vol.grad.reshape(NSEG, S, 3).at[rows_idx].set(
        ng, mode="drop").reshape(vol.grad.shape)
    new_weight = vol.weight.reshape(NSEG, S).at[rows_idx].set(
        nw, mode="drop").reshape(vol.weight.shape)
    new_color = vol.color.reshape(NSEG, S, 3).at[rows_idx].set(
        nc, mode="drop").reshape(vol.color.shape)

    vis3 = vol.vis.reshape(-1, NSEG, S)
    n_words = vis3.shape[0]
    w_hi = jnp.minimum(word_lo + 1, n_words - 1)
    vw_lo = jnp.take(jax.lax.dynamic_index_in_dim(
        vis3, word_lo, axis=0, keepdims=False), safe_rows, axis=0)
    vw_hi = jnp.take(jax.lax.dynamic_index_in_dim(
        vis3, w_hi, axis=0, keepdims=False), safe_rows, axis=0)
    new_lo = vw_lo | acc_lo
    # when w_hi clamps onto word_lo the hi write must repeat the lo content,
    # not resurrect the pre-update row (acc_hi is provably 0 there only if
    # the caller's ids were in range — don't rely on it)
    new_hi = jnp.where(w_hi == word_lo, new_lo, vw_hi | acc_hi)
    plane_lo = jax.lax.dynamic_index_in_dim(
        vis3, word_lo, axis=0, keepdims=False).at[rows_idx].set(
        new_lo, mode="drop")
    vis3 = jax.lax.dynamic_update_index_in_dim(vis3, plane_lo, word_lo, axis=0)
    plane_hi = jax.lax.dynamic_index_in_dim(
        vis3, w_hi, axis=0, keepdims=False).at[rows_idx].set(
        new_hi, mode="drop")
    vis3 = jax.lax.dynamic_update_index_in_dim(vis3, plane_hi, w_hi, axis=0)
    new_vis = vis3.reshape(vol.vis.shape)

    return (
        GradSdfVolume(dist=new_dist, grad=new_grad, weight=new_weight,
                      color=new_color, vis=new_vis),
        overflow | bad_words,
    )


def _row_world_coords(geom: GridGeometry, safe_rows: jax.Array, z0, S: int,
                      NS: int, capacity: int) -> jax.Array:
    """World coordinates [CAP,S,3] of the voxels in compacted rows/segments
    (the shared index arithmetic of the culled kernels)."""
    X, Y = geom.dims[0], geom.dims[1]
    origin = jnp.array(geom.origin, dtype=jnp.float32)
    h = geom.voxel_size
    rz = (safe_rows // (Y * NS)).astype(jnp.float32)
    if z0 is not None:
        rz = rz + z0.astype(jnp.float32)
    ry = ((safe_rows // NS) % Y).astype(jnp.float32)
    rx0 = (safe_rows % NS).astype(jnp.float32) * S
    rx = rx0[:, None] + jnp.arange(S, dtype=jnp.float32)[None, :]
    return jnp.stack(
        [origin[0] + h * rx,
         origin[1] + h * jnp.broadcast_to(ry[:, None], (capacity, S)),
         origin[2] + h * jnp.broadcast_to(rz[:, None], (capacity, S))],
        axis=-1)


class PackedVolume(NamedTuple):
    """Gather-native volume state for the streaming (track+fuse) hot path.

    Two reasons this layout exists:

    1. The tracker's per-pixel gather wants one row-gatherable [V,8] table
       of (dist, grad, weight) — with the SoA GradSdfVolume layout that
       table had to be re-concatenated from the volume arrays on every
       track_frame call (pack_tracking_payload).
    2. When the volume state is a program OUTPUT, XLA can pin the loop
       carry to boundary layouts and copy it every iteration.  The
       streaming consumers therefore keep the state INSIDE one program
       (nested chunk loops, scalar outputs — see bench.py's run_chunks).

        payload [Z,Y,X,8] f32:  dist, grad(3), weight, color(3)
        vis     [W,Z,Y,X] u32:  bit-packed per-frame visibility

    Slots 0,1:4,4 line up with pack_tracking_payload's layout, so
    sdf_records_packed / track_frame consume `payload.reshape(-1,8)`
    unchanged; slots 5:8 carry the running-mean color.  Convert at phase
    boundaries (scan start / refinement handoff) with from_volume /
    to_volume."""

    payload: jax.Array   # [Z,Y,X,8] f32
    vis: jax.Array       # [W,Z,Y,X] uint32

    @classmethod
    def from_volume(cls, vol: "GradSdfVolume") -> "PackedVolume":
        payload = jnp.concatenate(
            [vol.dist[..., None], vol.grad, vol.weight[..., None], vol.color],
            axis=-1)
        return cls(payload=payload, vis=vol.vis)

    def to_volume(self) -> "GradSdfVolume":
        p = self.payload
        return GradSdfVolume(
            dist=p[..., 0], grad=p[..., 1:4], weight=p[..., 4],
            color=p[..., 5:8], vis=self.vis)


@functools.partial(
    jax.jit,
    static_argnames=(
        "geom", "truncation", "zmin", "zmax", "cos_thresh_sq",
        "row_capacity", "seg_x", "rows_impl",
    ),
)
def fuse_frame_culled_packed(
    pvol: PackedVolume,
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
    row_capacity: int,
    seg_x: Optional[int] = None,
    rows_impl: str = "xla",
) -> Tuple[PackedVolume, jax.Array]:
    """fuse_frame_culled on PackedVolume state: identical level-1 cull and
    per-voxel math (shared _row_activity / _fuse_voxel_update), but the
    level-2 gather/scatter moves ONE [CAP, S, 8] row table instead of four
    separate state arrays — and leaves the tracking payload up to date for
    free (see PackedVolume).  seg_x: X-segment culling granularity (see
    fuse_frame_culled).

    rows_impl selects the state-row movement engine (_state_rows_gather):
    "xla" (inline take/set — XLA fuses the update into the movement) or
    "xla2d" (barrier-fenced 2-D row copy).  Both are bit-identical: the
    "xla2d" impl pads capacity slots by DUPLICATING the first compacted
    row (computing its update twice) instead of gating them off, so every
    scatter of a duplicated index writes identical bytes."""
    active = _row_activity(
        geom, depth, K, pose, truncation=truncation, zmin=zmin, zmax=zmax,
        seg_x=seg_x)
    if gate is not None:
        active = active & gate
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)

    H, W = depth.shape
    X, Y, Zd = geom.dims
    S = X if seg_x is None else seg_x
    NS = X // S
    NSEG = Zd * Y * NS
    origin = jnp.array(geom.origin, dtype=jnp.float32)
    h = geom.voxel_size

    active_flat = active.reshape(-1)
    n_active = jnp.sum(active_flat.astype(jnp.int32))
    overflow = n_active > row_capacity
    (rows_idx,) = jnp.nonzero(active_flat, size=row_capacity, fill_value=NSEG)
    slot_ok = rows_idx < NSEG
    if rows_impl == "xla":
        safe_rows = jnp.minimum(rows_idx, NSEG - 1)
        row_gate = slot_ok[:, None]
    else:
        # duplicate-first-active padding: padded slots mirror the first
        # compacted row, compute its update again (identical bytes), and
        # scatter it again — so the scatter needs no drop mode and the
        # movement stays a pure indexed row copy
        first = jnp.minimum(rows_idx[0], NSEG - 1)
        safe_rows = jnp.where(slot_ok, jnp.minimum(rows_idx, NSEG - 1), first)
        row_gate = None
    if gate is not None:
        row_gate = gate if row_gate is None else (row_gate & gate)

    state3 = pvol.payload.reshape(NSEG, S, 8)   # internal view; boundary
    word = frame_idx // 32
    bit = (jnp.uint32(1) << jnp.uint32(frame_idx % 32))
    vis_word = jax.lax.dynamic_index_in_dim(
        pvol.vis.reshape(-1, NSEG, S), word, axis=0, keepdims=False)
    if rows_impl == "xla":
        rows = jnp.take(state3, safe_rows, axis=0)        # [CAP, S, 8]
        vw_r = jnp.take(vis_word, safe_rows, axis=0)
    else:
        rows = _state_rows_gather(
            pvol.payload.reshape(NSEG, S * 8), safe_rows, rows_impl
        ).reshape(row_capacity, S, 8)
        # vis rows are 1/9 of the bytes; the 2-D barrier copy suffices
        vw_r = _state_rows_gather(vis_word, safe_rows, "xla2d")

    rz = (safe_rows // (Y * NS)).astype(jnp.float32)
    ry = ((safe_rows // NS) % Y).astype(jnp.float32)
    rx0 = (safe_rows % NS).astype(jnp.float32) * S
    rx = rx0[:, None] + jnp.arange(S, dtype=jnp.float32)[None, :]
    p_w = jnp.stack(
        [origin[0] + h * rx,
         origin[1] + h * jnp.broadcast_to(ry[:, None], (row_capacity, S)),
         origin[2] + h * jnp.broadcast_to(rz[:, None], (row_capacity, S))],
        axis=-1)

    nd, ng, nw, nc, vis_or = _fuse_voxel_update(
        p_w, rows[..., 0], rows[..., 1:4], rows[..., 4], rows[..., 5:8],
        pix_payload, K, pose, (H, W), bit, row_gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq,
    )
    new_rows = jnp.concatenate(
        [nd[..., None], ng, nw[..., None], nc], axis=-1)
    nvw = vw_r | vis_or

    if rows_impl == "xla":
        new_payload = state3.at[rows_idx].set(
            new_rows, mode="drop").reshape(pvol.payload.shape)
        new_vis_word = vis_word.at[rows_idx].set(nvw, mode="drop")
    else:
        new_payload = _state_rows_scatter(
            pvol.payload.reshape(NSEG, S * 8), safe_rows,
            new_rows.reshape(row_capacity, S * 8), rows_impl
        ).reshape(pvol.payload.shape)
        new_vis_word = _state_rows_scatter(vis_word, safe_rows, nvw, "xla2d")
    new_vis = jax.lax.dynamic_update_index_in_dim(
        pvol.vis.reshape(-1, NSEG, S), new_vis_word, word, axis=0
    ).reshape(pvol.vis.shape)

    return PackedVolume(payload=new_payload, vis=new_vis), overflow


def vis_bit(vis: jax.Array, frame_idx) -> jax.Array:
    """Extract boolean visibility of frame `frame_idx` -> [Z,Y,X] bool."""
    word = frame_idx // 32
    bit = jnp.uint32(1) << jnp.uint32(frame_idx % 32)
    return (vis[word] & bit) != 0


def vis_count(vis: jax.Array) -> jax.Array:
    """Number of frames each voxel was seen in -> [Z,Y,X] int32."""
    counts = jax.lax.population_count(vis)
    return jnp.sum(counts, axis=0).astype(jnp.int32)


def pack_tracking_payload(vol: GradSdfVolume) -> jax.Array:
    """Pack (dist, grad, weight) into one flat [V,8] row-gatherable payload.

    One row-gather fetches a full voxel record instead of three separate
    gathers with three index streams."""
    zyx = vol.dist.shape
    return jnp.concatenate(
        [
            vol.dist[..., None],
            vol.grad,
            vol.weight[..., None],
            jnp.zeros(zyx + (3,), dtype=vol.dist.dtype),
        ],
        axis=-1,
    ).reshape(-1, 8)


def sdf_records_packed(
    payload_flat: jax.Array, geom: GridGeometry, pts: jax.Array
):
    """Nearest-voxel records at pts from a pack_tracking_payload buffer
    (ONE row-gather): (d, ghat, c_v, w, valid) — the pieces of the
    Gradient-SDF query (VolumetricGradSdf.h:76-93) before psi evaluation.
    Shared by sdf_query_packed and the tracker's frozen-correspondence
    rounds (tracking/tracker.py)."""
    idx, valid = geom.nearest_info(pts)
    X, Y = geom.dims[0], geom.dims[1]
    lin = (idx[..., 2] * Y + idx[..., 1]) * X + idx[..., 0]
    rows = jnp.take(payload_flat, lin, axis=0)
    d = rows[..., 0]
    g = rows[..., 1:4]
    w = rows[..., 4]
    gnorm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    ghat = g / jnp.maximum(gnorm, 1e-12)
    c_v = geom.voxel2world(idx)
    return d, ghat, c_v, w, valid


def sdf_query_packed(
    payload_flat: jax.Array, geom: GridGeometry, pts: jax.Array, truncation: float
):
    """sdf_query against a pack_tracking_payload buffer (one gather)."""
    d, ghat, c_v, w, valid = sdf_records_packed(payload_flat, geom, pts)
    psi = d + jnp.sum(ghat * (c_v - pts), axis=-1)
    psi = jnp.where(valid, psi, truncation)
    ghat = jnp.where(valid[..., None], ghat, 0.0)
    w = jnp.where(valid, w, 0.0)
    return psi, ghat, w, valid


def sdf_query(
    vol: GradSdfVolume, geom: GridGeometry, pts: jax.Array, truncation: float
):
    """Gradient-SDF point query (VolumetricGradSdf.h:76-93).

    psi(p) = dist[v] + ghat . (c_v - p) for the *nearest* voxel v (no
    trilerp — first-order extrapolation along the stored gradient).
    Returns (psi, ghat, weight, valid)."""
    idx, valid = geom.nearest_info(pts)
    d = vol.dist[idx[..., 2], idx[..., 1], idx[..., 0]]
    g = vol.grad[idx[..., 2], idx[..., 1], idx[..., 0]]
    w = vol.weight[idx[..., 2], idx[..., 1], idx[..., 0]]
    gnorm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    ghat = g / jnp.maximum(gnorm, 1e-12)
    c_v = geom.voxel2world(idx)
    psi = d + jnp.sum(ghat * (c_v - pts), axis=-1)
    psi = jnp.where(valid, psi, truncation)
    ghat = jnp.where(valid[..., None], ghat, 0.0)
    w = jnp.where(valid, w, 0.0)
    return psi, ghat, w, valid


def surface_band_mask(vol: GradSdfVolume, voxel_size: float) -> jax.Array:
    """Surface-band voxels: |dist| <= sqrt(3)*h and seen in >= 1 frame
    (OptimizerAux.cpp:237-257)."""
    band = jnp.abs(vol.dist) <= jnp.sqrt(3.0) * voxel_size
    seen = vis_count(vol.vis) >= 1
    return band & seen


def subsample_dist(dist: jax.Array, grad: jax.Array, voxel_size: float) -> jax.Array:
    """8-child distance subdivision d +- (h/4)(+-gx +-gy +-gz)
    (VolumetricGradSdf.cpp:469-494). Returns [Z,Y,X,2,2,2] child distances
    ordered child index (dz,dy,dx) in {0,1}."""
    g = grad / jnp.maximum(jnp.linalg.norm(grad, axis=-1, keepdims=True), 1e-12)
    h4 = 0.25 * voxel_size
    signs = jnp.array([-1.0, 1.0], dtype=jnp.float32)
    # offsets[dz,dy,dx] = sx*gx + sy*gy + sz*gz
    sx = signs.reshape(1, 1, 2)
    sy = signs.reshape(1, 2, 1)
    sz = signs.reshape(2, 1, 1)
    off = (
        sx * g[..., None, None, None, 0]
        + sy * g[..., None, None, None, 1]
        + sz * g[..., None, None, None, 2]
    )
    return dist[..., None, None, None] + h4 * off
