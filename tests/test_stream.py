"""Chunked on-device frame loop (tracking/stream.py) vs the sequential
per-frame path: identical volumes, poses, and flags, including ragged-tail
padding and GT mode."""

import numpy as np
import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import fuse_frame, make_volume
from psgradientsdf.ops.normals import build_fals_cache, compute_normals
from psgradientsdf.tracking.stream import process_chunk
from psgradientsdf.tracking.tracker import track_frame

H, W, DIM = 48, 64, 32


def make_frames(n):
    f = 55.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cols = np.arange(W, dtype=np.float32)[None, :]
    rows = np.arange(H, dtype=np.float32)[:, None]
    x0 = (cols - W / 2) / f
    y0 = (rows - H / 2) / f
    frames = []
    for i in range(n):
        ph = 0.03 * i
        depth = (1.1 + 0.12 * np.sin(5 * x0 + ph) * np.cos(4 * y0)).astype(np.float32)
        color = np.stack([
            np.broadcast_to(0.5 + 0.3 * np.sin(7 * x0 + ph), depth.shape),
            np.broadcast_to(0.5 + 0.2 * np.cos(5 * y0), depth.shape),
            np.full_like(depth, 0.5)], -1).astype(np.float32)
        frames.append((color, depth))
    return K, frames


def setup(n):
    K, frames = make_frames(n)
    geom = GridGeometry(dims=(DIM, DIM, DIM), voxel_size=0.04, shift=(0.0, 0.0, 1.1))
    T = 5 * 0.04
    fals = build_fals_cache(H, W, K, window=11)
    vol = make_volume(geom, T, frame_cap=32)
    kw = dict(truncation=T, zmin=0.3, zmax=3.0)
    # seed the volume with frame 0 at identity
    n0 = compute_normals(jnp.asarray(frames[0][1]), fals)
    vol = fuse_frame(vol, geom, jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]),
                     n0, fals.n_sq_inv, jnp.asarray(K), jnp.eye(4, dtype=jnp.float32),
                     jnp.int32(0), **kw)
    return K, frames, geom, T, fals, vol, kw


def run_sequential(K, frames, geom, T, fals, vol, kw, track_kw):
    pose = jnp.eye(4, dtype=jnp.float32)
    poses, convs = [], []
    for j, (color, depth) in enumerate(frames[1:], start=1):
        res = track_frame(vol, geom, jnp.asarray(depth), jnp.asarray(K), pose,
                          **kw, **track_kw)
        pose = res.pose
        if bool(res.converged):
            nrm = compute_normals(jnp.asarray(depth), fals)
            vol = fuse_frame(vol, geom, jnp.asarray(color), jnp.asarray(depth),
                             nrm, fals.n_sq_inv, jnp.asarray(K), pose,
                             jnp.int32(j), **kw)
        poses.append(np.asarray(pose))
        convs.append(bool(res.converged))
    return vol, poses, convs


def test_chunk_matches_sequential():
    n = 5
    K, frames, geom, T, fals, vol, kw = setup(n)
    track_kw = dict(num_iterations=10, conv_threshold_sq=1e-12, damping=1.0)

    vol_seq, poses_seq, convs_seq = run_sequential(
        K, frames, geom, T, fals, vol, kw, track_kw)

    C = 6  # chunk larger than the 4 remaining frames -> exercises padding
    colors = np.stack([f[0] for f in frames[1:]] + [frames[-1][0]] * (C - (n - 1)))
    depths = np.stack([f[1] for f in frames[1:]] + [frames[-1][1]] * (C - (n - 1)))
    fids = np.array([1, 2, 3, 4, 0, 0], np.int32)
    valid = np.array([True] * (n - 1) + [False] * (C - (n - 1)))
    gtp = np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4))
    vol_c, res = process_chunk(
        vol, geom, jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K),
        jnp.eye(4, dtype=jnp.float32), jnp.asarray(fids), jnp.asarray(valid),
        jnp.asarray(gtp), fals, **kw, **track_kw, use_gt=False,
    )

    for a, b in zip(vol_seq, vol_c):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    conv_c = np.asarray(res.converged)
    poses_c = np.asarray(res.poses)
    for j in range(n - 1):
        assert conv_c[j] == convs_seq[j]
        np.testing.assert_allclose(poses_c[j], poses_seq[j], rtol=1e-5, atol=1e-6)
    # padding frames: pose frozen at the last real pose, nothing fused
    assert not conv_c[n - 1 :].any()
    np.testing.assert_array_equal(poses_c[-1], poses_c[n - 2])


def test_chunk_gt_mode():
    n = 4
    K, frames, geom, T, fals, vol, kw = setup(n)

    # sequential GT fusion
    gt_list = []
    for j in range(1, n):
        p = np.eye(4, dtype=np.float32)
        p[:3, 3] = [0.002 * j, -0.001 * j, 0.0]
        gt_list.append(p)
    vol_seq = vol
    for j, (color, depth) in enumerate(frames[1:], start=1):
        nrm = compute_normals(jnp.asarray(depth), fals)
        vol_seq = fuse_frame(vol_seq, geom, jnp.asarray(color), jnp.asarray(depth),
                             nrm, fals.n_sq_inv, jnp.asarray(K),
                             jnp.asarray(gt_list[j - 1]), jnp.int32(j), **kw)

    C = n - 1
    colors = np.stack([f[0] for f in frames[1:]])
    depths = np.stack([f[1] for f in frames[1:]])
    fids = np.arange(1, n, dtype=np.int32)
    valid = np.ones(C, bool)
    vol_c, res = process_chunk(
        vol, geom, jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(K),
        jnp.eye(4, dtype=jnp.float32), jnp.asarray(fids), jnp.asarray(valid),
        jnp.asarray(np.stack(gt_list)), fals, **kw, use_gt=True,
    )
    for a, b in zip(vol_seq, vol_c):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.poses), np.stack(gt_list), atol=1e-7)
    assert np.asarray(res.fused).all()


def test_chunk_raw_wire_matches_float():
    """uint8/uint16 raw-wire chunks must produce the same volume and poses
    as pre-converted float frames."""
    import numpy as np
    import jax.numpy as jnp
    from psgradientsdf.core.grid import GridGeometry
    from psgradientsdf.core.volume import make_volume
    from psgradientsdf.ops.normals import build_fals_cache
    from psgradientsdf.tracking.stream import process_chunk

    rng = np.random.default_rng(11)
    H, W, C = 32, 40, 3
    unit = 1.0 / 5000.0
    depth_u16 = rng.integers(3000, 12000, (C, H, W)).astype(np.uint16)
    color_u8 = rng.integers(0, 256, (C, H, W, 3)).astype(np.uint8)
    depth_f = depth_u16.astype(np.float32) * unit
    color_f = color_u8.astype(np.float32) / 255.0

    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    fals = build_fals_cache(H, W, K, window=11)
    geom = GridGeometry(dims=(16, 16, 16), voxel_size=0.1, shift=(0, 0, 1.5))
    vol = make_volume(geom, 0.5, frame_cap=32)
    eye = jnp.eye(4, dtype=jnp.float32)
    gtp = jnp.asarray(np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4)))
    args = dict(K=jnp.asarray(K), init_pose=eye,
                frame_ids=jnp.arange(C, dtype=jnp.int32),
                valid=jnp.ones(C, bool), gt_poses=gtp, fals=fals)
    kw = dict(truncation=0.5, zmin=0.1, zmax=5.0, num_iterations=3,
              conv_threshold_sq=1e-12, damping=1.0, use_gt=True)

    v_raw, r_raw = process_chunk(vol, geom, jnp.asarray(color_u8),
                                 jnp.asarray(depth_u16), depth_unit=unit,
                                 **args, **kw)
    v_f, r_f = process_chunk(vol, geom, jnp.asarray(color_f),
                             jnp.asarray(depth_f), depth_unit=1.0,
                             **args, **kw)
    np.testing.assert_allclose(np.asarray(v_raw.dist), np.asarray(v_f.dist),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(v_raw.color), np.asarray(v_f.color),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(v_raw.vis), np.asarray(v_f.vis))
    np.testing.assert_allclose(np.asarray(r_raw.poses), np.asarray(r_f.poses),
                               rtol=0, atol=0)
