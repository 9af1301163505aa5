"""Multi-chip Z-slab scan: the facts its scaling rests on, pinned.

Three facts, each checked here on the 8-device virtual CPU mesh:

  1. the interleaved-Z plane assignment is EXACT — sharded fusion on the
     strided layout matches the single-device culled kernel bit-for-bit,
     and the sharded tracker matches the single-device pose;
  2. interleaving balances the per-chip cull counts on the bench frustum
     (contiguous slabs are several-fold skewed);
  3. the compiled sharded scan step's communication volume is KBs per
     frame (fusion: ONE scalar overflow psum, zero volume-sized
     collectives; tracking: one 8x8 Gram psum per GN iteration) — parsed
     from the post-GSPMD HLO by parallel/hlo_comm.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import (
    _row_activity, fuse_frame_culled, make_volume,
)
from psgradientsdf.parallel import shard
from psgradientsdf.parallel.hlo_comm import collective_bytes
from psgradientsdf.parallel.mesh import (
    deinterleave_volume, interleave_volume, make_mesh, shard_volume,
)
from psgradientsdf.tracking.tracker import track_frame


def _scene(W=64, H=48):
    f = 0.9 * W
    cx, cy = W / 2.0, H / 2.0
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    x0 = np.broadcast_to((u - cx) / f, (H, W))
    y0 = np.broadcast_to((v - cy) / f, (H, W))
    depth = (1.2 + 0.08 * np.sin(6 * x0) * np.cos(5 * y0)
             + 0.05 * np.sin(3 * (x0 + y0))).astype(np.float32)
    dgx = 0.08 * 6 * np.cos(6 * x0) * np.cos(5 * y0) \
        + 0.15 * np.cos(3 * (x0 + y0))
    dgy = -0.08 * 5 * np.sin(6 * x0) * np.sin(5 * y0) \
        + 0.15 * np.cos(3 * (x0 + y0))
    n = np.stack([-dgx, -dgy, np.ones_like(dgx)], axis=-1)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    nsq = (1.0 / (1.0 + x0 ** 2 + y0 ** 2)).astype(np.float32)
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], dtype=np.float32)
    return K, depth, n, nsq


@pytest.fixture(scope="module")
def mesh8z():
    return make_mesh(8, 1)


def test_interleaved_fusion_bit_identical(mesh8z):
    DIM = 64
    h = 1.8 / DIM
    T = 5 * h
    geom = GridGeometry(dims=(DIM,) * 3, voxel_size=h, shift=(0.0, 0.0, 1.2))
    kw = dict(truncation=T, zmin=0.5, zmax=3.5)
    K_np, depth_np, n_np, nsq_np = _scene()
    K = jnp.asarray(K_np)
    depth = jnp.asarray(depth_np)
    color = jnp.full(depth.shape + (3,), 0.5, dtype=jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)

    vol0 = make_volume(geom, T, frame_cap=32)
    ref, ov_ref = fuse_frame_culled(
        vol0, geom, color, depth, jnp.asarray(n_np), jnp.asarray(nsq_np),
        K, eye, jnp.int32(3), **kw, row_capacity=DIM * DIM)
    assert not bool(ov_ref)

    fuse_il = jax.jit(shard.sharded_fuse_frame_culled_fn(
        mesh8z, geom, **kw, row_capacity=DIM * DIM // 8, interleave_z=True))
    vol_il = shard_volume(interleave_volume(vol0, 8), mesh8z)
    out_il, ov = fuse_il(vol_il, color, depth, jnp.asarray(n_np),
                         jnp.asarray(nsq_np), K, eye, jnp.int32(3))
    assert not bool(ov)
    got = deinterleave_volume(out_il, 8)
    np.testing.assert_array_equal(np.asarray(got.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(np.asarray(got.weight),
                                  np.asarray(ref.weight))
    np.testing.assert_array_equal(np.asarray(got.grad), np.asarray(ref.grad))
    np.testing.assert_array_equal(np.asarray(got.vis), np.asarray(ref.vis))


def test_interleaved_tracker_matches_single_device(mesh8z):
    DIM = 64
    h = 1.8 / DIM
    T = 5 * h
    geom = GridGeometry(dims=(DIM,) * 3, voxel_size=h, shift=(0.0, 0.0, 1.2))
    kw = dict(truncation=T, zmin=0.5, zmax=3.5)
    K_np, depth_np, n_np, nsq_np = _scene()
    K = jnp.asarray(K_np)
    depth = jnp.asarray(depth_np)
    color = jnp.full(depth.shape + (3,), 0.5, dtype=jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)

    vol, _ = fuse_frame_culled(
        make_volume(geom, T, frame_cap=32), geom, color, depth,
        jnp.asarray(n_np), jnp.asarray(nsq_np), K, eye, jnp.int32(0), **kw,
        row_capacity=DIM * DIM)

    off = np.eye(4, dtype=np.float32)
    off[:3, 3] = [0.004, -0.003, 0.005]
    tkw = dict(num_iterations=6, conv_threshold_sq=1e-12, damping=1.0,
               early_exit=False, regather_every=3)
    res_ref = track_frame(vol, geom, depth, K, jnp.asarray(off), **kw, **tkw)

    trk = shard.make_sharded_tracker(mesh8z, geom, depth.shape, **kw, **tkw,
                                     interleave_z=True)
    vol_il = shard_volume(interleave_volume(vol, 8), mesh8z)
    res_il = trk(vol_il, depth, K, jnp.asarray(off))
    # identical step semantics; the Gram psum reassociates the f32 sums
    np.testing.assert_allclose(np.asarray(res_il.pose),
                               np.asarray(res_ref.pose), atol=1e-5)
    assert int(res_il.num_valid) > 0


def test_interleave_balances_bench_frustum():
    """Load balance: on the 512^3 bench frustum,
    contiguous Z-slabs are several-fold skewed while strided assignment
    is near-uniform."""
    DIM = 512
    h = 1.8 / DIM
    geom = GridGeometry(dims=(DIM,) * 3, voxel_size=h, shift=(0.0, 0.0, 1.2))
    W, H = 640, 480
    f = 0.9 * W
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    x0 = (u - W / 2.0) / f
    y0 = (v - H / 2.0) / f
    depth = (1.2 + 0.08 * np.sin(6 * x0) * np.cos(5 * y0)
             + 0.05 * np.sin(3 * (x0 + y0))).astype(np.float32)
    K = jnp.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                    dtype=jnp.float32)
    act = np.asarray(_row_activity(
        geom, jnp.asarray(depth), K, jnp.eye(4, dtype=jnp.float32),
        truncation=5 * h, zmin=0.5, zmax=3.5)).astype(np.int64)
    total = act.sum()
    for n in (2, 4, 8):
        contig = act.reshape(n, -1).sum(axis=1)
        inter = np.array([act[k::n].sum() for k in range(n)])
        assert contig.max() / (total / n) > 1.6, (n, contig)
        assert inter.max() / (total / n) < 1.1, (n, inter)


def test_scan_communication_volume_pinned(mesh8z):
    """The sharded scan's per-frame collective bytes are KBs: fusion emits
    exactly one scalar overflow psum (NO volume-sized collective), the
    8-iteration tracker solve psums one 8x8 Gram per GN step."""
    DIM = 32
    h = 1.8 / DIM
    T = 5 * h
    geom = GridGeometry(dims=(DIM,) * 3, voxel_size=h, shift=(0.0, 0.0, 1.2))
    kw = dict(truncation=T, zmin=0.5, zmax=3.5)
    K_np, depth_np, n_np, nsq_np = _scene()
    K = jnp.asarray(K_np)
    depth = jnp.asarray(depth_np)
    color = jnp.full(depth.shape + (3,), 0.5, dtype=jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    vol_sh = shard_volume(make_volume(geom, T, frame_cap=32), mesh8z)

    fuse = jax.jit(shard.sharded_fuse_frame_culled_fn(
        mesh8z, geom, **kw, row_capacity=256))
    fuse_txt = fuse.lower(vol_sh, color, depth, jnp.asarray(n_np),
                          jnp.asarray(nsq_np), K, eye,
                          jnp.int32(0)).compile().as_text()
    fb = collective_bytes(fuse_txt)
    assert 0 < fb["total"] <= 1024, fb          # the overflow psum only
    assert fb["all-gather"] == 0 and fb["reduce-scatter"] == 0, fb

    trk = shard.make_sharded_tracker(
        mesh8z, geom, depth.shape, **kw, num_iterations=8,
        conv_threshold_sq=1e-6, damping=1.0, early_exit=False,
        regather_every=4)
    trk_txt = trk.lower(vol_sh, depth, K, eye).compile().as_text()
    tb = collective_bytes(trk_txt)
    # 8 unrolled GN steps x one 8x8 f32 Gram psum = 2 KB + slack for
    # fused/rewritten reductions; the bound is the claim "KBs, not MBs"
    assert 0 < tb["total"] <= 65536, tb
    assert tb["all-gather"] == 0 and tb["reduce-scatter"] == 0, tb
