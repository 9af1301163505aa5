"""Resident streaming volume (core/resident.py) vs the canonical path.

The resident state is the round-4 answer to the state-movement wall:
rows stay compact across a chunk, fused in place, with
delta-allocation for rows entering the cull's active set and a
flush+refresh at chunk boundaries.  These tests pin the contracts:

  * a fusion-only resident stream at generic given poses reproduces the
    packed canonical kernel: vis bits EXACT, float fields to accumulation
    ULP (cross-program FMA emission; under adversarially ALIGNED poses —
    e.g. exact identity on a grid-aligned synthetic scene — projections
    can sit exactly on pixel boundaries where a 1-ULP emission difference
    flips the nearest pixel: a discretization tie, not an error);
  * a full tracked resident stream stays close to the canonical stream
    (float noise amplified through the track->fuse feedback);
  * the tracker-exactness ledger: tracking against a resident set that
    dropped fused rows raises the miss flag;
  * capacity / delta / coverage flags rise when budgets are violated.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from psgradientsdf.core import resident as R
from psgradientsdf.core.volume import (
    PackedVolume,
    fuse_frame,
    make_volume,
)
from psgradientsdf.tracking.tracker import track_frame
from psgradientsdf.utils import se3

from helpers import wavy_scene
from test_fuse_culled import _assert_equal_vol_grad_ulp


def _orbit_poses(n, scale=0.01):
    rng = np.random.default_rng(11)
    pose = np.eye(4, dtype=np.float32)
    out = []
    for _ in range(n):
        xi = rng.uniform(-1, 1, 6).astype(np.float32) * np.float32(scale)
        pose = np.asarray(se3.se3_exp(jnp.asarray(xi))) @ pose
        out.append(pose.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def sc():
    return wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)


@pytest.mark.parametrize("seg", [None, 8])
def test_resident_fusion_bit_identical_fixed_poses(sc, seg):
    """Fusion-only resident stream at GIVEN poses == the packed canonical
    kernel: vis bits EXACT (the per-voxel gates read only frame data, not
    state), float fields to ~1 ULP (cross-program FMA emission — the same
    caveat as test_fuse_culled._assert_close_vol).  Exercises refresh,
    mid-chunk delta allocation (the orbit moves the active set), flush,
    and a second chunk epoch; seg=8 runs the slots at X-SEGMENT
    granularity (the production at-scale configuration)."""
    from psgradientsdf.core.volume import fuse_frame_culled_packed

    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    NSEG = geom.dims[2] * geom.dims[1] * (geom.dims[0] // (seg or geom.dims[0]))
    poses = _orbit_poses(6, scale=0.04)
    Kj = sc["K"]
    args = (fr["color"], fr["depth"], fr["normals"], fr["n_sq_inv"], Kj)

    eye = jnp.eye(4, dtype=jnp.float32)
    vol0 = make_volume(geom, T, frame_cap=64)
    vol0 = fuse_frame(vol0, geom, *args, eye, jnp.int32(0), **kw)
    pvol_ref = PackedVolume.from_volume(vol0)
    pvol = PackedVolume.from_volume(vol0)

    for fi, pose in enumerate(poses):
        pvol_ref, ov = fuse_frame_culled_packed(
            pvol_ref, geom, *args, jnp.asarray(pose), jnp.int32(fi + 1),
            **kw, row_capacity=geom.dims[2] * geom.dims[1])
        assert not bool(ov)

    fi = 0
    for chunk in range(2):
        res = R.resident_refresh(pvol, geom, fr["depth"], Kj,
                                 jnp.asarray(poses[fi]), **kw,
                                 capacity=NSEG, seg_x=seg)
        for _ in range(3):
            pj = jnp.asarray(poses[fi])
            res = R.resident_alloc(res, pvol, geom, fr["depth"], Kj, pj,
                                   **kw, delta_capacity=1024)
            res = R.fuse_frame_resident(res, geom, *args, pj,
                                        jnp.int32(fi + 1), **kw)
            fi += 1
        assert int(res.flags) == 0, f"flags={int(res.flags)}"
        pvol = R.resident_flush(res, pvol)

    ref = pvol_ref.to_volume()
    got = pvol.to_volume()
    np.testing.assert_array_equal(np.asarray(got.vis), np.asarray(ref.vis))
    # float fields drift by per-frame emission ULP compounded over the
    # running means/sums (observed maxima ~5e-6 over 7 frames — 5 um on
    # 40 mm voxels for dist); vis bits stay exact because the gates read
    # only frame data.
    for name, atol in (("dist", 1e-5), ("grad", 1e-5), ("weight", 1e-5),
                       ("color", 1e-5)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=0, atol=atol, err_msg=name)


def test_resident_tracker_matches_canonical_same_state(sc):
    """track_frame_resident == track_frame on identical state: same
    iterations/valid-pixel count, pose to float noise (cross-program FMA
    reassociation — a bit guarantee across different XLA programs is not
    available; see test_fuse_culled._assert_close_vol)."""
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    tkw = dict(**kw, num_iterations=8, conv_threshold_sq=1e-6, damping=1.0,
               early_exit=False, regather_every=4)
    NSEG = geom.dims[2] * geom.dims[1]
    eye = jnp.eye(4, dtype=jnp.float32)
    vol = make_volume(geom, T, frame_cap=64)
    vol = fuse_frame(vol, geom, fr["color"], fr["depth"], fr["normals"],
                     fr["n_sq_inv"], sc["K"], eye, jnp.int32(0), **kw)
    pvol = PackedVolume.from_volume(vol)

    seed = jnp.asarray(_orbit_poses(1, scale=0.02)[0])
    ref = track_frame(pvol, geom, fr["depth"], sc["K"], seed, **tkw)
    # margins sized to the seed's offset from the map alignment (~0.02 m,
    # ~3 px of reprojection at f=50, z=1.2) — the rows the GN solve will
    # query as it converges back toward identity
    res = R.resident_refresh(pvol, geom, fr["depth"], sc["K"], seed, **kw,
                             capacity=NSEG, margin_px=6.0, margin_t=0.05)
    got, miss = R.track_frame_resident(res, geom, fr["depth"], sc["K"],
                                       seed, **tkw)
    assert not bool(miss)
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.num_valid) == int(ref.num_valid)
    np.testing.assert_allclose(np.asarray(got.pose), np.asarray(ref.pose),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seg", [None, 8])
def test_resident_tracked_stream_close(sc, seg):
    """Full tracked resident stream (2 chunks x 3 frames) vs the packed
    canonical stream: per-frame float noise amplifies through the
    track->fuse feedback, so the contract is closeness, not bits.
    seg=8 runs the slots at X-segment granularity."""
    from psgradientsdf.core.volume import fuse_frame_culled_packed

    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    tkw = dict(**kw, num_iterations=8, conv_threshold_sq=1e-6, damping=1.0,
               early_exit=False, regather_every=4)
    NSEG = geom.dims[2] * geom.dims[1] * (geom.dims[0] // (seg or geom.dims[0]))
    poses = _orbit_poses(6)
    Kj = sc["K"]
    args = (fr["color"], fr["depth"], fr["normals"], fr["n_sq_inv"], Kj)

    eye = jnp.eye(4, dtype=jnp.float32)
    vol0 = make_volume(geom, T, frame_cap=64)
    vol0 = fuse_frame(vol0, geom, *args, eye, jnp.int32(0), **kw)
    pvol_ref = PackedVolume.from_volume(vol0)
    pvol = PackedVolume.from_volume(vol0)

    ref_poses = []
    pose = eye
    for fi, gtp in enumerate(poses):
        tr = track_frame(pvol_ref, geom, fr["depth"], Kj,
                         jnp.asarray(gtp) @ pose, **tkw)
        pose = tr.pose
        ref_poses.append(np.asarray(pose))
        pvol_ref, ov = fuse_frame_culled_packed(
            pvol_ref, geom, *args, pose, jnp.int32(fi + 1), **kw,
            row_capacity=NSEG)
        assert not bool(ov)

    got_poses = []
    pose = eye
    fi = 0
    for chunk in range(2):
        res = R.resident_refresh(pvol, geom, fr["depth"], Kj, pose, **kw,
                                 capacity=NSEG, seg_x=seg)
        for _ in range(3):
            seed = jnp.asarray(poses[fi]) @ pose
            res = R.resident_alloc(res, pvol, geom, fr["depth"], Kj, seed,
                                   **kw, delta_capacity=1024,
                                   margin_px=6.0, margin_t=0.05)
            tr, miss = R.track_frame_resident(res, geom, fr["depth"], Kj,
                                              seed, **tkw)
            assert not bool(miss)
            pose = tr.pose
            got_poses.append(np.asarray(pose))
            res = R.resident_alloc(res, pvol, geom, fr["depth"], Kj, pose,
                                   **kw, delta_capacity=1024)
            res = R.fuse_frame_resident(res, geom, *args, pose,
                                        jnp.int32(fi + 1), **kw)
            fi += 1
        assert int(res.flags) == 0, f"flags={int(res.flags)}"
        pvol = R.resident_flush(res, pvol)

    for a, b in zip(got_poses, ref_poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    a, b = pvol.to_volume(), pvol_ref.to_volume()
    # slightly different pose paths flip per-voxel gates at thresholds for
    # a handful of voxels — bound the flipped FRACTION, not the max
    for name in ("dist", "grad", "weight", "color"):
        x = np.asarray(getattr(a, name)).reshape(-1)
        y = np.asarray(getattr(b, name)).reshape(-1)
        frac = float(np.mean(np.abs(x - y) > 5e-2))
        # grad is the most sensitive (nearest-pixel choices shift under the
        # slightly different pose path); observed ~0.15% of components
        assert frac < 5e-3, (name, frac)


def test_resident_tracker_miss_ledger(sc):
    """Fuse at identity, then refresh the residency from a pose looking
    AWAY (empty active set) and track against the original frame: every
    queried fused row is unresident -> miss flag."""
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    eye = jnp.eye(4, dtype=jnp.float32)
    vol = make_volume(geom, T, frame_cap=64)
    vol = fuse_frame(vol, geom, fr["color"], fr["depth"], fr["normals"],
                     fr["n_sq_inv"], sc["K"], eye, jnp.int32(0), **kw)
    pvol = PackedVolume.from_volume(vol)

    flip = np.eye(4, dtype=np.float32)
    flip[:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
    res = R.resident_refresh(pvol, geom, fr["depth"], sc["K"],
                             jnp.asarray(flip), **kw,
                             capacity=geom.dims[2] * geom.dims[1])
    _, miss = R.track_frame_resident(
        res, geom, fr["depth"], sc["K"], eye, **kw, num_iterations=4,
        conv_threshold_sq=1e-6, damping=1.0, early_exit=False,
        regather_every=4)
    assert bool(miss)


def test_resident_flags(sc):
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    eye = jnp.eye(4, dtype=jnp.float32)
    pvol = PackedVolume.from_volume(make_volume(geom, T, frame_cap=64))

    # capacity too small at refresh
    res = R.resident_refresh(pvol, geom, fr["depth"], sc["K"], eye, **kw,
                             capacity=8)
    assert int(res.flags) & R.FLAG_CAPACITY

    # empty refresh + tiny delta capacity at alloc
    flip = np.eye(4, dtype=np.float32)
    flip[:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
    res = R.resident_refresh(pvol, geom, fr["depth"], sc["K"],
                             jnp.asarray(flip), **kw,
                             capacity=geom.dims[2] * geom.dims[1])
    res2 = R.resident_alloc(res, pvol, geom, fr["depth"], sc["K"], eye,
                            **kw, delta_capacity=8)
    assert int(res2.flags) & R.FLAG_DELTA

    # fusing with unresident active rows -> coverage flag
    res3 = R.fuse_frame_resident(
        res, geom, fr["color"], fr["depth"], fr["normals"], fr["n_sq_inv"],
        sc["K"], eye, jnp.int32(1), **kw)
    assert int(res3.flags) & R.FLAG_COVERAGE
