"""fuse_frame_culled == fuse_frame bit-for-bit (the culling is a strict
superset of the active voxel set and the inner update is shared code).

Covers: generic viewing poses, rotated poses, camera behind the volume,
rows crossing the camera plane (pz sign change), empty depth frames, the
gate no-op, visibility bits beyond word 0, and the overflow flag contract.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import (
    fuse_frame,
    fuse_frame_culled,
    make_volume,
)

from helpers import wavy_scene


def _assert_equal_vol(got, ref):
    np.testing.assert_array_equal(np.asarray(got.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(np.asarray(got.grad), np.asarray(ref.grad))
    np.testing.assert_array_equal(np.asarray(got.weight), np.asarray(ref.weight))
    np.testing.assert_array_equal(np.asarray(got.color), np.asarray(ref.color))
    np.testing.assert_array_equal(np.asarray(got.vis), np.asarray(ref.vis))


def _poses():
    from psgradientsdf.utils import se3

    rng = np.random.default_rng(7)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(3):
        xi = rng.uniform(-1, 1, 6).astype(np.float32) * np.array(
            [0.1, 0.1, 0.1, 0.2, 0.2, 0.2], dtype=np.float32)
        poses.append(np.asarray(se3.se3_exp(jnp.asarray(xi))))
    # camera looking away / volume behind the camera plane
    flip = np.eye(4, dtype=np.float32)
    flip[:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
    poses.append(flip)
    # camera INSIDE the volume: rows cross pz = 0
    inside = np.eye(4, dtype=np.float32)
    inside[:3, 3] = [0.0, 0.0, 1.2]
    poses.append(inside)
    return poses


@pytest.mark.parametrize("cap_frac,seg_x", [(1.0, None), (0.6, None),
                                             (1.0, 8), (0.6, 8)])
def test_culled_matches_exact(cap_frac, seg_x):
    sc = wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    ns = 1 if seg_x is None else geom.dims[0] // seg_x
    ZY = geom.dims[2] * geom.dims[1] * ns
    cap = int(ZY * cap_frac)
    kw = dict(truncation=T, zmin=0.1, zmax=5.0, seg_x=seg_x)

    vol_e = make_volume(geom, T, frame_cap=64)
    vol_c = vol_e
    any_overflow = False
    for fi, pose in enumerate(_poses()):
        pj = jnp.asarray(pose)
        fkw = {k: v for k, v in kw.items() if k != "seg_x"}
        vol_e = fuse_frame(
            vol_e, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **fkw)
        vol_c, ov = fuse_frame_culled(
            vol_c, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **kw,
            row_capacity=cap)
        any_overflow = any_overflow or bool(ov)
        if not bool(ov):
            if seg_x is None:
                _assert_equal_vol(vol_c, vol_e)      # bit-exact
            else:
                # segment shapes change the minor-dim vectorization, so
                # p_c differs by ~1 ULP — harmless except at voxels whose
                # viewing-angle/weight gate sits exactly on its threshold,
                # where the flip includes/excludes ONE frame.  Contract:
                # everything ULP-close except a <0.5% gate-flip fraction.
                for name in ("dist", "grad", "weight", "color"):
                    a = np.asarray(getattr(vol_c, name))
                    b = np.asarray(getattr(vol_e, name))
                    frac = float(np.mean(~np.isclose(a, b, rtol=0, atol=2e-6)))
                    assert frac < 0.005, (name, frac)
                vfrac = float(np.mean(np.asarray(vol_c.vis)
                                      != np.asarray(vol_e.vis)))
                assert vfrac < 0.005, vfrac
                # resync so gate flips don't compound across the pose loop
                vol_c = vol_e
        else:
            # overflow contract: flag raised; caller re-runs. resync here.
            vol_c = vol_e
    if cap_frac == 1.0:
        assert not any_overflow


def test_culled_empty_depth_and_gate():
    sc = wavy_scene(dim=16, h=0.08, H=32, W=32, f=30.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    cap = geom.dims[2] * geom.dims[1]
    vol0 = make_volume(geom, T, frame_cap=32)

    # all-invalid depth: every row culled by the -inf depth bound
    zero_d = jnp.zeros_like(fr["depth"])
    got, ov = fuse_frame_culled(
        vol0, geom, fr["color"], zero_d, fr["normals"], fr["n_sq_inv"],
        sc["K"], jnp.eye(4, dtype=jnp.float32), jnp.int32(0), **kw,
        row_capacity=cap)
    assert not bool(ov)
    ref = fuse_frame(
        vol0, geom, fr["color"], zero_d, fr["normals"], fr["n_sq_inv"],
        sc["K"], jnp.eye(4, dtype=jnp.float32), jnp.int32(0), **kw)
    _assert_equal_vol(got, ref)

    # gate=False is a no-op on both paths
    gate = jnp.bool_(False)
    got, ov = fuse_frame_culled(
        vol0, geom, fr["color"], fr["depth"], fr["normals"], fr["n_sq_inv"],
        sc["K"], jnp.eye(4, dtype=jnp.float32), jnp.int32(0), gate, **kw,
        row_capacity=cap)
    _assert_equal_vol(got, vol0)


def test_sharded_culled_matches_single_device():
    """Per-slab cull under shard_map (parallel/shard.py) == single-device
    fuse_frame across generic poses; slab-level overflow surfaces through
    the psum'd flag.

    The comparison allows a few ulp (atol 1e-6 on values of order 1): the
    sharded program is compiled separately from the single-device one, and
    XLA may contract or reorder the float32 grad/dist accumulation
    differently in each (measured: 30 of 98,304 grad elements 1 ulp apart,
    max abs diff 5.96e-8).  Visibility bits are compared exactly."""
    from psgradientsdf.parallel import mesh as mesh_mod, shard

    sc = wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    mesh = mesh_mod.make_mesh(n_z=4, n_frames=2)
    Zl_rows = (geom.dims[2] // 4) * geom.dims[1]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)

    import jax
    fuse_sh = jax.jit(shard.sharded_fuse_frame_culled_fn(
        mesh, geom, **kw, row_capacity=Zl_rows))

    vol_e = make_volume(geom, T, frame_cap=64)
    vol_c = mesh_mod.shard_volume(vol_e, mesh)
    for fi, pose in enumerate(_poses()):
        pj = jnp.asarray(pose)
        vol_e = fuse_frame(
            vol_e, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi), **kw)
        vol_c, ov = fuse_sh(
            vol_c, fr["color"], fr["depth"], fr["normals"], fr["n_sq_inv"],
            sc["K"], pj, jnp.int32(fi))
        assert not bool(ov)
        for name in ("dist", "grad", "weight", "color"):
            np.testing.assert_allclose(
                np.asarray(getattr(vol_c, name)),
                np.asarray(getattr(vol_e, name)), rtol=0, atol=1e-6,
                err_msg=name)
        np.testing.assert_array_equal(np.asarray(vol_c.vis),
                                      np.asarray(vol_e.vis))
    # output stays Z-slab sharded
    assert "z" in str(vol_c.dist.sharding.spec)

    # per-slab overflow: a capacity below one slab's active rows trips the
    # psum'd flag
    fuse_tiny = jax.jit(shard.sharded_fuse_frame_culled_fn(
        mesh, geom, **kw, row_capacity=8))
    _, ov = fuse_tiny(
        mesh_mod.shard_volume(make_volume(geom, T, frame_cap=64), mesh),
        fr["color"], fr["depth"], fr["normals"], fr["n_sq_inv"],
        sc["K"], jnp.eye(4, dtype=jnp.float32), jnp.int32(0))
    assert bool(ov)


def test_culled_cull_ratio_is_real():
    """On the bench-like scene the cull must actually remove rows (this is
    the performance contract — fail loudly if a regression makes the cull
    vacuous)."""
    sc = wavy_scene(dim=32, h=1.8 / 32, H=48, W=64, f=0.9 * 64)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    ZY = geom.dims[2] * geom.dims[1]
    # capacity = 60% must suffice for this frustum (measured ~35-45%)
    _, ov = fuse_frame_culled(
        make_volume(geom, T, frame_cap=32), geom, fr["color"], fr["depth"],
        fr["normals"], fr["n_sq_inv"], sc["K"],
        jnp.eye(4, dtype=jnp.float32), jnp.int32(0),
        truncation=T, zmin=0.1, zmax=5.0, row_capacity=int(ZY * 0.6))
    assert not bool(ov)


def _assert_close_vol(got, ref, atol=1e-6):
    """Packed-kernel equality contract: vis (integer) exact; float fields to
    ~ULP — the packed program's [CAP,X,8] row slices let LLVM contract the
    grad accumulate into an FMA the SoA program doesn't emit (observed max
    drift 5e-7 over 6 frames; a cross-program bit guarantee is not
    something XLA offers)."""
    np.testing.assert_allclose(
        np.asarray(got.dist), np.asarray(ref.dist), rtol=0, atol=atol)
    np.testing.assert_allclose(
        np.asarray(got.grad), np.asarray(ref.grad), rtol=0, atol=atol)
    np.testing.assert_allclose(
        np.asarray(got.weight), np.asarray(ref.weight), rtol=0, atol=atol)
    np.testing.assert_allclose(
        np.asarray(got.color), np.asarray(ref.color), rtol=0, atol=atol)
    np.testing.assert_array_equal(np.asarray(got.vis), np.asarray(ref.vis))


@pytest.mark.parametrize("cap_frac", [1.0, 0.6])
def test_packed_matches_exact(cap_frac):
    """fuse_frame_culled_packed on PackedVolume state == fuse_frame to ~ULP
    (same poses/overflow contract as test_culled_matches_exact), and the
    PackedVolume round-trip is lossless."""
    from psgradientsdf.core.volume import (
        PackedVolume, fuse_frame_culled_packed,
    )

    sc = wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    ZY = geom.dims[2] * geom.dims[1]
    cap = int(ZY * cap_frac)
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)

    vol_e = make_volume(geom, T, frame_cap=64)
    pvol = PackedVolume.from_volume(vol_e)
    _assert_equal_vol(pvol.to_volume(), vol_e)   # lossless round trip
    any_overflow = False
    for fi, pose in enumerate(_poses()):
        pj = jnp.asarray(pose)
        vol_e = fuse_frame(
            vol_e, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **kw)
        pvol, ov = fuse_frame_culled_packed(
            pvol, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **kw,
            row_capacity=cap)
        any_overflow = any_overflow or bool(ov)
        if not bool(ov):
            _assert_close_vol(pvol.to_volume(), vol_e)
        else:
            pvol = PackedVolume.from_volume(vol_e)
    if cap_frac == 1.0:
        assert not any_overflow


def test_packed_tracking_matches_unpacked():
    """track_frame(PackedVolume) == track_frame(GradSdfVolume) exactly —
    the packed payload's slots 0,1:4,4 feed the same gather."""
    from psgradientsdf.core.volume import PackedVolume
    from psgradientsdf.tracking.tracker import track_frame
    from psgradientsdf.utils import se3

    sc = wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    vol = fuse_frame(
        make_volume(geom, T, frame_cap=32), geom, fr["color"], fr["depth"],
        fr["normals"], fr["n_sq_inv"], sc["K"],
        jnp.eye(4, dtype=jnp.float32), jnp.int32(0), **kw)
    seed = jnp.asarray(np.asarray(se3.se3_exp(jnp.asarray(
        np.array([0.01, -0.008, 0.012, 0.004, -0.003, 0.005], np.float32)))))
    tkw = dict(**kw, num_iterations=8, conv_threshold_sq=0.0, damping=1.0,
               early_exit=False, regather_every=4)
    r_soa = track_frame(vol, geom, fr["depth"], sc["K"], seed, **tkw)
    r_pkd = track_frame(PackedVolume.from_volume(vol), geom, fr["depth"],
                        sc["K"], seed, **tkw)
    np.testing.assert_array_equal(np.asarray(r_soa.pose), np.asarray(r_pkd.pose))
    assert int(r_soa.iterations) == int(r_pkd.iterations)
    np.testing.assert_array_equal(
        np.asarray(r_soa.energy), np.asarray(r_pkd.energy))


def _assert_equal_vol_grad_ulp(got, ref):
    """dist/weight/color/vis bit-identical; grad within 1 ULP.

    The barrier-fenced movement impls change the grad operand's layout
    (2-D row view), and XLA makes layout-dependent FMA-contraction
    choices inside the (otherwise identical, barrier-fenced) update
    island — a 1-ULP artifact on the grad accumulate only."""
    np.testing.assert_array_equal(np.asarray(got.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(np.asarray(got.weight), np.asarray(ref.weight))
    np.testing.assert_array_equal(np.asarray(got.color), np.asarray(ref.color))
    np.testing.assert_array_equal(np.asarray(got.vis), np.asarray(ref.vis))
    a, b = np.asarray(got.grad), np.asarray(ref.grad)
    ulp = np.spacing(np.abs(b).astype(np.float32))
    # 1 ULP per fused frame, accumulating over the test's pose loop
    assert np.all(np.abs(a - b) <= 4 * ulp), (
        f"grad beyond 4 ULP: max {np.abs(a - b).max()}")


@pytest.mark.parametrize("rows_impl", ["xla2d"])
def test_rows_impl_variants_bit_identical(rows_impl):
    """The barrier-fenced 2-D copy state movement
    (_state_rows_gather/_state_rows_scatter) matches fuse_frame —
    bit-identical except grad within 1 ULP (_assert_equal_vol_grad_ulp) —
    including the duplicate-first-active capacity padding."""
    from psgradientsdf.core.volume import (
        PackedVolume, fuse_frame_culled_packed,
    )

    sc = wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    ZY = geom.dims[2] * geom.dims[1]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)

    vol_e = make_volume(geom, T, frame_cap=64)
    vol_c = vol_e
    pvol = PackedVolume.from_volume(vol_e)
    for fi, pose in enumerate(_poses()):
        pj = jnp.asarray(pose)
        vol_e = fuse_frame(
            vol_e, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **kw)
        vol_c, ov = fuse_frame_culled(
            vol_c, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **kw,
            row_capacity=ZY, rows_impl=rows_impl)
        pvol, ovp = fuse_frame_culled_packed(
            pvol, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], pj, jnp.int32(fi + 30), **kw,
            row_capacity=ZY, rows_impl=rows_impl)
        assert not bool(ov) and not bool(ovp)
        _assert_equal_vol_grad_ulp(vol_c, vol_e)
        _assert_equal_vol_grad_ulp(pvol.to_volume(), vol_e)


@pytest.mark.parametrize("rows_impl", ["xla", "xla2d"])
def test_fuse_frames_batched_bit_identical(rows_impl):
    """K-frame batched fusion (fuse_frames_culled) == K sequential
    fuse_frame calls bit-for-bit: shared per-voxel update applied in
    order on once-gathered union rows.  Covers a vis word boundary
    (ids 30..35 span words 0 and 1), per-frame gates, and the overflow
    flag on an undersized capacity."""
    from psgradientsdf.core.volume import fuse_frames_culled

    del rows_impl  # batched kernel currently ships the xla movement only
    sc = wavy_scene(dim=32, h=0.04, H=48, W=64, f=50.0)
    geom, T = sc["geom"], sc["truncation"]
    fr = sc["frames"][0]
    ZY = geom.dims[2] * geom.dims[1]
    kw = dict(truncation=T, zmin=0.1, zmax=5.0)
    poses = _poses()
    KF = len(poses)
    gates = np.ones(KF, bool)
    gates[2] = False                      # one gated-off frame

    vol_seq = make_volume(geom, T, frame_cap=64)
    for fi, pose in enumerate(poses):
        vol_seq = fuse_frame(
            vol_seq, geom, fr["color"], fr["depth"], fr["normals"],
            fr["n_sq_inv"], sc["K"], jnp.asarray(pose), jnp.int32(fi + 30),
            jnp.bool_(gates[fi]), **kw)

    stack = lambda a: jnp.asarray(np.stack([np.asarray(a)] * KF))
    vol_b, ov = fuse_frames_culled(
        make_volume(geom, T, frame_cap=64), geom,
        stack(fr["color"]), stack(fr["depth"]), stack(fr["normals"]),
        stack(fr["n_sq_inv"]), sc["K"],
        jnp.asarray(np.stack(poses)),
        jnp.arange(30, 30 + KF, dtype=jnp.int32),
        jnp.asarray(gates), **kw, row_capacity=ZY)
    assert not bool(ov)
    _assert_equal_vol(vol_b, vol_seq)

    # undersized capacity -> overflow flagged
    _, ov2 = fuse_frames_culled(
        make_volume(geom, T, frame_cap=64), geom,
        stack(fr["color"]), stack(fr["depth"]), stack(fr["normals"]),
        stack(fr["n_sq_inv"]), sc["K"],
        jnp.asarray(np.stack(poses)),
        jnp.arange(30, 30 + KF, dtype=jnp.int32),
        jnp.asarray(gates), **kw, row_capacity=64)
    assert bool(ov2)

    # ids spanning >2 words -> flagged (bits would be dropped)
    _, ov3 = fuse_frames_culled(
        make_volume(geom, T, frame_cap=64), geom,
        stack(fr["color"]), stack(fr["depth"]), stack(fr["normals"]),
        stack(fr["n_sq_inv"]), sc["K"],
        jnp.asarray(np.stack(poses)),
        jnp.asarray(np.array([0, 32, 64, 65, 66, 67][:KF], np.int32)),
        jnp.asarray(gates), **kw, row_capacity=ZY)
    assert bool(ov3)
