"""LED model path + grid upsampling tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.config import OptimizerConfig, LED
from psgradientsdf.refine.optimizer import (
    PhotometricRefiner, _albedo_block, _dist_block, _light_block, _pose_block,
)
from psgradientsdf.refine.upsample import upsample_volume
from psgradientsdf.core.volume import vis_bit
from psgradientsdf.utils import robust

from helpers import wavy_scene


def led_images(frames, K, light_rgb):
    """Render near-field LED images: I = albedo * l_c * (-n.(X-cam))/|X-cam|^3
    in each frame's camera geometry (outward normal convention)."""
    imgs = []
    for fr in frames:
        pose = fr["pose"]
        R = pose[:3, :3]
        t = pose[:3, 3]
        depth = fr["depth"]
        H, W = depth.shape
        cols = jnp.arange(W, dtype=jnp.float32)[None, :]
        rows = jnp.arange(H, dtype=jnp.float32)[:, None]
        x0 = (cols - K[0, 2]) / K[0, 0]
        y0 = (rows - K[1, 2]) / K[1, 1]
        p_cam = jnp.stack([x0 * depth, y0 * depth, depth], axis=-1)
        n_out_w = -fr["n_world"]
        # irradiance = -(n_out . (p_world - cam_center)) / |p_cam|^3
        p_w = jnp.einsum("ij,hwj->hwi", R, p_cam) + t
        irr = -jnp.einsum("hwi,hwi->hw", n_out_w, p_w - t)
        irr = irr / jnp.maximum(jnp.linalg.norm(p_cam, axis=-1), 1e-9) ** 3
        imgs.append(fr["albedo_world"] * light_rgb[None, None, :] * irr[..., None])
    return jnp.stack(imgs)


@pytest.fixture(scope="module")
def led_refiner():
    sc = wavy_scene(dim=48, h=0.03, H=64, W=64, f=60.0)
    light_gt = jnp.array([0.9, 1.1, 1.0], dtype=jnp.float32)
    images = led_images(sc["frames"], np.asarray(sc["K"]), light_gt)
    cfg = OptimizerConfig(
        max_it=3, conv_threshold=1e-6, damping=3.0, lam=0.2,
        reg_weight_n=0.1, reg_weight_l=0.0, reg_weight_rho=0.0,
        order=1, upsample=False, model=LED, loss=robust.CAUCHY,
    )
    ref = PhotometricRefiner(
        sc["vol"], sc["geom"], cfg, np.asarray(sc["K"]),
        truncation=sc["truncation"],
    )
    ref.set_keyframes(images, jnp.eye(4, dtype=jnp.float32)[None], [0], ["000"])
    ref.init()
    return ref, light_gt


def test_led_light_init_ratio(led_refiner):
    ref, light_gt = led_refiner
    # intensity-ratio init should land in the right ballpark (albedo here is
    # the fused *image* color, which includes shading, so expect rough scale)
    l = np.asarray(ref.lights)
    assert np.isfinite(l).all()
    assert (l > 0).all()


def test_led_blocks_run_and_reduce(led_refiner):
    ref, light_gt = led_refiner
    ref.init_albedo()
    E0 = ref.energies()[0]
    ref.albedo = _albedo_block(
        *ref._args(), **ref._static_kwargs(), reg_weight_rho=0.0, damping=3.0
    )
    ref.lights = _light_block(*ref._args(), **ref._static_kwargs(), damping=3.0)
    E1 = ref.energies()[0]
    assert np.isfinite(E1)
    assert E1 <= E0 * 1.05
    ref.dist, ref.grad_stored = _dist_block(
        *ref._args(), **ref._static_kwargs(),
        reg_weight_n=0.1, reg_weight_l=0.0, damping=3.0,
        laplacian_diag_only=False,
    )
    ref.poses = _pose_block(*ref._args(), **ref._static_kwargs(), damping=3.0)
    E2 = ref.energies()[0]
    assert np.isfinite(E2)


def test_upsample_volume():
    sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0)
    vol, geom, T = sc["vol"], sc["geom"], sc["truncation"]
    new_vol, new_geom, new_kf = upsample_volume(vol, geom, [0], T)
    assert new_vol.dist.shape == (64, 64, 64)
    assert new_geom.voxel_size == pytest.approx(0.02)
    assert new_kf == [0]
    d_old = np.asarray(vol.dist)
    d_new = np.asarray(new_vol.dist)
    fused = d_old != T
    # children of unfused parents stay at T
    zz, yy, xx = np.nonzero(~fused)
    assert np.allclose(d_new[2 * zz[0]:2 * zz[0] + 2,
                             2 * yy[0]:2 * yy[0] + 2,
                             2 * xx[0]:2 * xx[0] + 2], T)
    # children of fused parents follow d +- (h/4) g formula
    fz, fy, fx = np.nonzero(fused)
    i = len(fz) // 2
    z, y, x = fz[i], fy[i], fx[i]
    g = np.asarray(vol.grad)[z, y, x]
    g = g / max(np.linalg.norm(g), 1e-12)
    h4 = 0.25 * geom.voxel_size
    expect = d_old[z, y, x] + h4 * (-g[0] - g[1] - g[2])
    assert d_new[2 * z, 2 * y, 2 * x] == pytest.approx(expect, abs=1e-5)
    # visibility inherited
    vb_old = np.asarray(vis_bit(vol.vis, 0))
    vb_new = np.asarray(vis_bit(new_vol.vis, 0))
    assert vb_new[2 * z, 2 * y, 2 * x] == (vb_old[z, y, x] and fused[z, y, x])


def test_upsampled_geometry_children_tile_parent():
    """Child voxel centers must lie inside the parent cube (VoxelGrid.h:143-149)."""
    from psgradientsdf.core.grid import GridGeometry
    g = GridGeometry(dims=(8, 8, 8), voxel_size=0.1, shift=(0.0, 0.0, 1.0))
    g2 = g.subdivided()
    p = np.asarray(g.voxel2world(jnp.array([3, 4, 5])))
    c = np.asarray(g2.voxel2world(jnp.array([6, 8, 10])))
    # first child center = parent center - h/4 in each axis
    np.testing.assert_allclose(c, p - 0.025, atol=1e-6)
