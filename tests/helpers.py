"""Shared synthetic-scene builders for tests."""

import jax.numpy as jnp
import numpy as np

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import make_volume, fuse_frame
from psgradientsdf.utils import se3


def wavy_scene(dim=64, h=0.02, H=96, W=96, f=90.0, poses=None, albedo_fn=None):
    """Fuse a wavy textured heightfield from one or more camera poses.

    Returns dict with geom, vol, K, per-pose (depth, color, normals) lists,
    truncation.
    """
    geom = GridGeometry(dims=(dim, dim, dim), voxel_size=h, shift=(0.0, 0.0, 1.2))
    T = 5 * h
    vol = make_volume(geom, truncation=T, frame_cap=32)
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=jnp.float32)
    if poses is None:
        poses = [jnp.eye(4, dtype=jnp.float32)]
    if albedo_fn is None:
        albedo_fn = lambda x, y: jnp.stack(
            [
                0.5 + 0.2 * jnp.sin(10 * x),
                0.5 + 0.2 * jnp.cos(8 * y),
                0.5 + 0.15 * jnp.sin(6 * (x + y)),
            ],
            axis=-1,
        )

    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    rows = jnp.arange(H, dtype=jnp.float32)[:, None]
    x0 = jnp.broadcast_to((cols - W / 2) / f, (H, W))
    y0 = jnp.broadcast_to((rows - H / 2) / f, (H, W))

    frames = []
    for i, pose in enumerate(poses):
        # heightfield in WORLD frame z = g(x,y); ray-march approximately by
        # assuming fronto-parallel viewing (valid for small pose offsets)
        # solve z s.t. point = R(x0 z, y0 z, z)+t lies on surface; do fixed-point iters
        z = jnp.full((H, W), 1.2, dtype=jnp.float32)
        R = pose[:3, :3]
        t = pose[:3, 3]
        for _ in range(25):
            pc = jnp.stack([x0 * z, y0 * z, z], axis=-1)
            pw = pc @ R.T + t
            gz = (
                1.2
                + 0.08 * jnp.sin(6 * pw[..., 0]) * jnp.cos(5 * pw[..., 1])
                + 0.05 * jnp.sin(3 * (pw[..., 0] + pw[..., 1]))
            )
            # adjust z so that pw_z == gz
            z = z + 0.9 * (gz - pw[..., 2])
        pc = jnp.stack([x0 * z, y0 * z, z], axis=-1)
        pw = pc @ R.T + t
        # analytic world normal of z = g(x,y): n_in ∝ (-dg/dx, -dg/dy, 1)
        dgx = 0.08 * 6 * jnp.cos(6 * pw[..., 0]) * jnp.cos(5 * pw[..., 1]) \
            + 0.15 * jnp.cos(3 * (pw[..., 0] + pw[..., 1]))
        dgy = -0.08 * 5 * jnp.sin(6 * pw[..., 0]) * jnp.sin(5 * pw[..., 1]) \
            + 0.15 * jnp.cos(3 * (pw[..., 0] + pw[..., 1]))
        n_w = jnp.stack([-dgx, -dgy, jnp.ones_like(dgx)], axis=-1)
        n_w = n_w / jnp.linalg.norm(n_w, axis=-1, keepdims=True)
        n_cam = jnp.einsum("ji,hwj->hwi", R, n_w)   # R^T n_w
        color = albedo_fn(pw[..., 0], pw[..., 1])
        n_sq_inv = (1.0 / (1.0 + x0 ** 2 + y0 ** 2)).astype(jnp.float32)
        frames.append(
            dict(depth=z.astype(jnp.float32), color=color.astype(jnp.float32),
                 normals=n_cam.astype(jnp.float32), n_sq_inv=n_sq_inv,
                 pose=pose, albedo_world=color, n_world=n_w)
        )
        vol = fuse_frame(
            vol, geom, frames[-1]["color"], frames[-1]["depth"],
            frames[-1]["normals"], n_sq_inv, K, pose, jnp.int32(i),
            truncation=T, zmin=0.1, zmax=5.0,
        )
    return dict(geom=geom, vol=vol, K=K, frames=frames, truncation=T)


def shaded_images(frames, light_sh, order=1):
    """Replace each frame's color with a Lambertian SH rendering
    I = albedo * (l . SH(n_out)) using the OUTWARD (camera-facing) normal —
    the convention of the refinement's FD-gradient shading normal
    (the fused Gradient-SDF gradient points outward, grad -= w R n_inward)."""
    from psgradientsdf.utils import sh as sh_mod

    imgs = []
    for fr in frames:
        basis = sh_mod.sh_basis(-fr["n_world"], order)
        irr = jnp.einsum("hwb,b->hw", basis, light_sh)
        imgs.append(fr["albedo_world"] * irr[..., None])
    return jnp.stack(imgs)
