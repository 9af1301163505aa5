"""Shared synthetic bench scene (wavy heightfield) — used by bench.py and
the scaling checks so every measurement sees identical inputs."""

from __future__ import annotations

import numpy as np


def make_scene(W: int = 640, H: int = 480):
    fx = fy = 0.9 * W
    cx, cy = W / 2.0, H / 2.0
    cols = np.arange(W, dtype=np.float32)[None, :]
    rows = np.arange(H, dtype=np.float32)[:, None]
    x0 = np.broadcast_to((cols - cx) / fx, (H, W))
    y0 = np.broadcast_to((rows - cy) / fy, (H, W))
    depth = (
        1.2 + 0.08 * np.sin(6 * x0) * np.cos(5 * y0) + 0.05 * np.sin(3 * (x0 + y0))
    ).astype(np.float32)
    dgx = 0.08 * 6 * np.cos(6 * x0) * np.cos(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
    dgy = -0.08 * 5 * np.sin(6 * x0) * np.sin(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
    n = np.stack([-dgx, -dgy, np.ones_like(dgx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    n_sq_inv = (1.0 / (1.0 + x0 ** 2 + y0 ** 2)).astype(np.float32)
    color = np.full((H, W, 3), 0.5, dtype=np.float32)
    return K, depth, n.astype(np.float32), n_sq_inv, color
