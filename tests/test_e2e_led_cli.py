"""End-to-end: synthetic LED point-light dataset on disk (SynthLoader layout:
depth/NNN.png + rgb/NNN.png, 3-digit counter from 1, depth unit 1/1000) ->
CLI pipeline with the LED model -> full alternating refinement.

Covers the config_basket_LED recipe shape (the reference ships no LED demo
data): near-field shading I = rho * l * (-n^T R p / |p|^3), GT poses,
light+albedo+distance+pose refinement.
"""

import json
import os
import subprocess
import sys

import numpy as np

from psgradientsdf.io import png


def make_led_dataset(root, n_frames=6, H=64, W=80, f=70.0,
                     depth_noise=0.0, pose_noise=0.0):
    # depth_noise (meters): Gaussian sensor noise on the written depth maps;
    # pose_noise (meters / radians): Gaussian error on the WRITTEN pose.txt
    # (renders stay at the true poses — the file mimics an imperfect
    # tracker).  The production-shape rehearsal needs imperfect geometry
    # and misregistered fusion so the refinement has real work for >5
    # iterations (the upsample crossing), like the real basket footage.
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
        for row in K:
            fh.write(" ".join(str(v) for v in row) + "\n")

    cols = np.arange(W)[None, :]
    rows = np.arange(H)[:, None]
    x0 = np.broadcast_to((cols - W / 2) / f, (H, W))
    y0 = np.broadcast_to((rows - H / 2) / f, (H, W))

    def surf_z(px, py):
        return 1.2 + 0.10 * np.sin(5 * px) * np.cos(4 * py) + 0.05 * np.sin(3 * (px + py))

    light = np.array([1.6, 1.4, 1.2])
    gt_lines = []
    for i in range(n_frames):
        tx, ty = 0.004 * i, -0.003 * i
        T = np.eye(4)
        T[:3, 3] = [tx, ty, 0.0]
        # ray-march the heightfield from this camera
        z = np.full((H, W), 1.2)
        for _ in range(30):
            pc = np.stack([x0 * z, y0 * z, z], -1)
            pw = pc @ T[:3, :3].T + T[:3, 3]
            z = z + 0.9 * (surf_z(pw[..., 0], pw[..., 1]) - pw[..., 2])
        pc = np.stack([x0 * z, y0 * z, z], -1)
        pw = pc @ T[:3, :3].T + T[:3, 3]
        # outward (toward-camera) world normal of the heightfield
        eps = 1e-3
        gx = (surf_z(pw[..., 0] + eps, pw[..., 1]) - surf_z(pw[..., 0] - eps, pw[..., 1])) / (2 * eps)
        gy = (surf_z(pw[..., 0], pw[..., 1] + eps) - surf_z(pw[..., 0], pw[..., 1] - eps)) / (2 * eps)
        n = np.stack([gx, gy, -np.ones_like(gx)], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        # near-field LED irradiance (LedOptimizerJa.cpp:15-29): -n^T R p / |p|^3
        Rp = pc @ T[:3, :3].T
        pn = np.linalg.norm(pc, axis=-1)
        irr = np.maximum(-np.einsum("hwc,hwc->hw", n, Rp) / pn ** 3, 0.0)
        albedo = np.stack([
            0.45 + 0.25 * np.sin(6 * pw[..., 0]),
            0.50 + 0.20 * np.cos(5 * pw[..., 1]),
            0.55 * np.ones_like(z),
        ], -1)
        rgb = np.clip(albedo * light[None, None, :] * irr[..., None], 0, 1)

        stamp = f"{i + 1:03d}"
        z_out = z
        if depth_noise > 0:
            rng = np.random.default_rng(1000 + i)
            z_out = z + rng.normal(0.0, depth_noise, z.shape)
        png.write(os.path.join(root, "depth", stamp + ".png"),
                  np.clip(z_out * 1000.0, 0, 65535).astype(np.uint16))
        png.write(os.path.join(root, "rgb", stamp + ".png"),
                  np.clip(rgb * 255, 0, 255).astype(np.uint8))
        t = T[:3, 3]
        if pose_noise > 0:
            prng = np.random.default_rng(2000 + i)
            t = t + prng.normal(0.0, pose_noise, 3)
            w = prng.normal(0.0, pose_noise, 3)     # small-angle rotvec
            q = np.concatenate([w / 2.0, [1.0]])
            q = q / np.linalg.norm(q)
        else:
            q = np.array([0.0, 0.0, 0.0, 1.0])
        gt_lines.append(
            f"{stamp} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")

    with open(os.path.join(root, "pose.txt"), "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")


def test_led_cli_end_to_end(tmp_path):
    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    make_led_dataset(data)

    cfg = {
        "input": data,
        "output": out,
        "pose filename": "pose.txt",
        "datatype": "led",
        "first": 0,
        "last": 5,
        "voxel size": 0.02,
        "truncation factor": 5,
        "zmin": 0.3,
        "zmax": 3.5,
        "sharpness threshold": 0.0,
        "model type": "LED",
        "loss function": "cauchy",
        "lambda": 0.2,
        "reg norm": 0.5,
        "max iter": 3,
        "grid dim": 48,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "psgradientsdf.cli", "--config_file",
         cfg_path, "--platform", "cpu"],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]

    # artifacts
    for name in ("init_mesh.ply", "final_refined_mesh.ply",
                 "final_refined_pointcloud.ply", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, name)), name

    # energy trace decreases
    totals = []
    for line in open(os.path.join(out, "metrics.jsonl")):
        rec = json.loads(line)
        if rec.get("event") == "iteration":
            totals.append(rec["total"])
    assert len(totals) >= 1
    assert np.isfinite(totals).all()
    if len(totals) >= 2:
        assert totals[-1] <= totals[0] * 1.001, totals
