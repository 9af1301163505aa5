"""End-to-end: synthetic TUM-RGBD dataset on disk -> CLI pipeline with
camera *tracking* (no GT poses) -> ATE-RMSE against ground truth.

This is the missing test pyramid apex (SURVEY §4): the reference has no
tests at all and defers ATE to external tooling; here the whole
loader -> FALS normals -> fusion -> GN tracking -> trajectory chain is
validated quantitatively.
"""

import json
import os
import subprocess
import sys

import numpy as np

from psgradientsdf.io import png

from psgradientsdf.io.trajectory import ate_rmse, read_trajectory


def make_tum_dataset(root, n_frames=8, H=96, W=128):
    """Wavy heightfield viewed from a slowly moving camera, TUM layout."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    f = 110.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)
    with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
        for row in K:
            fh.write(" ".join(str(v) for v in row) + "\n")

    cols = np.arange(W)[None, :]
    rows = np.arange(H)[:, None]
    x0 = np.broadcast_to((cols - W / 2) / f, (H, W))
    y0 = np.broadcast_to((rows - H / 2) / f, (H, W))

    def surf_z(px, py):
        return (
            1.2 + 0.10 * np.sin(5 * px) * np.cos(4 * py)
            + 0.06 * np.sin(3 * (px + py)) + 0.03 * np.cos(7 * px - 2 * py)
        )

    poses = []
    assoc = []
    gt_lines = []
    for i in range(n_frames):
        # smooth camera path: small translation + tiny rotation
        tx = 0.004 * i
        ty = -0.002 * i
        tz = 0.003 * np.sin(0.3 * i)
        wz = 0.002 * i
        Rz = np.array(
            [[np.cos(wz), -np.sin(wz), 0], [np.sin(wz), np.cos(wz), 0], [0, 0, 1]]
        )
        T = np.eye(4)
        T[:3, :3] = Rz
        T[:3, 3] = [tx, ty, tz]
        poses.append(T)

        # ray-march the heightfield from this camera
        z = np.full((H, W), 1.2)
        for _ in range(30):
            pc = np.stack([x0 * z, y0 * z, z], -1)
            pw = pc @ T[:3, :3].T + T[:3, 3]
            z = z + 0.9 * (surf_z(pw[..., 0], pw[..., 1]) - pw[..., 2])
        depth_mm = np.clip(z * 5000.0, 0, 65535).astype(np.uint16)  # TUM 1/5000 unit
        pc = np.stack([x0 * z, y0 * z, z], -1)
        pw = pc @ T[:3, :3].T + T[:3, 3]
        rgb = np.stack(
            [
                0.5 + 0.3 * np.sin(8 * pw[..., 0]),
                0.5 + 0.3 * np.cos(6 * pw[..., 1]),
                0.5 * np.ones_like(z),
            ],
            -1,
        )
        rgb8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)

        ts = f"{1000.0 + 0.1 * i:.4f}"
        dname, cname = f"depth/{i:04d}.png", f"rgb/{i:04d}.png"
        png.write(os.path.join(root, dname), depth_mm)
        png.write(os.path.join(root, cname), rgb8)
        assoc.append(f"{ts} {cname} {ts} {dname}")
        q = _rot_to_quat(T[:3, :3])
        t = T[:3, 3]
        gt_lines.append(
            f"{ts} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )

    with open(os.path.join(root, "associated.txt"), "w") as fh:
        fh.write("\n".join(assoc) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")
    return poses


def _rot_to_quat(R):
    tr = np.trace(R)
    w = np.sqrt(max(1 + tr, 0)) / 2
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([x, y, z, w])


def test_tum_tracking_ate(tmp_path):
    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    gt_poses = make_tum_dataset(data)

    cfg = {
        "input": data,
        "output": out,
        "pose filename": "no_such_pose_file.txt",   # force tracking mode
        "datatype": "tum",
        "first": 0,
        "last": 7,
        "voxel size": 0.015,
        "truncation factor": 5,
        "zmin": 0.3,
        "zmax": 3.5,
        "sharpness threshold": 0.0,
        "model type": "SH1",
        "grid dim": 64,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    summary_path = str(tmp_path / "summary.json")
    proc = subprocess.run(
        [sys.executable, "-m", "psgradientsdf.cli", "--config_file", cfg_path,
         "--no-refine", "--platform", "cpu",
         "--eval-ate", os.path.join(data, "groundtruth.txt"),
         "--summary-json", summary_path],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]

    stamps, est = read_trajectory(os.path.join(out, "tracking_poses.txt"))
    assert len(est) == 8
    err = ate_rmse(est, gt_poses)
    # voxel size is 15mm; tracked trajectory should stay well under one voxel
    assert err < 0.01, f"ATE-RMSE {err*1000:.2f} mm"
    # the CLI's own --eval-ate (timestamp-associated) agrees
    with open(summary_path) as fh:
        summary = json.load(fh)
    assert summary["ate"]["pairs"] == 8
    assert abs(summary["ate"]["ate_rmse"] - err) < 1e-6
    # artifacts exist
    for f in ("init_mesh.ply", "init_pointcloud.ply", "init_sdf.sdf"):
        assert os.path.isfile(os.path.join(out, f))
