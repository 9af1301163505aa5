"""End-to-end: synthetic order-2 SH dataset -> CLI pipeline with the SH2
model -> full alternating refinement (round-4 VERDICT #7).

Exercises the order-2 light path (9-coeff SH basis + dSH/dn-hat distance
Jacobian, cpp/include/ps_optimizer/PsOptimizerJa.cpp:17-28,160-289) through
the FULL pipeline — config parse ("model type": "SH2"), scan, keyframe
selection, all four refinement blocks — not just the unit/loop tests.

The scene is shaded with a light that has REAL quadratic SH content, so
the order-2 light solve has signal to chase; the test pins that the
9-coeff lights materialize AND that their quadratic coefficients move off
the zero init (the light block's order-2 columns do real work), plus the
usual artifact/energy-descent checks.  (A "final SH2 energy < SH1 energy"
separation is NOT testable here: the per-voxel free albedo can absorb any
static normal-dependent shading, so SH1 fits this scene too — measured.)
"""

import json
import os

import numpy as np

from psgradientsdf.io import png

from psgradientsdf import cli
from psgradientsdf.config import load_config
from psgradientsdf.pipeline import ReconstructionPipeline


# order-2 SH basis, reference layout (PsOptimizerJa.cpp:17-28)
def _sh2(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    return np.stack([np.ones_like(nx), nx, ny, nz, nx * ny, nx * nz,
                     ny * nz, nx * nx - ny * ny, nx * nx - nz * nz], -1)


LIGHT_SH2 = np.array([0.55, 0.05, -0.04, -0.45,          # SH1 part
                      0.15, -0.12, 0.10, 0.18, -0.14])   # quadratic part


def make_sh2_dataset(root, n_frames=6, H=64, W=80, f=70.0):
    """SynthLoader layout (depth/NNN.png + rgb/NNN.png, unit 1/1000) with
    GT poses; images shaded I = albedo * (l . SH2(n_out))."""
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
        return (1.2 + 0.10 * np.sin(5 * px) * np.cos(4 * py)
                + 0.05 * np.sin(3 * (px + py)))

    gt_lines = []
    for i in range(n_frames):
        T = np.eye(4)
        T[:3, 3] = [0.004 * i, -0.003 * i, 0.0]
        z = np.full((H, W), 1.2)
        for _ in range(30):
            pc = np.stack([x0 * z, y0 * z, z], -1)
            pw = pc @ T[:3, :3].T + T[:3, 3]
            z = z + 0.9 * (surf_z(pw[..., 0], pw[..., 1]) - pw[..., 2])
        pc = np.stack([x0 * z, y0 * z, z], -1)
        pw = pc @ T[:3, :3].T + T[:3, 3]
        # outward (toward-camera) world normal of the heightfield
        eps = 1e-3
        gx = (surf_z(pw[..., 0] + eps, pw[..., 1])
              - surf_z(pw[..., 0] - eps, pw[..., 1])) / (2 * eps)
        gy = (surf_z(pw[..., 0], pw[..., 1] + eps)
              - surf_z(pw[..., 0], pw[..., 1] - eps)) / (2 * eps)
        n = np.stack([gx, gy, -np.ones_like(gx)], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        irr = np.maximum(_sh2(n) @ LIGHT_SH2, 0.0)
        albedo = np.stack([
            0.45 + 0.25 * np.sin(6 * pw[..., 0]),
            0.50 + 0.20 * np.cos(5 * pw[..., 1]),
            0.55 * np.ones_like(z),
        ], -1)
        rgb = np.clip(albedo * irr[..., None], 0, 1)

        stamp = f"{i + 1:03d}"
        png.write(os.path.join(root, "depth", stamp + ".png"),
                  np.clip(z * 1000.0, 0, 65535).astype(np.uint16))
        png.write(os.path.join(root, "rgb", stamp + ".png"),
                  np.clip(rgb * 255, 0, 255).astype(np.uint8))
        t = T[:3, 3]
        gt_lines.append(f"{stamp} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} 0 0 0 1")

    with open(os.path.join(root, "pose.txt"), "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")


def _write_cfg(tmp_path, data, model):
    out = str(tmp_path / f"out_{model}") + "/"
    cfg = {
        "input": data, "output": out, "pose filename": "pose.txt",
        "datatype": "led", "first": 0, "last": 5,
        "voxel size": 0.02, "truncation factor": 5,
        "zmin": 0.3, "zmax": 3.5, "sharpness threshold": 0.0,
        "model type": model, "loss function": "cauchy", "lambda": 0.2,
        "reg norm": 0.5, "max iter": 4, "grid dim": 48,
    }
    cfg_path = str(tmp_path / f"cfg_{model}.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    return cfg_path, out


def _final_ps(out):
    ps = [json.loads(l)["ps"] for l in open(os.path.join(out, "metrics.jsonl"))
          if json.loads(l).get("event") == "energy"]
    assert ps, "no energy events logged"
    return ps[-1]


def test_sh2_cli_end_to_end(tmp_path):
    data = str(tmp_path / "data") + "/"
    make_sh2_dataset(data)

    # ---- SH2 through the real CLI surface
    cfg_path, out = _write_cfg(tmp_path, data, "SH2")
    assert cli.main(["--config_file", cfg_path]) == 0
    for name in ("init_mesh.ply", "final_refined_mesh.ply",
                 "final_refined_pointcloud.ply", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, name)), name
    totals = []
    for line in open(os.path.join(out, "metrics.jsonl")):
        rec = json.loads(line)
        if rec.get("event") == "iteration":
            totals.append(rec["total"])
    assert len(totals) >= 1 and np.isfinite(totals).all()
    if len(totals) >= 2:
        assert totals[-1] <= totals[0] * 1.001, totals
    assert np.isfinite(_final_ps(out))

    # ---- the order-2 state really materialized and did real work
    # (pipeline API on the same config — the object the CLI drives)
    (tmp_path / "b").mkdir()
    cfg_path2, out_b = _write_cfg(tmp_path / "b", data, "SH2")
    pipe = ReconstructionPipeline(load_config(cfg_path2), prefetch=False)
    pipe.run(refine=True)
    assert pipe.refiner.cfg.order == 2
    lights = np.asarray(pipe.refiner.lights)
    assert lights.shape[-1] == 9
    # the quadratic columns start at exactly 0 (init from the rotated -z
    # direction, PsOptimizer.cpp:25-42); the light solves must have moved
    # them — the order-2 basis/Jacobian columns are live, not padding
    assert np.abs(lights[:, 4:]).max() > 1e-4, lights
