"""Scan checkpoint/resume: an interrupted pipeline resumed from a checkpoint
produces exactly the same trajectory, volume, and keyframes as an
uninterrupted run (SURVEY §5.4 — the reference restarts from scratch)."""

import json
import os

import numpy as np

from psgradientsdf.config import parse_config
from psgradientsdf.pipeline import ReconstructionPipeline
from tests.test_e2e_tum_tracking import make_tum_dataset


def make_cfg(data, out, last):
    return parse_config({
        "input": data, "output": out, "datatype": "tum",
        "pose filename": "no_such_pose_file.txt",
        "first": 0, "last": last, "voxel size": 0.015,
        "truncation factor": 5, "zmin": 0.3, "zmax": 3.5,
        "sharpness threshold": 0.0, "model type": "SH1",
        "grid dim": 48, "chunk size": 3,
    }, save_copy=False)


def test_resume_matches_uninterrupted(tmp_path):
    data = str(tmp_path / "data") + "/"
    make_tum_dataset(data, n_frames=8, H=64, W=80)

    # uninterrupted run
    out_a = str(tmp_path / "a") + "/"
    pa = ReconstructionPipeline(make_cfg(data, out_a, 7), prefetch=False)
    pa.run(refine=False)

    # interrupted at frame 4 (checkpoint every 2 frames), then resumed
    out_b = str(tmp_path / "b") + "/"
    pb = ReconstructionPipeline(make_cfg(data, out_b, 4), prefetch=False,
                                checkpoint_every=2)
    pb.run(refine=False)
    ck = os.path.join(out_b, "scan_checkpoint.npz")
    assert os.path.exists(ck)

    out_c = str(tmp_path / "c") + "/"
    pc = ReconstructionPipeline(make_cfg(data, out_c, 7), prefetch=False,
                                resume=ck)
    pc.run(refine=False)

    # resumed trajectory must be a prefix-consistent continuation; compare
    # the full files: resume restored pose_lines, so line sets must be equal
    # from the resumed frame onward, and the final poses identical.
    lines_a = open(os.path.join(out_a, "tracking_poses.txt")).read().splitlines()
    lines_c = open(os.path.join(out_c, "tracking_poses.txt")).read().splitlines()
    assert len(lines_a) == len(lines_c) == 8
    # the checkpoint was taken at a chunk boundary <= frame 4; all lines after
    # it are recomputed — they must match the uninterrupted run's exactly
    assert lines_a == lines_c

    # volumes identical
    np.testing.assert_array_equal(np.asarray(pa.vol.dist), np.asarray(pc.vol.dist))
    np.testing.assert_array_equal(np.asarray(pa.vol.weight), np.asarray(pc.vol.weight))
    np.testing.assert_array_equal(np.asarray(pa.vol.vis), np.asarray(pc.vol.vis))
    assert pa.geom == pc.geom
