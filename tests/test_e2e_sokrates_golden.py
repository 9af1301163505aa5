"""Golden end-to-end run on the reference's shipped sokrates-mvs demo data
(SURVEY §4: energy trace decreases, artifacts well-formed, GT-pose parity).

Uses the real demo dataset if mounted at /root/reference/data/sokrates-mvs
(35 RGB-D frames + intrinsics + TUM-format GT poses); skipped otherwise.
Runs a short-budget refinement on a reduced frame range so it stays in CI
time on CPU.
"""

import json
import os

import numpy as np
import pytest

DATA = "/root/reference/data/sokrates-mvs/"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(DATA), reason="sokrates demo data not mounted"
)

from psgradientsdf.config import parse_config
from psgradientsdf.io.ply import read_ply_header
from psgradientsdf.pipeline import ReconstructionPipeline


def test_sokrates_golden(tmp_path):
    out = str(tmp_path / "out") + "/"
    cfg = parse_config({
        "input": DATA, "output": out, "pose filename": "pose.txt",
        "datatype": "multiview", "first": 0, "last": 9,
        "voxel size": 0.004, "truncation factor": 5,
        "zmin": 0.5, "zmax": 3.5, "sharpness threshold": 0.0,
        "model type": "SH1", "loss function": "cauchy",
        "reg albedo": 0.0, "reg norm": 10.0, "reg laplacian": 0.0,
        "max iter": 2, "damping": 1.0, "converge threshold": 5e-3,
        "lambda": 0.2, "upsample": False,
    }, save_copy=False)
    pipe = ReconstructionPipeline(cfg, prefetch=False)
    summary = pipe.run(refine=True)

    assert summary["frames"] == 10
    assert summary["keyframes"] == 10          # GT mode, sharpness 0.0

    # artifacts exist and are well-formed PLYs with a real surface
    nv, nf = read_ply_header(os.path.join(out, "init_mesh.ply"))
    assert nv > 5000 and nf > 5000

    # the energy trace from metrics.jsonl must be decreasing overall
    energies = []
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("event") == "energy":
                energies.append(rec["total"])
    assert len(energies) >= 3
    assert energies[-1] < energies[0]
