"""Converged goldens (VERDICT round-1 weak #5/#8): regression-pin the
alternating refinement's converged behavior, not just smoke it.

- LED golden: synthetic near-field scene through the FULL pipeline with the
  LED model; the energy trace must fall ~80x and the loop must terminate
  the reference way (rel-dE convergence or the divergence abort after the
  floor is reached).
- sokrates golden: the real 34-frame demo to convergence — only meaningful
  on the GPU (megapixel keyframes; hours on CPU), so it runs when the
  session's default backend is a GPU and skips under the CPU test
  harness.  The pinned trace (after the round-2 keyframe-scale fix that
  put the raw-wire pipeline's images on the reference's [0,1] scale):
  energy 54.6 -> 9.56, converged in 9 outer iterations, final mesh ~43.8k
  vertices.  These are accuracy pins, not speed.

The two GPU goldens carry the `gpu` marker:
    PSGSDF_TEST_GPU=1 python -m pytest tests/test_goldens.py -m gpu -q
"""

import json
import os

import numpy as np
import pytest

from psgradientsdf.config import parse_config
from psgradientsdf.pipeline import ReconstructionPipeline

from test_e2e_led_cli import make_led_dataset


def _energy_trace(metrics_path):
    totals = []
    for line in open(metrics_path):
        d = json.loads(line)
        if d.get("event") == "iteration":
            totals.append(float(d["total"]))
    return totals


@pytest.mark.slow
def test_led_converged_golden(tmp_path):
    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    make_led_dataset(data)
    raw = {
        "input": data, "output": out, "pose filename": "pose.txt",
        "datatype": "led", "first": 0, "last": 5, "voxel size": 0.02,
        "truncation factor": 5, "zmin": 0.3, "zmax": 3.5,
        "sharpness threshold": 0.0, "model type": "LED",
        "loss function": "cauchy", "lambda": 0.2, "reg norm": 0.5,
        "max iter": 25, "grid dim": 48, "converge threshold": 1e-4,
    }
    cfg = parse_config(raw)
    pipe = ReconstructionPipeline(cfg, prefetch=False)
    pipe.run(refine=True)

    totals = _energy_trace(out + "metrics.jsonl")
    # calibrated on 2026-08-20: trace 0.805 -> 0.0103 over 6 iterations,
    # then the reference's divergence abort fires at the noise floor
    assert totals[0] > 0.5, totals[:3]
    assert min(totals) < 0.015, min(totals)
    assert totals[-1] < 0.03, totals[-1]
    # strictly decreasing until the floor
    floor = min(totals)
    k = totals.index(floor)
    assert k >= 3
    assert all(a > b for a, b in zip(totals[:k], totals[1:k + 1])), totals
    # artifacts of a finished run
    assert os.path.exists(out + "final_refined_mesh.ply")
    assert os.path.exists(out + "refined_sdf.sdf") or os.path.exists(
        out + "final_refined_pointcloud.ply")


@pytest.mark.slow
@pytest.mark.gpu
def test_sokrates_converged_golden(tmp_path):
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("sokrates 34-frame golden runs on the GPU only "
                    "(megapixel keyframes; hours on CPU)")
    raw = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "sokrates.json")))
    data = raw["input"]
    if not os.path.isdir(data):
        pytest.skip("sokrates demo data unavailable")
    out = str(tmp_path / "out") + "/"
    raw["output"] = out
    cfg = parse_config(raw)
    pipe = ReconstructionPipeline(cfg)
    summary = pipe.run(refine=True)

    totals = _energy_trace(out + "metrics.jsonl")
    # pinned (2026-08-21, [0,1]-scale images): 54.6 -> 9.56,
    # rel-dE < 5e-3 within 9 iterations
    assert summary["refine_converged"], summary
    assert totals[0] > 30, totals[0]
    assert totals[-1] <= 12, totals[-1]
    assert len(totals) <= 20, len(totals)
    # mesh vertex-count window (measured 43.8k vertices at 128^3; init mesh
    # 41.9k — refinement must neither collapse nor balloon the surface)
    header = open(out + "final_refined_mesh.ply", "rb").read(400).decode(
        "latin1")
    n_verts = int([l for l in header.splitlines()
                   if l.startswith("element vertex")][0].split()[-1])
    assert 2e4 < n_verts < 2e5, n_verts


@pytest.mark.slow
@pytest.mark.gpu
def test_led_upsample_production_golden(tmp_path):
    """Basket-LED-recipe rehearsal at production shape (round-2 VERDICT
    #8): the LED model with the shipped config_basket_LED.json settings
    (voxel 0.01, cauchy lam=0.2, reg_n=0.1, reg_l=5.0, damping 3.0,
    upsample) over a 640x480 synthetic near-field sequence with sensor
    noise (4 mm depth, 3 mm/0.003 rad pose) at a 128^3 grid.  Calibrated
    2026-08-21 with bench/led_rehearsal.py: energy descends
    21.85 -> 19.78 over six iterations, the iteration-5 upsample fires
    (128^3 -> 256^3 at voxel 0.005, ~197k surface voxels), the
    post-upsample blocks run at the new scale, and the loop ends by the
    reference's own accounting (divergence abort at the renormalized
    scale or convergence).  GPU-gated: megapixel-scale keyframes are
    hours on CPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("production-shape LED golden runs on the GPU only")

    from test_e2e_led_cli import make_led_dataset

    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    make_led_dataset(data, n_frames=12, H=480, W=640, f=576.0,
                     depth_noise=0.004, pose_noise=0.003)
    raw = {
        "input": data, "output": out, "pose filename": "pose.txt",
        "datatype": "led", "first": 0, "last": 11,
        "voxel size": 0.01, "truncation factor": 5,
        "zmin": 0.5, "zmax": 3.5, "sharpness threshold": 0.0,
        "model type": "LED", "loss function": "cauchy",
        "reg albedo": 0.0, "reg norm": 0.1, "reg laplacian": 5.0,
        "max iter": 9, "damping": 3.0, "converge threshold": 1e-4,
        "lambda": 0.2, "upsample": True, "grid dim": 128,
    }
    cfg = parse_config(raw)
    pipe = ReconstructionPipeline(cfg)
    summary = pipe.run(refine=True)
    assert summary["keyframes"] == 12, summary

    totals = _energy_trace(out + "metrics.jsonl")
    ups = [json.loads(l) for l in open(out + "metrics.jsonl")
           if '"event": "upsample"' in l]
    # pre-upsample: monotone descent through six iterations
    assert len(totals) >= 6, totals
    assert all(a > b for a, b in zip(totals[:5], totals[1:6])), totals
    # the total carries the frozen pre-upsample Laplacian constant
    # (~19.5), so assert the descent absolutely
    # (measured drop 2.07) rather than as a ratio of the total
    assert totals[0] - totals[5] > 1.0, totals
    # the production-shape event: iteration-5 upsample to 256^3
    assert len(ups) == 1, ups
    assert ups[0]["dims"] == [256, 256, 256], ups
    assert ups[0]["surface_voxels"] > 1e5, ups
    # post-upsample blocks executed at the new scale (a 7th total exists)
    assert len(totals) >= 7, totals
    # terminal artifacts of a finished run
    assert os.path.exists(out + "final_refined_mesh.ply")
    header = open(out + "final_refined_mesh.ply", "rb").read(400).decode(
        "latin1")
    n_verts = int([l for l in header.splitlines()
                   if l.startswith("element vertex")][0].split()[-1])
    assert n_verts > 3e4, n_verts
