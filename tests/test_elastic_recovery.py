"""Elastic recovery (SURVEY §5.3 — absent in the reference): a runtime
failure mid-scan is retried by the CLI, resuming from the latest
--checkpoint-every scan checkpoint, and the run completes with a full
trajectory."""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_e2e_tum_tracking import make_tum_dataset  # noqa: E402


def test_cli_retries_resume_from_checkpoint(tmp_path, monkeypatch):
    import jax
    jax.config.update("jax_platforms", "cpu")
    monkeypatch.setenv("PSGSDF_RETRY_BACKOFF", "0")

    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    make_tum_dataset(data)
    cfg = {
        "input": data, "output": out, "pose filename": "nope.txt",
        "datatype": "tum", "first": 0, "last": 7,
        "voxel size": 0.015, "truncation factor": 5,
        "zmin": 0.3, "zmax": 3.5, "sharpness threshold": 0.0,
        "model type": "SH1", "grid dim": 64, "chunk size": 2,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    # inject ONE failure after the second chunk of the first attempt
    from psgradientsdf import pipeline as pipe_mod
    real = pipe_mod.process_chunk
    calls = {"n": 0, "failed": False}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3 and not calls["failed"]:
            calls["failed"] = True
            raise RuntimeError("injected device drop")
        return real(*a, **kw)

    monkeypatch.setattr(pipe_mod, "process_chunk", flaky)

    from psgradientsdf import cli
    rc = cli.main([
        "--config_file", cfg_path, "--no-refine", "--platform", "cpu",
        "--checkpoint-every", "2", "--retries", "2",
    ])
    assert rc == 0
    assert calls["failed"]

    # full trajectory despite the mid-scan failure
    from psgradientsdf.io.trajectory import ate_rmse, read_trajectory
    _, est = read_trajectory(os.path.join(out, "tracking_poses.txt"))
    assert len(est) == 8
    _, gt = read_trajectory(os.path.join(data, "groundtruth.txt"))
    assert ate_rmse(est, gt) < 0.01

    # the resume actually happened (metrics has a resume event)
    events = [json.loads(l)["event"] for l in open(os.path.join(out, "metrics.jsonl"))]
    assert "resume" in events


def test_cli_retry_skips_torn_refine_checkpoint(tmp_path, monkeypatch):
    """A refine checkpoint torn mid-write (sidecar present, .refine payload
    missing) must NOT be selected by the elastic retry — it falls back to
    the scan checkpoint and still completes."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    monkeypatch.setenv("PSGSDF_RETRY_BACKOFF", "0")

    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    make_tum_dataset(data)
    cfg = {
        "input": data, "output": out, "pose filename": "nope.txt",
        "datatype": "tum", "first": 0, "last": 7,
        "voxel size": 0.015, "truncation factor": 5,
        "zmin": 0.3, "zmax": 3.5, "sharpness threshold": 0.0,
        "model type": "SH1", "grid dim": 64, "chunk size": 2,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    from psgradientsdf import pipeline as pipe_mod
    real = pipe_mod.process_chunk
    calls = {"n": 0, "failed": False}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3 and not calls["failed"]:
            calls["failed"] = True
            # fabricate a torn refine checkpoint, newer than the scan one:
            # main npz + phase=refine sidecar but NO .refine payload
            p = os.path.join(out, "refine_checkpoint.npz")
            np.savez(p.replace(".npz", ""), torn=np.zeros(1))
            with open(p + ".json", "w") as fh:
                json.dump({"geometry": {"dims": [64, 64, 64],
                                        "voxel_size": 0.015,
                                        "shift": [0, 0, 0]},
                           "meta": {"phase": "refine"}}, fh)
            raise RuntimeError("injected device drop")
        return real(*a, **kw)

    monkeypatch.setattr(pipe_mod, "process_chunk", flaky)

    from psgradientsdf import cli
    rc = cli.main([
        "--config_file", cfg_path, "--no-refine", "--platform", "cpu",
        "--checkpoint-every", "2", "--retries", "2",
    ])
    assert rc == 0
    assert calls["failed"]

    # the retry resumed from the SCAN checkpoint despite the newer (torn)
    # refine one, and the run completed with a full trajectory
    from psgradientsdf.io.trajectory import read_trajectory
    _, est = read_trajectory(os.path.join(out, "tracking_poses.txt"))
    assert len(est) == 8
    lines = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    resumes = [l for l in lines if l["event"] == "resume"]
    assert resumes and all("scan_checkpoint" in r["path"] for r in resumes)
