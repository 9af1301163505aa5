"""Timestamp association + in-repo ATE evaluation (io/trajectory.py).

The reference writes TUM-format trajectories (main_ps.cpp:262-275) and
defers ATE to the TUM benchmark's external associate.py/evaluate_ate.py;
here both live in-repo and are reachable from the CLI via --eval-ate.
"""

import numpy as np

from psgradientsdf.io.trajectory import (
    associate,
    ate_rmse,
    evaluate_ate,
    write_trajectory,
)
from psgradientsdf.utils.se3 import se3_exp


def _random_traj(n, seed):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        xi = rng.normal(size=6) * np.array([0.5, 0.5, 0.5, 0.3, 0.3, 0.3])
        poses.append(np.asarray(se3_exp(xi.astype(np.float32))))
    return poses


def test_associate_nearest_unique():
    est = ["1.000", "1.100", "1.200", "5.000"]
    gt = ["0.995", "1.104", "1.201", "1.202"]
    pairs = associate(est, gt, max_diff=0.02)
    # greedy nearest: each side used once; 5.000 has no partner, and only
    # one of the two gt stamps near 1.20 is consumed
    assert pairs == [(0, 0), (1, 1), (2, 2)]


def test_associate_nonnumeric_falls_back_positional():
    assert associate(["a", "b"], ["x", "y", "z"]) == [(0, 0), (1, 1)]


def test_evaluate_ate_rigid_transform_is_zero(tmp_path):
    poses = _random_traj(12, seed=0)
    stamps = [f"{1.0 + 0.05 * i:.4f}" for i in range(12)]
    # apply one global rigid transform: Umeyama alignment must absorb it
    M = np.asarray(se3_exp(np.array([0.2, -0.1, 0.3, 0.4, 0.2, -0.3],
                                    np.float32)))
    moved = [M @ T for T in poses]
    est_f, gt_f = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    assert write_trajectory(est_f, stamps, moved)
    assert write_trajectory(gt_f, stamps, poses)
    res = evaluate_ate(est_f, gt_f)
    assert res["pairs"] == 12
    assert res["ate_rmse"] < 1e-5


def test_evaluate_ate_detects_error_and_skips_unmatched(tmp_path):
    poses = _random_traj(10, seed=1)
    stamps = [f"{2.0 + 0.1 * i:.4f}" for i in range(10)]
    rng = np.random.default_rng(2)
    noisy = [T.copy() for T in poses]
    for T in noisy:
        T[:3, 3] += rng.normal(scale=0.05, size=3)
    est_f, gt_f = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    # ground truth has extra rows far outside the estimate's time range
    extra_stamps = stamps + ["99.0", "100.0"]
    extra_poses = poses + _random_traj(2, seed=3)
    assert write_trajectory(est_f, stamps, noisy)
    assert write_trajectory(gt_f, extra_stamps, extra_poses)
    res = evaluate_ate(est_f, gt_f)
    assert res["pairs"] == 10 and res["gt_poses"] == 12
    assert 0.0 < res["ate_rmse"] < 0.2
    # consistent with the positional metric on the matched subset
    # (atol covers the trajectory file's decimal quantization)
    assert np.isclose(res["ate_rmse"], ate_rmse(noisy, poses), atol=1e-4)


def test_evaluate_ate_no_overlap(tmp_path):
    est_f, gt_f = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    assert write_trajectory(est_f, ["1.0"], _random_traj(1, 4))
    assert write_trajectory(gt_f, ["9.0"], _random_traj(1, 5))
    res = evaluate_ate(est_f, gt_f)
    assert res["pairs"] == 0 and res["ate_rmse"] is None
