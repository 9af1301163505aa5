"""The parts of chip_smoke.py that run without a GPU: its seeded dataset
and its refusal to run anywhere but on a CUDA device."""

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from psgradientsdf.io.loaders import make_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dataset_is_seeded_and_loads_as_tum(tmp_path):
    a, b, c = (str(tmp_path / n) + "/" for n in "abc")
    gt = chip_smoke.write_tum_dataset(a, n_frames=3, seed=7, width=64,
                                      height=48)
    chip_smoke.write_tum_dataset(b, n_frames=3, seed=7, width=64, height=48)
    chip_smoke.write_tum_dataset(c, n_frames=3, seed=8, width=64, height=48)
    for rel in ("associated.txt", "groundtruth.txt", "intrinsics.txt"):
        assert filecmp.cmp(a + rel, b + rel, shallow=False), rel
    frames = sorted(os.listdir(a + "depth"))
    assert len(frames) == 3
    for sub in ("depth", "rgb"):
        for name in frames:
            assert filecmp.cmp(f"{a}{sub}/{name}", f"{b}{sub}/{name}",
                               shallow=False), (sub, name)
    assert not filecmp.cmp(f"{a}depth/{frames[0]}", f"{c}depth/{frames[0]}",
                           shallow=False)

    loader = make_loader("tum", a)
    assert loader.load_intrinsics()
    assert loader.K[0, 0] == pytest.approx(0.9 * 64)
    poses = loader.load_pose("groundtruth.txt")
    assert len(poses) == 3
    np.testing.assert_allclose(poses[1], gt[1], atol=1e-5)
    color, depth = loader.load_next()
    assert color.shape == (48, 64, 3) and depth.shape == (48, 64)
    assert 0.0 <= color.min() and color.max() <= 1.0
    valid = depth[depth > 0]
    assert valid.size > 0.9 * depth.size
    assert 0.9 < np.median(valid) < 1.6          # the heightfield at ~1.2 m


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(tmp_path, where):
    """On the CPU (and in a directory holding only the script) it exits
    non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
