"""Cross-implementation numerical parity: C++ hot-loop baseline vs JAX path.

bench/cpp_baseline.cpp is a plain single-threaded C++ reimplementation of the
reference's two hot loops (tracking RigidPointOptimizer.cpp:27-76, fusion
VolumetricGradSdf.cpp:78-134) with the reference's AoS layout and budgets.
This test runs it with `dump_path` on a small scenario and replays the *same*
scenario through the framework's jitted fuse_frame/track_frame.

Two parity regimes, asserted separately:

  * Fusion at *identical* poses is deterministic math -> the two
    independently written implementations must agree voxel-for-voxel to
    float accumulation noise (~1e-6).  We replay JAX fusion at the C++
    run's own tracked poses to test the full 4-frame accumulation chain
    (running means, gradient accumulation, gates) tightly.

  * Tracking stops when ||xi|| < sqrt(conv_threshold_sq) = 1e-3, so each
    implementation legitimately halts up to ~1e-3 away from the minimum
    along a path-dependent trajectory (the point-to-SDF objective is
    piecewise-linear in the correspondences; measured: C++ takes 46
    iterations where XLA's tree-reduced normal equations take 16).  Poses
    are therefore compared at the stopping-radius scale (5e-3), and
    iteration counts only sanity-checked against the budget.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import jax.numpy as jnp

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import make_volume, fuse_frame
from psgradientsdf.tracking.tracker import track_frame
from psgradientsdf.utils.se3 import se3_exp

W, H, DIM, FRAMES = 64, 48, 32, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpp(tmp_path, W=W, H=H, DIM=DIM, FRAMES=FRAMES):
    src = os.path.join(REPO, "bench", "cpp_baseline.cpp")
    binp = str(tmp_path / "cpp_baseline")
    dump = str(tmp_path / "dump.bin")
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-o", binp, src],
        check=True, capture_output=True,
    )
    subprocess.run(
        [binp, str(W), str(H), str(DIM), str(FRAMES), dump],
        check=True, capture_output=True,
    )
    with open(dump, "rb") as f:
        w, h, dim, frames = struct.unpack("4i", f.read(16))
        assert (w, h, dim, frames) == (W, H, DIM, FRAMES)
        poses, iters = [], []
        for _ in range(frames):
            poses.append(
                np.frombuffer(f.read(64), dtype=np.float32).reshape(4, 4)
            )
            iters.append(struct.unpack("i", f.read(4))[0])
        nv = dim ** 3
        dist = np.frombuffer(f.read(4 * nv), dtype=np.float32)
        weight = np.frombuffer(f.read(4 * nv), dtype=np.float32)
        grad = np.frombuffer(f.read(12 * nv), dtype=np.float32).reshape(nv, 3)
        red = np.frombuffer(f.read(4 * nv), dtype=np.float32)
    return poses, iters, dist, weight, grad, red


def _scene(W=W, H=H):
    """Exact replica of cpp_baseline.cpp's synthetic scene."""
    fx = fy = 0.9 * W
    cx, cy = W / 2.0, H / 2.0
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    x0 = np.broadcast_to((u - cx) / fx, (H, W)).astype(np.float32)
    y0 = np.broadcast_to((v - cy) / fy, (H, W)).astype(np.float32)
    depth = (
        1.2 + 0.08 * np.sin(6 * x0) * np.cos(5 * y0)
        + 0.05 * np.sin(3 * (x0 + y0))
    ).astype(np.float32)
    dgx = 0.08 * 6 * np.cos(6 * x0) * np.cos(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
    dgy = -0.08 * 5 * np.sin(6 * x0) * np.sin(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
    n = np.stack([-dgx, -dgy, np.ones_like(dgx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nsq = 1.0 / (1.0 + x0 ** 2 + y0 ** 2)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    color = np.full((H, W, 3), 0.5, dtype=np.float32)
    return K, depth, n.astype(np.float32), nsq.astype(np.float32), color


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_cpp_vs_jax_track_fuse_parity(tmp_path):
    cpp_poses, cpp_iters, cpp_dist, cpp_weight, cpp_grad, cpp_r = _run_cpp(tmp_path)

    h = 1.8 / DIM
    T = 5.0 * h
    geom = GridGeometry(dims=(DIM, DIM, DIM), voxel_size=h, shift=(0.0, 0.0, 1.2))
    K, depth, normals, nsq, color = _scene()
    fuse_kw = dict(truncation=T, zmin=0.5, zmax=3.5)
    args = (
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(normals),
        jnp.asarray(nsq), jnp.asarray(K),
    )

    vol = make_volume(geom, T, frame_cap=32)
    vol = fuse_frame(
        vol, geom, *args, jnp.eye(4, dtype=jnp.float32), jnp.int32(0), **fuse_kw
    )

    # --- tracking: same initial volume, same starting offset as the C++ run.
    # Both solvers stop at ||xi|| < 1e-3, so their fixed points may differ
    # by the stopping radius; compare at that scale.
    xi0 = jnp.array([0.004, -0.003, 0.005, 0.002, -0.002, 0.0015], jnp.float32)
    off = se3_exp(xi0)
    res = track_frame(
        vol, geom, jnp.asarray(depth), jnp.asarray(K), off,
        truncation=T, zmin=0.5, zmax=3.5, num_iterations=50,
        conv_threshold_sq=1e-6, damping=1.0, early_exit=True,
        regather_every=1,
    )
    jpose = np.asarray(res.pose)
    assert bool(res.converged)
    assert 1 <= int(res.iterations) <= 50
    assert 1 <= cpp_iters[0] <= 50
    assert np.allclose(jpose[:3, :3], cpp_poses[0][:3, :3], atol=5e-3)
    assert np.allclose(jpose[:3, 3], cpp_poses[0][:3, 3], atol=5e-3)
    # both implementations drove the point-to-SDF energy into the noise
    # floor relative to the initial offset's energy
    assert float(res.energy) < 5e-3

    # --- fusion at IDENTICAL poses: replay the C++ run's own tracked poses
    # through the JAX fusion kernel -> the 4-frame accumulation chain
    # (running means of dist/color, gradient accumulation, z/normal/angle
    # gates) must agree voxel-for-voxel to accumulation noise.
    for f in range(FRAMES):
        vol = fuse_frame(
            vol, geom, *args, jnp.asarray(cpp_poses[f]), jnp.int32(f + 1),
            **fuse_kw,
        )

    dist = np.asarray(vol.dist).reshape(-1)
    weight = np.asarray(vol.weight).reshape(-1)
    grad = np.asarray(vol.grad).reshape(-1, 3)
    red = np.asarray(vol.color[..., 0]).reshape(-1)

    def frac_mismatch(a, b, atol):
        return np.mean(~np.isclose(a, b, atol=atol, rtol=0))

    # identical poses -> only voxels within one ULP of a gate threshold may
    # take different branches; everything else matches tightly
    assert frac_mismatch(weight, cpp_weight, 1e-4) < 1e-4
    assert frac_mismatch(dist, cpp_dist, 1e-5) < 1e-4
    assert frac_mismatch(grad.reshape(-1), cpp_grad.reshape(-1), 1e-4) < 1e-4
    assert frac_mismatch(red, cpp_r, 1e-5) < 1e-4

    # and the agreeing-weight bulk must agree everywhere else too; voxels
    # with near-zero weight are gate-borderline (fusion weight 1 + sdf/T
    # within one ULP of 0 at sdf = -T): one side includes them with w~1e-7,
    # the other excludes them, leaving dist at its init value
    m = np.isclose(weight, cpp_weight, atol=1e-4, rtol=0) & (cpp_weight > 1e-3)
    assert np.abs(dist[m] - cpp_dist[m]).max() < 1e-4
    assert np.abs(red[m] - cpp_r[m]).max() < 1e-5
