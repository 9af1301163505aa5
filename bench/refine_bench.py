"""Refinement distance-block benchmark: device vs the C++ CPU baseline.

Same scenario as bench/cpp_refine_baseline.cpp: the synthetic wavy scene
fused once at identity, surface band extracted, F keyframes all-visible with
identity poses and SH1 lights, Cauchy lambda=0.2 — then ONE full distance
block (residual + 4-voxel-stencil Jacobian + CG on J^T W J with
multiplicative damping, 100 CG iterations) is timed on each side.

Device time is measured by the in-jit repetition delta (K chained blocks in
one executable vs 1), which cancels the per-call dispatch and fetch
overhead.  Import and call run(log) -> dict.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, DIM, FRAMES = 640, 480, 128, 20


def _cpp(log) -> dict:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cpp_refine_baseline.cpp")
    binp = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "native", "build", "cpp_refine_baseline")
    os.makedirs(os.path.dirname(binp), exist_ok=True)
    if not os.path.exists(binp) or os.path.getmtime(binp) < os.path.getmtime(src):
        log("[refine-bench] compiling C++ refinement baseline ...")
        subprocess.run(["g++", "-O3", "-std=c++17", "-o", binp, src], check=True)
    log("[refine-bench] running C++ refinement baseline (best of 3) ...")
    runs = []
    for _ in range(3):
        out = subprocess.run(
            [binp, str(W), str(H), str(DIM), str(FRAMES)],
            check=True, capture_output=True, text=True, timeout=1800,
        ).stdout
        runs.append(json.loads(out))
    # fastest rep per metric = strongest baseline; single-shot numbers
    # swung dist_block_s by up to 2.5x under host load
    best = dict(runs[0])
    best["dist_block_s"] = min(r["dist_block_s"] for r in runs)
    best["find_variant_dist_block_s"] = min(
        r["find_variant_dist_block_s"] for r in runs)
    return best


def _device(log) -> dict:
    import jax
    import jax.numpy as jnp

    log(f"[refine-bench] devices: {jax.devices()}")

    from psgradientsdf.core.grid import GridGeometry
    from psgradientsdf.core.volume import fuse_frame, make_volume
    from psgradientsdf.refine.optimizer import _dist_block
    from psgradientsdf.refine.problem import extract_problem
    from psgradientsdf.utils import sh as sh_mod

    h = 1.8 / DIM
    T = 5 * h
    geom = GridGeometry(dims=(DIM, DIM, DIM), voxel_size=h, shift=(0.0, 0.0, 1.2))

    fx = fy = 0.9 * W
    cxx, cyy = W / 2.0, H / 2.0
    cols = np.arange(W, dtype=np.float32)[None, :]
    rows = np.arange(H, dtype=np.float32)[:, None]
    x0 = np.broadcast_to((cols - cxx) / fx, (H, W))
    y0 = np.broadcast_to((rows - cyy) / fy, (H, W))
    depth = (1.2 + 0.08 * np.sin(6 * x0) * np.cos(5 * y0)
             + 0.05 * np.sin(3 * (x0 + y0))).astype(np.float32)
    dgx = 0.08 * 6 * np.cos(6 * x0) * np.cos(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
    dgy = -0.08 * 5 * np.sin(6 * x0) * np.sin(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
    n = np.stack([-dgx, -dgy, np.ones_like(dgx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    shade = (0.3 + 0.5 * np.abs(n[..., 2])).astype(np.float32)
    img = np.stack([shade, shade * 0.9, shade * 0.8], axis=-1).astype(np.float32)
    K_np = np.array([[fx, 0, cxx], [0, fy, cyy], [0, 0, 1]], dtype=np.float32)
    nsq = (1.0 / (1.0 + x0 ** 2 + y0 ** 2)).astype(np.float32)

    vol = make_volume(geom, T, frame_cap=32)
    eye = jnp.eye(4, dtype=jnp.float32)
    vol = fuse_frame(
        vol, geom, jnp.asarray(img), jnp.asarray(depth),
        jnp.asarray(n.astype(np.float32)), jnp.asarray(nsq), jnp.asarray(K_np),
        eye, jnp.int32(0), truncation=T, zmin=0.5, zmax=3.5,
        # the C++ refine baseline's fusion has no angle gate
        cos_thresh_sq=0.0,
    )
    jax.block_until_ready(vol.dist)

    # all keyframes alias fused frame 0 => visible-in-all, identity poses
    prob = extract_problem(vol, geom, [0] * FRAMES)
    n_surf = int(prob.n_surface)
    log(f"[refine-bench] surface voxels: {n_surf} (capacity {prob.dist.shape[0]})")

    images = jnp.asarray(np.repeat(img[None], FRAMES, axis=0))
    poses = jnp.asarray(np.repeat(np.eye(4, dtype=np.float32)[None], FRAMES, axis=0))
    Kj = jnp.asarray(K_np)
    dirs = jnp.asarray(np.repeat(np.array([[0.0, 0.0, -1.0]], np.float32), FRAMES, 0))
    lights = sh_mod.sh_basis(dirs, 1).at[:, 0].set(0.02)

    static = dict(model="SH1", order=1, loss=1, lam=0.2, voxel_size=geom.voxel_size,
                  reg_weight_n=0.0, reg_weight_l=0.0, damping=1.0,
                  laplacian_diag_only=False)

    import functools
    import jax.numpy as jnp  # noqa: F811

    def make(K_blocks):
        @jax.jit
        def f(dist0, grad0):
            def body(k, carry):
                dist, grad = carry
                # perturb so successive blocks are not CSE-able
                d2, g2 = _dist_block.__wrapped__(
                    prob, geom, dist + 0.0 * k, prob.albedo, grad, poses, images,
                    Kj, lights, **static)
                return (d2, g2)
            return jax.lax.fori_loop(0, K_blocks, body, (dist0, grad0))
        return f

    f1, f5 = make(1), make(5)
    # warm with inputs distinct from every timed call; each timed call ends
    # in a D2H fetch of a value that depends on the whole program
    _ = float(jnp.sum(f1(prob.dist + 1e-3, prob.grad_stored)[0]))
    _ = float(jnp.sum(f5(prob.dist + 2e-3, prob.grad_stored)[0]))

    def t(f):
        best = 1e9
        for r in range(3):
            d0 = prob.dist + 1e-6 * (r + 1)
            t0 = time.perf_counter()
            _ = float(jnp.sum(f(d0, prob.grad_stored)[0]))  # real fence
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t5 = t(f1), t(f5)
    per_block = (t5 - t1) / 4.0

    # auditable floor (round-4 VERDICT #6): XLA's own cost analysis of the
    # compiled ONE-block executable -> flops + bytes accessed, so the block
    # time carries machine-generated utilization numbers instead of a bare
    # wall-clock.  (Marginal-cost caveat: the 1-block program includes the
    # fixed problem setup, so per-block utilization is a lower bound.)
    flops = bytes_acc = None
    try:
        ca = jax.jit(make(1)).lower(
            prob.dist, prob.grad_stored).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        if ca:
            flops = float(ca.get("flops", 0.0)) or None
            bytes_acc = float(ca.get("bytes accessed", 0.0)) or None
    except Exception as e:  # a backend may not expose cost analysis
        log(f"[refine-bench] cost_analysis unavailable: {type(e).__name__}: {e}")
    return dict(surface_voxels=n_surf, frames=FRAMES,
                dist_block_s=per_block, t1=t1, t5=t5,
                flops=flops, bytes_accessed=bytes_acc,
                backend=jax.default_backend())


def run(log=print) -> dict:
    cpp = _cpp(log)
    log(f"[refine-bench] C++: {cpp}")
    dev = _device(log)
    log(f"[refine-bench] device: {dev}")
    return {
        "refine_dist_block_s_device": round(dev["dist_block_s"], 6),
        "refine_dist_block_s_cpp": cpp["dist_block_s"],
        "refine_dist_block_s_cpp_faithful_find": cpp["find_variant_dist_block_s"],
        "refine_dist_block_speedup": round(
            cpp["dist_block_s"] / dev["dist_block_s"], 2),
        "refine_dist_block_speedup_vs_faithful": round(
            cpp["find_variant_dist_block_s"] / dev["dist_block_s"], 2),
        "refine_surface_voxels_cpp": cpp["surface_voxels"],
        "refine_surface_voxels_device": dev["surface_voxels"],
        "refine_frames": FRAMES,
        # The block is gather/scatter-bound (sparse stencils), so the
        # meaningful floor is the bytes side; no peak share is reported
        # until the GPU's peaks arrive with the benchmark rework.
        "refine_dist_block_flops": dev.get("flops"),
        "refine_dist_block_bytes": dev.get("bytes_accessed"),
        "refine_dist_block_gbps": (
            round(dev["bytes_accessed"] / dev["dist_block_s"] / 1e9, 2)
            if dev.get("bytes_accessed") else None),
        "refine_dist_block_tflops": (
            round(dev["flops"] / dev["dist_block_s"] / 1e12, 3)
            if dev.get("flops") else None),
        # cost_analysis bytes are LOGICAL operand bytes of every HLO op —
        # they count fusion-internal reuse served from caches/registers, so
        # the derived GB/s can exceed the physical memory bandwidth.  Treat
        # them as an upper bound on traffic; the comparable
        # wall-clock numbers above are the benchmark.
        "refine_dist_block_bytes_note": "logical (cost-analysis) bytes, "
                                        "not physical memory traffic",
        "refine_scenario": (
            f"{DIM}^3 grid, SH1, cauchy, {FRAMES} keyframes all-visible, "
            "one distance block = residual + 4-voxel-stencil Jacobian + "
            "100-iter CG on J^T W J"),
    }


if __name__ == "__main__":
    print(json.dumps(run()))
