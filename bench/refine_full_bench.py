"""FULL refinement alternation benchmark: wall-clock to convergence,
device PhotometricRefiner vs the C++ CPU baseline (round-4 VERDICT #1).

bench/cpp_refine_full.cpp runs the reference's complete alternating loop
(PsOptimizer.cpp:239-428: initAlbedo, energy-ratio reg-weight
normalization, per-iteration {albedo, light, distance, pose} blocks with
per-block residual refresh, rel-dE < 5e-3 convergence) on the bench scene
(640x480, 128^3, F=20, SH1, cauchy, reg_n=10) and DUMPS the initial
problem state; this driver loads that dump into the LITERALLY IDENTICAL
JAX problem (same volume bits, same image, same poses/lights/budgets) and
times PhotometricRefiner.alternating_optimize end-to-end on the device —
cold pass first (compiles), then a timed warm pass from a fresh copy of
the same initial state.

Both sides use one residual pass per block (energy input = next block's
linearization), so the C++ baseline is strictly STRONGER than the literal
reference loop (which re-runs computeResidual in every getPSEnergy).

Import and call run(log) -> dict.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, MAX_IT = 640, 480, 100
DIM, F = 128, 20                 # the bench scene (refine_bench scale)
DIM_L, F_L = 192, 40             # production-trend leg: ~4.5x the pairs


def _cpp(log, outdir, dim, f, reps=3) -> dict:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cpp_refine_full.cpp")
    binp = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "native", "build", "cpp_refine_full")
    os.makedirs(os.path.dirname(binp), exist_ok=True)
    if (not os.path.exists(binp)
            or os.path.getmtime(binp) < os.path.getmtime(src)):
        log("[refine-full] compiling C++ full-alternation baseline ...")
        subprocess.run(["g++", "-O3", "-std=c++17", "-o", binp, src],
                       check=True)
    log(f"[refine-full] running C++ full alternation "
        f"({dim}^3, F={f}; best of {reps}) ...")
    runs = []
    for _ in range(reps):
        out = subprocess.run(
            [binp, str(W), str(H), str(dim), str(f), str(MAX_IT), outdir],
            check=True, capture_output=True, text=True, timeout=1800,
        ).stdout
        runs.append(json.loads(out))
    best = dict(min(runs, key=lambda r: r["total_s"]))
    return best


def _load_problem(outdir):
    meta = json.load(open(os.path.join(outdir, "meta.json")))
    dim, f = meta["DIM"], meta["F"]

    def f32(name, shape):
        return np.fromfile(os.path.join(outdir, name),
                           dtype=np.float32).reshape(shape)

    d = dict(meta=meta)
    d["image"] = f32("image.f32", (H, W, 3))
    d["dist"] = f32("dist.f32", (dim, dim, dim))
    d["grad"] = f32("grad.f32", (dim, dim, dim, 3))
    d["weight"] = f32("weight.f32", (dim, dim, dim))
    d["poses"] = f32("poses.f32", (f, 4, 4))
    d["lights"] = f32("lights.f32", (f, 4))
    return d


def _make_refiner(dump, metrics):
    import jax.numpy as jnp

    from psgradientsdf.config import OptimizerConfig
    from psgradientsdf.core.grid import GridGeometry
    from psgradientsdf.core.volume import GradSdfVolume
    from psgradientsdf.refine.optimizer import PhotometricRefiner
    from psgradientsdf.utils import robust

    m = dump["meta"]
    dim = m["DIM"]
    geom = GridGeometry(dims=(dim, dim, dim), voxel_size=m["h"],
                        shift=tuple(m["shift"]))
    vis = np.where(dump["weight"] > 0, np.uint32(1), np.uint32(0))[None]
    vol = GradSdfVolume(
        dist=jnp.asarray(dump["dist"]),
        grad=jnp.asarray(dump["grad"]),
        weight=jnp.asarray(dump["weight"]),
        color=jnp.full((dim, dim, dim, 3), 0.5, dtype=jnp.float32),
        vis=jnp.asarray(vis),
    )
    cfg = OptimizerConfig(
        max_it=m["max_it"], conv_threshold=m["conv_threshold"],
        damping=m["damping"], lam=m["lambda"],
        reg_weight_n=m["reg_n"], model="SH1", loss=robust.CAUCHY,
    )
    K = np.array([[m["fx"], 0, m["cx"]], [0, m["fy"], m["cy"]], [0, 0, 1]],
                 dtype=np.float32)
    ref = PhotometricRefiner(vol, geom, cfg, K, save_path="",
                             truncation=m["T"], metrics=metrics)
    nf = m["F"]
    images = np.broadcast_to(dump["image"], (nf,) + dump["image"].shape).copy()
    ref.set_keyframes(images, dump["poses"], [0] * nf,
                      [str(i) for i in range(nf)])
    ref.init()
    # the light init (rotated -z + 0.02 ambient) must reproduce the dump's
    np.testing.assert_allclose(np.asarray(ref.lights), dump["lights"],
                               atol=1e-6)
    assert int(ref.prob.n_surface) == m["N"], (int(ref.prob.n_surface), m["N"])
    return ref


def _device(log, outdir) -> dict:
    import jax

    log(f"[refine-full] devices: {jax.devices()}")

    from psgradientsdf.utils.metrics import MetricsLogger

    dump = _load_problem(outdir)
    silent = MetricsLogger(None, echo=False)

    # energy-trace collector: the loop's host-side convergence logic does a
    # real D2H fetch of every energy, so its wall clock is self-fencing
    class Trace(MetricsLogger):
        def __init__(self):
            super().__init__(None, echo=False)
            self.iters = []

        def log(self, event, **fields):
            if event == "iteration":
                self.iters.append(fields["total"])
            return super().log(event, **fields)

    # cold pass: compiles every block program (counted separately)
    log("[refine-full] cold pass (compiles) ...")
    t0 = time.perf_counter()
    ref = _make_refiner(dump, silent)
    ref.alternating_optimize(True, True, True, True)
    cold_s = time.perf_counter() - t0

    # timed warm passes from a FRESH copy of the identical initial state
    # (jit caches are in-process)
    best = 1e18
    iters = None
    trace = None
    for rep in range(2):
        tr = Trace()
        t0 = time.perf_counter()
        ref = _make_refiner(dump, tr)
        converged = ref.alternating_optimize(True, True, True, True)
        dt = time.perf_counter() - t0
        log(f"[refine-full] warm pass {rep}: {dt:.2f}s, "
            f"{len(tr.iters)} iters, converged={converged}, "
            f"E: {tr.iters[0]:.6g} -> {tr.iters[-1]:.6g}")
        if dt < best:
            best, iters, trace = dt, len(tr.iters), list(tr.iters)
    return dict(total_s=best, cold_s=cold_s, iters=iters,
                E_final=trace[-1], backend=jax.default_backend())


def _leg(log, dim, f, reps):
    outdir = tempfile.mkdtemp(prefix=f"refine_full_{dim}_")
    cpp = _cpp(log, outdir, dim, f, reps=reps)
    log(f"[refine-full] C++ ({dim}^3,F={f}): {cpp}")
    dev = _device(log, outdir)
    log(f"[refine-full] device ({dim}^3,F={f}): {dev}")
    return cpp, dev


def run(log=print) -> dict:
    cpp, dev = _leg(log, DIM, F, reps=3)
    # production-trend leg: ~4.5x the voxel-keyframe pairs (the sokrates /
    # basket recipes run at 1.9-2.2M pairs; the bench scene's 0.46M is
    # where single-core C++ is most competitive)
    cpp_l, dev_l = _leg(log, DIM_L, F_L, reps=2)
    return {
        # round-4 VERDICT #1: the full-alternation run of record
        "refine_total_s_cpp": round(cpp["total_s"], 4),
        "refine_total_s_device": round(dev["total_s"], 4),
        "refine_total_s_device_cold": round(dev["cold_s"], 4),
        "refine_full_speedup": round(cpp["total_s"] / dev["total_s"], 3),
        "refine_iters_cpp": cpp["iters"],
        "refine_iters_device": dev["iters"],
        "refine_E_final_cpp": cpp["E_final"],
        "refine_E_final_device": dev["E_final"],
        "refine_cpp_block_s": {
            "albedo": cpp["albedo_s"], "light": cpp["light_s"],
            "dist": cpp["dist_s"], "pose": cpp["pose_s"],
            "residual_passes": cpp["pass_s"],
        },
        "refine_full_large": {
            "scenario": f"{W}x{H}, {DIM_L}^3, F={F_L} keyframes "
                        f"(~{cpp_l['N'] * F_L / 1e6:.1f}M pairs)",
            "total_s_cpp": round(cpp_l["total_s"], 4),
            "total_s_device": round(dev_l["total_s"], 4),
            "speedup": round(cpp_l["total_s"] / dev_l["total_s"], 3),
            "iters_cpp": cpp_l["iters"],
            "iters_device": dev_l["iters"],
            "E_final_cpp": cpp_l["E_final"],
            "E_final_device": dev_l["E_final"],
        },
        "refine_full_scenario": (
            f"{W}x{H}, {DIM}^3, F={F} keyframes, SH1, cauchy lam=0.2, "
            "reg_n=10 (energy-normalized), damping=1, conv rel-dE<5e-3 — "
            "the reference's full alternating loop (PsOptimizer.cpp:239-428) "
            "from the identical dumped initial state on both sides; "
            "C++ baseline uses ONE residual pass per block (stronger than "
            "the literal reference's two)"),
    }


if __name__ == "__main__":
    print(json.dumps(run(lambda *a: print(*a, file=sys.stderr))))
