#!/usr/bin/env python3
"""GPU smoke test: the scan -> refine -> export path, run on the card.

    python chip_smoke.py                 # phases device, pipeline, parity
    python chip_smoke.py --four-cards    # only the four-GPU --mesh 4 phase

Run it from the root of a checkout on a machine with an NVIDIA GPU.  All
GPU work runs in this one process (a JAX process reserves most of the
card's memory when it starts, so a second one would fail); the C++
oracles under bench/ run as CPU subprocesses.

Phases, in order:
  device    jax.devices() is a CUDA device and a tiny jitted op runs on it.
  pipeline  writes a seeded TUM-layout dataset (640x480, depth unit 1/5000,
            handheld trajectory) and runs `psgradientsdf.cli.main` on it
            with the reference's TUM recipe (configs/tumrgbd.json: voxel
            0.02 m, 128^3, SH1, Cauchy, 30 iterations), cut to fewer
            frames; checks the refinement energy falls, the ATE is below
            half a voxel, and every artifact parses.
  parity    the GPU path against the plain references at real widths:
            tracking ATE against bench/cpp_track_ate.cpp on the production
            anchor scene, fusion against bench/cpp_baseline.cpp at
            identical poses, refinement residuals and block steps against
            bench/cpp_refine_oracle.cpp — each with the tolerance of its
            CPU test.
  four-cards (only with --four-cards) the pipeline dataset with --mesh 4
            and on one device, compared; checks that the Z-slabs land on
            four distinct cards.

Every phase prints its result and wall time.  The last line of standard
output is one JSON object {"ok": true, "device": {...}}; it is printed only
when every phase passed.  Without a GPU, or when a phase fails, the script
exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(REPO, "tests")

# the TUM RGB-D sensor shape (Sturm et al. 2012) and the reference recipe
W, H = 640, 480
DEPTH_SCALE = 5000.0          # TUM depth PNG unit: 1/5000 m
RECIPE_FRAMES = 201           # configs/tumrgbd.json: first 50 .. last 250
SMOKE_FRAMES = 48
SEED = 0                      # the pipeline dataset's noise
ANCHOR_FRAMES = 120           # tests/test_ate_parity.py production anchor


# --------------------------------------------------------------------------
# seeded TUM-layout dataset
# --------------------------------------------------------------------------

def _albedo(px, py):
    """Smooth RGB texture on the heightfield, in [0.25, 0.85]."""
    return np.stack([
        0.55 + 0.30 * np.sin(9.0 * px) * np.cos(7.0 * py),
        0.55 + 0.30 * np.cos(6.0 * px + 2.0 * py),
        0.55 + 0.30 * np.sin(5.0 * (px - py)),
    ], axis=-1)


def write_tum_dataset(root, n_frames=SMOKE_FRAMES, seed=0, width=None,
                      height=None):
    """Write a seeded RGB-D sequence in the TUM layout under `root`:
    rgb/ and depth/ PNGs (depth in 1/5000 m), associated.txt,
    groundtruth.txt and intrinsics.txt.  The camera follows the handheld
    trajectory of the ATE anchor (tests/test_ate_parity.py: an orbit with
    rotation-dominant bursts and hand tremor) over its wavy heightfield;
    color is a texture under first-order spherical-harmonic shading.
    Depth gets 1.5 mm Gaussian noise and 2% blob dropout.  Returns the
    ground-truth camera-to-world poses."""
    sys.path.insert(0, TESTS)
    from test_ate_parity import _gt_trajectory, _raymarch

    from psgradientsdf.io import png, trajectory

    width, height = width or W, height or H
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]])
    with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
        for row in K:
            fh.write(" ".join(f"{v:.6f}" for v in row) + "\n")

    light = np.array([0.25, -0.35, -0.90])
    light /= np.linalg.norm(light)
    gt = _gt_trajectory(n_frames, handheld=True)
    # ray-march in threads (numpy releases the interpreter lock); the noise
    # is drawn in frame order below, so the output does not depend on it
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        marched = list(ex.map(lambda T: _raymarch(T, width, height), gt))
    assoc, gt_lines = [], []
    for i, (pose, (s, p, n_w, _, _)) in enumerate(zip(gt, marched)):
        depth = s + rng.normal(0.0, 0.0015, s.shape)
        coarse = rng.random((height // 8 + 1, width // 8 + 1))
        holes = np.kron(coarse, np.ones((8, 8)))[:height, :width] < 0.02
        depth = np.where(holes, 0.0, depth)
        depth_u16 = np.clip(np.round(depth * DEPTH_SCALE), 0,
                            65535).astype(np.uint16)
        # the surface faces the camera (-z); SH1 shading l0 + l1 . n
        shade = 0.55 + 0.45 * np.clip((-n_w) @ light, 0.0, None)
        rgb = _albedo(p[..., 0], p[..., 1]) * shade[..., None]
        rgb8 = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)

        ts = f"{1305031100.0 + i / 30.0:.6f}"
        png.write(os.path.join(root, "depth", ts + ".png"), depth_u16)
        png.write(os.path.join(root, "rgb", ts + ".png"), rgb8)
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
        gt_lines.append(trajectory.pose_line(ts, pose))
    with open(os.path.join(root, "associated.txt"), "w") as fh:
        fh.write("\n".join(assoc) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as fh:
        fh.write("# timestamp tx ty tz qx qy qz qw\n")
        fh.write("\n".join(gt_lines) + "\n")
    return gt


def tum_recipe(data, out, n_frames):
    """configs/tumrgbd.json with the dataset paths and the frame range cut
    to `n_frames` (the recipe runs frames 50..250)."""
    with open(os.path.join(REPO, "configs", "tumrgbd.json")) as fh:
        cfg = json.load(fh)
    cfg.update({"input": data, "output": out, "first": 0,
                "last": n_frames - 1})
    return cfg


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(jax):
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"not a CUDA device: {devs}")
    x = jnp.arange(4096, dtype=jnp.float32)
    y = jax.jit(lambda a: jnp.sum(a * a))(x)
    want = float(np.sum(np.arange(4096, dtype=np.float64) ** 2))
    got = float(y)
    assert abs(got - want) <= 1e-6 * want, (got, want)
    assert next(iter(y.devices())).platform == "gpu"
    print(f"  {len(devs)} device(s): {devs}; jit sum ok ({got:.6e})")


def _energy_trace(metrics_path):
    """(initial total energy, [total after each iteration])."""
    first, totals = None, []
    with open(metrics_path) as fh:
        for line in fh:
            d = json.loads(line)
            if d.get("event") == "energy" and first is None:
                first = float(d["total"])
            elif d.get("event") == "iteration":
                totals.append(float(d["total"]))
    return first, totals


def run_cli(data, out, n_frames, gt_file, extra=()):
    """One CLI run of the TUM recipe; returns the parsed summary."""
    from psgradientsdf import cli

    cfg_path = os.path.join(os.path.dirname(out.rstrip("/")),
                            os.path.basename(out.rstrip("/")) + ".json")
    with open(cfg_path, "w") as fh:
        json.dump(tum_recipe(data, out, n_frames), fh, indent=1)
    summary_path = cfg_path[:-5] + "_summary.json"
    rc = cli.main(["--config_file", cfg_path, "--eval-ate", gt_file,
                   "--summary-json", summary_path, *extra])
    assert rc == 0, f"cli.main returned {rc}"
    with open(summary_path) as fh:
        return json.load(fh)


def phase_pipeline(tmp, n_frames, seed):
    from psgradientsdf.io import ply, sdf_io, trajectory

    data = os.path.join(tmp, "tum") + "/"
    out = os.path.join(tmp, "out") + "/"
    t0 = time.perf_counter()
    write_tum_dataset(data, n_frames, seed)
    print(f"  dataset: {n_frames} frames {W}x{H} written in "
          f"{time.perf_counter() - t0:.1f} s (seed {seed})")
    summary = run_cli(data, out, n_frames, os.path.join(data,
                                                        "groundtruth.txt"))
    voxel = tum_recipe(data, out, n_frames)["voxel size"]
    ate = summary["ate"]["ate_rmse"]
    print(f"  scan: {summary['frames']} frames in {summary['seconds']:.2f} s "
          f"({summary['fps']:.2f} fps incl. compile), "
          f"{summary['keyframes']} keyframes")
    print(f"  ATE-RMSE {ate * 1e3:.3f} mm over {summary['ate']['pairs']} "
          f"pairs (limit {voxel / 2 * 1e3:.1f} mm = half a voxel)")
    assert summary["frames"] == n_frames, summary["frames"]
    assert ate is not None and ate < voxel / 2, ate

    e0, totals = _energy_trace(os.path.join(out, "metrics.jsonl"))
    print(f"  refinement: {len(totals)} iterations in "
          f"{summary['refine_seconds']:.2f} s, energy {e0:.6g} -> "
          f"{totals[-1]:.6g}, converged={summary['refine_converged']}")
    assert totals and np.all(np.isfinite(totals)), totals
    assert totals[-1] < e0, (e0, totals)

    _, poses = trajectory.read_trajectory(os.path.join(out,
                                                       "tracking_poses.txt"))
    assert len(poses) == n_frames and np.all(np.isfinite(poses))
    for name in ("init_mesh.ply", "final_refined_mesh.ply"):
        nv, nf = ply.read_ply_header(os.path.join(out, name))
        assert nv > 1000 and nf > 1000, (name, nv, nf)
        print(f"  {name}: {nv} vertices, {nf} faces")
    for name in ("init_pointcloud.ply", "final_refined_pointcloud.ply"):
        nv, _ = ply.read_ply_header(os.path.join(out, name))
        assert nv > 1000, (name, nv)
        print(f"  {name}: {nv} points")
    dist, bottom, vs = sdf_io.read_sdf(os.path.join(out, "init_sdf.sdf"))
    assert dist.size > 0 and np.all(np.isfinite(dist)) and vs == voxel, (
        dist.shape, vs)
    print(f"  init_sdf.sdf: {dist.shape} voxels of {vs} m")


def _parity_tracking(tmp, precision):
    import test_ate_parity as tap

    from psgradientsdf.tracking import configs

    t0 = time.perf_counter()
    os.makedirs(os.path.join(tmp, "anchor"))
    sc = tap.build_scene(os.path.join(tmp, "anchor"), W=W, H=H, DIM=128,
                         F=ANCHOR_FRAMES, handheld=True, dropout=0.06,
                         speckle=0.003, workers=os.cpu_count() or 1)
    cpp = tap.run_cpp(sc)
    print(f"  anchor: {W}x{H}, 128^3, F={ANCHOR_FRAMES} handheld, 6% "
          f"dropout, 0.3% speckle; scene + C++ in "
          f"{time.perf_counter() - t0:.1f} s")
    got = {"cpp": cpp}
    for key, tkw in (("reference", configs.REFERENCE),
                     ("streaming", configs.STREAMING),
                     ("parity", configs.PARITY)):
        t1 = time.perf_counter()
        got[key] = tap.jax_track_ate(sc, **tkw)
        print(f"  tracking {key:9s}: ATE {got[key] * 1e3:.4f} mm "
              f"(pinned {configs.PRODUCTION_ATE_M[key] * 1e3:.4f} mm) "
              f"{time.perf_counter() - t1:.1f} s")
    print(f"  tracking C++      : ATE {cpp * 1e3:.4f} mm "
          f"(pinned {configs.PRODUCTION_ATE_M['cpp'] * 1e3:.4f} mm)")
    lim_ref = cpp * 1.15 + 2e-4
    lim_par = cpp * 1.2 + 2e-5
    print(f"  bounds [{precision}]: reference <= 1.15*C++ + 2e-4 = "
          f"{lim_ref * 1e3:.4f} mm; parity <= 1.2*C++ + 2e-5 = "
          f"{lim_par * 1e3:.4f} mm")
    assert cpp < 0.05, f"C++ tracker diverged: {cpp}"
    assert got["reference"] <= lim_ref, got
    assert got["parity"] <= lim_par, got


def _parity_fusion(tmp, precision):
    import jax.numpy as jnp
    import test_cpp_parity as tcp

    from psgradientsdf.core.grid import GridGeometry
    from psgradientsdf.core.volume import fuse_frame, make_volume

    DIM, FRAMES = 128, 3
    d = pathlib.Path(tmp) / "fusion"
    d.mkdir()
    cpp_poses, _, cpp_dist, cpp_weight, cpp_grad, cpp_r = tcp._run_cpp(
        d, W=W, H=H, DIM=DIM, FRAMES=FRAMES)
    h = 1.8 / DIM
    T = 5.0 * h
    geom = GridGeometry(dims=(DIM,) * 3, voxel_size=h, shift=(0.0, 0.0, 1.2))
    K, depth, normals, nsq, color = tcp._scene(W=W, H=H)
    args = tuple(jnp.asarray(a) for a in (color, depth, normals, nsq, K))
    kw = dict(truncation=T, zmin=0.5, zmax=3.5)
    vol = fuse_frame(make_volume(geom, T, frame_cap=32), geom, *args,
                     jnp.eye(4, dtype=jnp.float32), jnp.int32(0), **kw)
    for f in range(FRAMES):
        vol = fuse_frame(vol, geom, *args, jnp.asarray(cpp_poses[f]),
                         jnp.int32(f + 1), **kw)
    dist = np.asarray(vol.dist).reshape(-1)
    weight = np.asarray(vol.weight).reshape(-1)
    grad = np.asarray(vol.grad).reshape(-1)
    red = np.asarray(vol.color[..., 0]).reshape(-1)

    def frac(a, b, atol):
        return float(np.mean(~np.isclose(a, b, atol=atol, rtol=0)))

    fr = {"weight": frac(weight, cpp_weight, 1e-4),
          "dist": frac(dist, cpp_dist, 1e-5),
          "grad": frac(grad, cpp_grad.reshape(-1), 1e-4),
          "red": frac(red, cpp_r, 1e-5)}
    # the tolerances of tests/test_cpp_parity.py: each mismatch share below
    # 1e-4, and the agreeing-weight bulk within 1e-4 (dist) / 1e-5 (red)
    m = np.isclose(weight, cpp_weight, atol=1e-4, rtol=0) & (cpp_weight > 1e-3)
    dmax = float(np.abs(dist[m] - cpp_dist[m]).max())
    rmax = float(np.abs(red[m] - cpp_r[m]).max())
    print(f"  fusion {W}x{H} 128^3, {FRAMES + 1} frames at the C++ poses "
          f"[{precision}]: mismatch fractions "
          + ", ".join(f"{k} {v:.2e}" for k, v in fr.items())
          + " (limit 1e-4; atol weight/grad 1e-4, dist/red 1e-5)")
    print(f"  fusion agreeing-weight bulk ({int(m.sum())} voxels): "
          f"max |d dist| {dmax:.2e} (limit 1e-4), max |d red| {rmax:.2e} "
          f"(limit 1e-5)")
    assert all(v < 1e-4 for v in fr.values()), fr
    assert dmax < 1e-4 and rmax < 1e-5, (dmax, rmax)


def _parity_refine(tmp, precision):
    import jax.numpy as jnp
    import test_refine_oracle as tro

    from psgradientsdf.refine import jacobians, solvers

    out = os.path.join(tmp, "oracle")
    os.makedirs(out)
    oracle = tro.run_oracle(out, W=W, H=H, DIM=128, F=4)
    p = tro.build_jax_problem(oracle)
    n, rd, prob = p["n"], p["rd"], p["prob"]
    mask_ok = bool(np.array_equal(np.asarray(rd.mask)[:n], oracle["mask"]))
    r_err = float(np.abs(np.asarray(rd.r)[:n] - oracle["r"]).max())
    w_err = float(np.abs(np.asarray(rd.w)[:n] - oracle["w"]).max())
    print(f"  refinement residuals {W}x{H} 128^3, N={n} surface voxels x "
          f"F=4 [{precision}]: mask equal={mask_ok}, max |d r| {r_err:.2e}, "
          f"max |d w| {w_err:.2e} (limit 2e-5)")
    assert mask_ok and r_err <= 2e-5 and w_err <= 2e-5

    J = jacobians.albedo_jacobian_sh(prob, prob.grad_stored, p["lights"], 1)
    delta = solvers.solve_albedo(prob, rd, J, prob.albedo,
                                 p["kw"]["voxel_size"], reg_weight_rho=0.0,
                                 damping=oracle["meta"]["damping"])
    alb = np.asarray(solvers.update_albedo(prob, prob.albedo, delta))[:n]
    a_err = float(np.abs(alb - oracle["alb_new"]).max())
    JL = jacobians.light_jacobian_sh(prob, prob.albedo, prob.grad_stored, 1)
    dl = np.asarray(solvers.solve_light_sh(rd, JL))
    G = jacobians.image_pi_grad(p["images"], rd, p["K"])
    J_c = jacobians.pose_jacobian_sh(G, rd, p["poses"])
    Hp = jnp.einsum("nfc,nfcb,nfcd->fbd", rd.w, J_c, J_c)
    gp = jnp.einsum("nfc,nfcb,nfc->fb", rd.w, J_c, rd.r)
    dp = np.asarray(solvers.solve_pose_from_normal_eqs(
        Hp, gp, oracle["meta"]["damping"]))
    print(f"  refinement blocks: albedo max |d| {a_err:.2e} (limit 5e-5); "
          f"light max |d| {float(np.abs(dl - oracle['light_delta']).max()):.2e}"
          f" (rtol 2e-3, atol 2e-5); pose max |d| "
          f"{float(np.abs(dp - oracle['pose_delta']).max()):.2e} "
          f"(rtol 2e-3, atol 2e-6)")
    assert a_err <= 5e-5, a_err
    np.testing.assert_allclose(dl, oracle["light_delta"], rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(dp, oracle["pose_delta"], rtol=2e-3,
                               atol=2e-6)


def phase_parity(jax, tmp):
    import psgradientsdf  # noqa: F401  (pins the matmul precision)

    sys.path.insert(0, TESTS)
    precision = f"matmul precision {jax.config.jax_default_matmul_precision}"
    for fn in (_parity_tracking, _parity_fusion, _parity_refine):
        t0 = time.perf_counter()
        fn(tmp, precision)
        print(f"  ({fn.__name__[8:]} {time.perf_counter() - t0:.1f} s)")


def phase_four_cards(jax, tmp, n_frames, seed):
    from psgradientsdf.core.grid import GridGeometry
    from psgradientsdf.core.volume import make_volume
    from psgradientsdf.io import sdf_io, trajectory
    from psgradientsdf.parallel.mesh import make_mesh, shard_volume

    devs = jax.devices()
    assert len(devs) >= 4, f"need four GPUs, found {devs}"
    # placement: a Z-slab-sharded volume puts one slab on each card
    geom = GridGeometry(dims=(128,) * 3, voxel_size=0.02, shift=(0, 0, 1.2))
    vol = shard_volume(make_volume(geom, 0.1, 32), make_mesh(4, 1))
    shards = vol.dist.addressable_shards
    placed = sorted(s.device.id for s in shards)
    print(f"  Z-slab placement: {[(s.device.id, s.data.shape) for s in shards]}")
    assert len(set(placed)) == 4 and all(
        s.data.shape == (32, 128, 128) for s in shards), placed

    data = os.path.join(tmp, "tum") + "/"
    write_tum_dataset(data, n_frames, seed)
    gt_file = os.path.join(data, "groundtruth.txt")
    runs = {}
    for tag, extra in (("one", ()), ("mesh4", ("--mesh", "4"))):
        out = os.path.join(tmp, tag) + "/"
        t0 = time.perf_counter()
        summary = run_cli(data, out, n_frames, gt_file, extra)
        _, poses = trajectory.read_trajectory(out + "tracking_poses.txt")
        dist, bottom, _ = sdf_io.read_sdf(out + "init_sdf.sdf")
        e0, totals = _energy_trace(out + "metrics.jsonl")
        runs[tag] = dict(poses=np.stack(poses), dist=dist, bottom=bottom,
                         ate=summary["ate"]["ate_rmse"], energy=totals[-1])
        print(f"  {tag}: ATE {runs[tag]['ate'] * 1e3:.3f} mm, refined energy "
              f"{e0:.6g} -> {totals[-1]:.6g}, {time.perf_counter() - t0:.1f} s")
    a, b = runs["one"], runs["mesh4"]
    vs = tum_recipe(data, "", n_frames)["voxel size"]
    dpose = float(np.abs(a["poses"] - b["poses"]).max())
    # psum order differs, so each GN solve stops at a slightly different
    # iterate inside its ||xi|| < 1e-3 radius, and the difference carries
    # into the next frame's seed: limit twice the radius (10% of a voxel)
    print(f"  max |pose difference| {dpose:.2e} (limit 2e-3)")
    assert dpose < 2e-3, dpose
    assert max(a["ate"], b["ate"]) < vs / 2, (a["ate"], b["ate"])
    # the .sdf crops to the surface band, whose extent may differ by a
    # voxel between the runs: compare on the overlap of the two crops
    lo_a = np.rint(np.asarray(a["bottom"]) / vs).astype(int)[::-1]   # z,y,x
    lo_b = np.rint(np.asarray(b["bottom"]) / vs).astype(int)[::-1]
    lo = np.maximum(lo_a, lo_b)
    hi = np.minimum(lo_a + a["dist"].shape, lo_b + b["dist"].shape)
    assert np.all(hi - lo > 0.9 * np.asarray(a["dist"].shape)), (lo, hi)
    crop = lambda r, o: r["dist"][tuple(slice(l - q, h - q) for l, h, q
                                        in zip(lo, hi, o))]
    dd = np.abs(crop(a, lo_a) - crop(b, lo_b))
    frac = float(np.mean(dd > 1e-3))
    print(f"  scan SDF on the {dd.shape} overlap: {frac:.2e} of voxels differ "
          f"by > 1 mm (limit 2e-2), median |d| {float(np.median(dd)):.2e}")
    assert frac < 2e-2, frac
    rel = abs(a["energy"] - b["energy"]) / abs(a["energy"])
    print(f"  refined energy relative difference {rel:.2e} (limit 2e-2)")
    assert rel < 2e-2, rel


# --------------------------------------------------------------------------

def _card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU --mesh 4 phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cuda")
    try:
        devs = jax.devices()
    except (RuntimeError, AssertionError) as e:   # no CUDA backend at all
        print(f"chip_smoke: no CUDA device: {e}", file=sys.stderr)
        return 2
    if devs[0].platform != "gpu":
        print(f"chip_smoke: not a GPU: {devs}", file=sys.stderr)
        return 2

    import jaxlib

    import psgradientsdf  # noqa: F401  (pins the matmul precision)
    from psgradientsdf.utils import compile_cache

    print(f"card: {_card_line()}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"{len(devs)} x {devs[0].device_kind}")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}")
    print(f"compile cache: {compile_cache.cache_dir()}")
    print(f"cuts: pipeline frames {SMOKE_FRAMES} of the recipe's "
          f"{RECIPE_FRAMES} (frames 0..{SMOKE_FRAMES - 1} instead of "
          f"50..250); parity anchor F={ANCHOR_FRAMES} (the test's own)")

    if args.four_cards:
        phases = [("four-cards", lambda t: phase_four_cards(
            jax, t, SMOKE_FRAMES, SEED))]
    else:
        phases = [("device", lambda t: phase_device(jax)),
                  ("pipeline", lambda t: phase_pipeline(
                      t, SMOKE_FRAMES, SEED)),
                  ("parity", lambda t: phase_parity(jax, t))]
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, fn in phases:
            print(f"[{name}]", flush=True)
            t0 = time.perf_counter()
            sub = os.path.join(tmp, name)
            os.makedirs(sub)
            try:
                fn(sub)
            except Exception:
                traceback.print_exc()
                print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                      flush=True)
                return 1
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(f"all phases ok in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
