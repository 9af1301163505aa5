"""Benchmark: tracking+fusion frames/s at a 128^3 grid, device vs C++ CPU baseline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The scenario is the reference's per-frame hot path: rigid GN
tracking (<=50 iterations, early exit ||xi||^2 < 1e-6, full-resolution
640x480 pixels) followed by volumetric fusion into a 128^3 Gradient-SDF
grid.  Scene, pose offsets, and convergence settings are identical on both
sides.

Baseline: the C++ reference repo cannot be built in this image (its vendored
Eigen/Sophus submodules are empty checkouts and there is no network), so the
baseline is bench/cpp_baseline.cpp — a faithful single-threaded plain-C++
reimplementation of the reference's two hot loops with the same algorithm,
AoS data layout, and budgets (see its header).  It is compiled -O3 at bench
time and measured on this host.

All diagnostics go to stderr; stdout carries exactly the one JSON line.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

W, H = 640, 480
# PSGSDF_BENCH_DIM overrides the grid for scaling studies (e.g. 256); the
# headline metric/BENCH_details stay keyed to the default 128
DIM = int(os.environ.get("PSGSDF_BENCH_DIM", "128"))
FRAMES_DEV = int(os.environ.get("PSGSDF_BENCH_FRAMES", "200"))
# C++ frame budget scales with the real voxel ratio (cost is ~linear in
# voxels), so off-power dims (192, 512) get a proportional budget too
FRAMES_CPP = max(2, int(12 / max(1.0, (DIM / 128) ** 3)))
OFFSET = np.array([0.004, -0.003, 0.005, 0.002, -0.002, 0.0015], dtype=np.float32)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_scene():
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "bench"))
    from bench_scene import make_scene as shared_scene
    return shared_scene(W, H)


def run_cpp_baseline() -> dict:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench", "cpp_baseline.cpp")
    binp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "native", "build", "cpp_baseline")
    os.makedirs(os.path.dirname(binp), exist_ok=True)
    if not os.path.exists(binp) or os.path.getmtime(binp) < os.path.getmtime(src):
        log("[bench] compiling C++ baseline ...")
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-o", binp, src], check=True,
        )
    log("[bench] running C++ baseline (best of 3) ...")
    runs = []
    for _ in range(3):
        out = subprocess.run(
            [binp, str(W), str(H), str(DIM), str(FRAMES_CPP)],
            check=True, capture_output=True, text=True, timeout=1200,
        ).stdout
        runs.append(json.loads(out))
    # host-load noise only ever slows the single-threaded C++ down, so the
    # fastest rep is the true baseline (and the strongest competitor);
    # single-shot numbers swung the reported speedups by ~10-20% run to run
    best = dict(min(runs, key=lambda r: r["per_frame_s"]))
    best["gn_iters_per_s"] = max(r["gn_iters_per_s"] for r in runs)
    return best


def run_device() -> dict:
    import jax
    import jax.numpy as jnp

    from psgradientsdf.core.grid import GridGeometry
    from psgradientsdf.core.volume import (
        PackedVolume, count_active_rows, fuse_frame_culled,
        fuse_frame_culled_packed, make_volume,
    )
    from psgradientsdf.tracking.tracker import track_frame

    log(f"[bench] devices: {jax.devices()}")

    K_np, depth_np, normals_np, nsq_np, color_np = make_scene()
    h = 1.8 / DIM
    T = 5 * h
    geom = GridGeometry(dims=(DIM, DIM, DIM), voxel_size=h, shift=(0.0, 0.0, 1.2))

    K = jnp.asarray(K_np)
    depth = jnp.asarray(depth_np)
    normals = jnp.asarray(normals_np)
    nsq = jnp.asarray(nsq_np)
    color = jnp.asarray(color_np)
    eye = jnp.asarray(np.eye(4, dtype=np.float32))
    # offset pose computed host-side (numpy)
    from scipy.spatial.transform import Rotation

    off_np = np.eye(4, dtype=np.float32)
    Rm = Rotation.from_rotvec(OFFSET[3:]).as_matrix().astype(np.float32)
    Kh = np.array([[0, -OFFSET[5], OFFSET[4]], [OFFSET[5], 0, -OFFSET[3]],
                   [-OFFSET[4], OFFSET[3], 0]], dtype=np.float32)
    Vm = np.eye(3, dtype=np.float32) + 0.5 * Kh + (Kh @ Kh) / 6.0
    off_np[:3, :3] = Rm
    off_np[:3, 3] = Vm @ OFFSET[:3]
    off = jnp.asarray(off_np)

    vol = make_volume(geom, T, frame_cap=64)
    fuse_kw = dict(truncation=T, zmin=0.5, zmax=3.5)
    # steady-state tracking configs come from tracking/configs.py — the
    # SAME dicts whose production-anchor ATE test_ate_parity pins
    # (round-4 VERDICT #2: every fps is recorded next to its config and
    # that config's ATE).  STREAMING = 2 gathers + 8 fixed-trip steps,
    # ATE 0.695 mm (1.85x C++, sub-voxel); PARITY = 3 gathers + 12 steps,
    # ATE 0.371 mm (BEATS the C++ reference's 0.375).  Round 4's timed
    # chain used 1 gather + 4 steps — measured at 4.08 mm on the anchor
    # in round 5 and therefore RETIRED from the headline
    # (configs.STREAMING_FAST keeps the record).
    from psgradientsdf.tracking import configs as track_configs

    zrange = dict(truncation=T, zmin=0.5, zmax=3.5)
    track_kw = dict(zrange, **track_configs.STREAMING)
    track_kw_parity = dict(zrange, **track_configs.PARITY)

    # row-culled fusion capacity: size from the level-1 cull of this scene
    # (+5% pose-drift margin, multiple of 512 — the gather index count is
    # CAP*X whether rows are real or padding, so slack is pure cost);
    # exactness is guaranteed by the overflow flag, asserted after every
    # timed run (the scenario's pose orbit moves the active set by well
    # under this margin)
    # X-segment culling (core/volume.py seg_x) was measured and rejected
    # on the accelerator the system was first built for (whole rows won at
    # every dim); not yet measured on the GPU.  The capability stays in
    # the library (tested).
    SEG = None
    S = SEG or DIM
    NSEG_TOTAL = DIM * DIM * (DIM // S)
    n_act = int(count_active_rows(geom, depth, K, eye, **fuse_kw, seg_x=SEG))
    CAP = min(NSEG_TOTAL, -(-int(n_act * 21 // 20) // 512) * 512)
    fuse_kw = dict(fuse_kw, seg_x=SEG)   # all culled fusion below uses it
    log(f"[bench] fusion cull: {n_act}/{NSEG_TOTAL} active {S}-voxel "
        f"segments -> capacity {CAP} ({CAP*S/1e6:.2f}M gather idx vs "
        f"{DIM**3/1e6:.2f}M full)")
    # build the map from frame 0 with the CULLED kernel (bit-identical to
    # full-grid fuse_frame; the un-culled kernel's all-voxel gather output
    # alone is 4.3 GB at 512^3) — also pays compile + first-D2H tax
    vol, ov0 = fuse_frame_culled(
        vol, geom, color, depth, normals, nsq, K, eye, jnp.int32(0),
        **fuse_kw, row_capacity=CAP)
    assert not bool(ov0), "map-build overflow"

    # ---- round-4 VERDICT #3: K-frame batched GT-pose fusion (one state
    # gather/scatter per K frames; exactness pinned by test_fuse_culled).
    # Runs HERE, while only the SoA volume is resident.  The speedup
    # ratio vs the sequential chain is computed later once fuse_s exists.
    gt_batched_s = None
    if True:   # all dims (round-4 VERDICT #6: no null fields in the record)
        from psgradientsdf.core.volume import fuse_frames_culled

        KB = 10
        colors_b = jnp.stack([color] * KB)
        depths_b = jnp.stack([depth] * KB)
        normals_b = jnp.stack([normals] * KB)
        nsq_b = jnp.stack([nsq] * KB)

        @functools.partial(jax.jit, static_argnames=("n",))
        def batched_chain(st, s, *, n):
            def body(k, carry):
                st, ovf = carry
                tj = (1e-7 * (k * KB + s
                              + jnp.arange(KB)).astype(jnp.float32))
                poses = (eye[None] + jnp.zeros((KB, 4, 4), jnp.float32)
                         .at[:, 0, 3].set(tj))
                # non-wrapping ascending window (fuse_frames_culled requires
                # ascending frame_ids; a mid-batch modulus wrap would break
                # that silently once ids cross a vis-word boundary)
                base = (k + s) % 20
                fids = jnp.int32(1) + base + jnp.arange(KB, dtype=jnp.int32)
                st, ov = fuse_frames_culled(
                    st, geom, colors_b, depths_b, normals_b, nsq_b, K,
                    poses, fids, **{k_: v for k_, v in fuse_kw.items()
                                    if k_ != "seg_x"},
                    row_capacity=CAP)   # SEG is None: CAP counts rows
                return st, ovf | ov
            st, ovf = jax.lax.fori_loop(0, n, body, (st, jnp.bool_(False)))
            return jnp.sum(st.dist) + jnp.float32(ovf)

        seed_b = [1000]

        def bseed():
            seed_b[0] += 1
            return jnp.int32(seed_b[0])

        try:
            b1 = functools.partial(batched_chain, n=1)
            b3 = functools.partial(batched_chain, n=3)
            _ = float(b1(vol, bseed()))
            _ = float(b3(vol, bseed()))
            bt = 1e18
            for _rep in range(2):
                t0 = time.perf_counter()
                _ = float(b1(vol, bseed()))
                t1 = time.perf_counter()
                _ = float(b3(vol, bseed()))
                t2 = time.perf_counter()
                bt = min(bt, ((t2 - t1) - (t1 - t0)) / (2 * KB))
            gt_batched_s = bt
            log(f"[bench] GT-pose batched fusion (K={KB}): "
                f"{bt*1e3:.2f} ms/frame")
        except Exception as e:
            log(f"[bench] batched fusion leg failed: {type(e).__name__}: {e}")
        del colors_b, depths_b, normals_b, nsq_b

    # state layout for the timed chain: SoA + in-program tracking repack at
    # 128^3/256^3, PackedVolume at 512^3 (no repack; chosen for a 16 GB
    # device — ROADMAP 3.6 re-decides it on the GPU)
    USE_PACKED = DIM >= 512
    if USE_PACKED:
        state0 = PackedVolume.from_volume(vol)
        del vol
        fuse_culled = fuse_frame_culled_packed
        state_sum = lambda st: jnp.sum(st.payload)
    else:
        state0 = vol
        fuse_culled = fuse_frame_culled
        state_sum = lambda st: jnp.sum(st.dist)
    res = track_frame(state0, geom, depth, K, off,
                      **{**track_kw, "early_exit": True, "num_iterations": 50,
                         "regather_every": 1})
    _ = np.asarray(res.pose)     # warm the D2H path
    _ = float(state_sum(state0))
    log(f"[bench] warmup done; tracker iters={int(res.iterations)}")

    # Every timed region below ends with a D2H fetch of a value
    # data-dependent on the full computation, which fences completion.

    # steady-state: the whole frame sequence runs INSIDE one jitted
    # program (nested fori: chunks x frames), per frame a fixed-trip
    # frozen-correspondence GN round seeded at offset @ previous pose
    # (the C++ baseline's inter-frame motion model) then ROW-CULLED fusion
    # at the tracked pose, and the program outputs
    # ONLY scalars (sums + iteration/overflow counters): when the volume
    # state is a program OUTPUT, XLA can pin the loop carry to boundary
    # layouts and copy it every frame.  The marginal between two trip
    # counts cancels the per-call dispatch and fetch overhead.
    CHUNK = 10
    N_TIMED = FRAMES_DEV // CHUNK
    N1, N2 = 2, 2 + N_TIMED


    def make_run_chunks(tkw):
        @functools.partial(jax.jit, static_argnames=("n",))
        def run_chunks(st, off_m, s, *, n):
            # SoA state carried through nested loops; the tracker's [V,8]
            # payload repack happens in-program
            def frame(gk, carry):
                st, pose, iters, ovf = carry
                seed = off_m @ pose
                res = track_frame(st, geom, depth, K, seed, **tkw)
                st, ov = fuse_culled(
                    st, geom, color, depth, normals, nsq, K, res.pose,
                    jnp.int32(1) + (gk + s) % 60, **fuse_kw,
                    row_capacity=CAP
                )
                return st, res.pose, iters + res.iterations, ovf | ov

            def chunk(c, carry):
                return jax.lax.fori_loop(
                    0, CHUNK, lambda k, cr: frame(c * CHUNK + k, cr), carry)

            st, pose, iters, ovf = jax.lax.fori_loop(
                0, n, chunk, (st, eye, jnp.int32(0), jnp.bool_(False)))
            # scalar fence, data-dependent on the full state evolution
            return (state_sum(st) + jnp.sum(pose), iters,
                    ovf.astype(jnp.int32))

        return run_chunks

    # warm/compile both trip counts (distinct seeds per call vary the
    # visibility ids, so no two timed calls repeat the same work)
    seed_i = [0]

    def seed():
        seed_i[0] += 1
        return jnp.int32(seed_i[0])

    def time_chain(run_chunks):
        f_n1 = functools.partial(run_chunks, n=N1)
        f_n2 = functools.partial(run_chunks, n=N2)
        r1 = f_n1(state0, off, seed())
        _ = float(r1[0])
        r2 = f_n2(state0, off, seed())
        _ = float(r2[0])
        assert int(r2[2]) == 0, "fusion cull capacity overflow in warmup"
        dt = 1e18
        its = None
        for _rep in range(3):
            t0 = time.perf_counter()
            ra = f_n1(state0, off, seed())
            _ = float(ra[0])
            t1 = time.perf_counter()
            rb = f_n2(state0, off, seed())
            _ = float(rb[0])
            t2 = time.perf_counter()
            dt = min(dt, (t2 - t1) - (t1 - t0))
            its = rb[1]
            assert int(rb[2]) == 0, "fusion cull overflow in timed run"
        return FRAMES_DEV / dt, int(its)

    fps, iters = time_chain(make_run_chunks(track_kw))
    log(f"[bench] streaming chain: {fps:.1f} fps")
    # second headline pair (round-4 VERDICT #2): the ATE-PARITY tracker
    # config (3 gathers + 12 steps; production ATE 0.371 mm, beats C++)
    fps_parity, iters_parity = time_chain(make_run_chunks(track_kw_parity))
    log(f"[bench] parity chain: {fps_parity:.1f} fps")

    # fusion-only chain, same marginal protocol -> ns per gather index and
    # bytes moved/s.  No roofline share yet: the GPU's peaks arrive with
    # the benchmark rework (ROADMAP 1.1).
    @functools.partial(jax.jit, static_argnames=("n",))
    def fuse_chain(st, s, *, n):
        def body(k, carry):
            st, ovf = carry
            # sub-micron per-iteration pose jitter: with a FIXED pose the
            # cull and the whole pixel gather are loop-invariant and XLA
            # hoists them out of the chain (an impossibly low ns/idx — an
            # artifact, not a gather); the jitter is far below
            # the cull's float-safety margins so the work is identical
            tj = 1e-7 * (k + s).astype(jnp.float32)
            pose_k = eye + jnp.zeros((4, 4), jnp.float32).at[0, 3].set(tj)
            st, ov = fuse_culled(
                st, geom, color, depth, normals, nsq, K, pose_k,
                jnp.int32(1) + (k + s) % 60, **fuse_kw, row_capacity=CAP)
            return st, ovf | ov
        st, ovf = jax.lax.fori_loop(0, n, body, (st, jnp.bool_(False)))
        return state_sum(st) + jnp.float32(ovf)

    g1 = functools.partial(fuse_chain, n=3)
    g2 = functools.partial(fuse_chain, n=9)
    _ = float(g1(state0, seed()))
    _ = float(g2(state0, seed()))

    def measure_floor():
        best = 1e18
        for _rep in range(3):
            t0 = time.perf_counter()
            _ = float(g1(state0, seed()))
            t1 = time.perf_counter()
            _ = float(g2(state0, seed()))
            t2 = time.perf_counter()
            best = min(best, ((t2 - t1) - (t1 - t0)) / 6)
        return best

    fuse_s = measure_floor()
    assert fuse_s > 0, "fusion floor marginal non-positive"
    n_idx = CAP * S
    fuse_ns_per_idx = fuse_s * 1e9 / n_idx
    # bytes/frame: pixel-payload rows (32 B/idx) + state rows gathered and
    # scattered (8 f32 + 1 u32 vis word per voxel, both directions)
    bytes_frame = n_idx * 32 + 2 * n_idx * 36
    log(f"[bench] fusion floor: {fuse_s*1e3:.2f} ms/frame, "
        f"{fuse_ns_per_idx:.2f} ns/idx over {n_idx/1e6:.2f}M idx, "
        f"{bytes_frame/fuse_s/1e9:.1f} GB/s")

    # fixed-budget GN iteration rate (no early exit) for iters/s; every rep
    # gets a distinct seed pose
    def track50(seed, stride=1):
        # fixed-trip (early_exit=False): the forced-50-iteration rate
        # metric wants the static program the production executor ships
        return track_frame(state0, geom, depth, K, seed,
                           truncation=T, zmin=0.5, zmax=3.5, num_iterations=50,
                           conv_threshold_sq=0.0, damping=1.0,
                           early_exit=False, regather_every=1, stride=stride)

    def time_track50(stride):
        # warm with a seed outside the timed power series
        res50 = track50(jnp.asarray(np.linalg.matrix_power(off_np, 99)),
                        stride)
        _ = float(jnp.sum(res50.pose))
        REPS = 10
        best = 1e18
        for g in range(3):                        # best of 3 intervals
            seeds = [jnp.asarray(
                np.linalg.matrix_power(off_np, g * REPS + k + 1))
                for k in range(REPS)]
            t1 = time.perf_counter()
            poses = [track50(seeds[k], stride).pose for k in range(REPS)]
            _ = float(jnp.sum(jnp.stack(poses)))  # real completion fence
            best = min(best, time.perf_counter() - t1)
        return REPS * 50 / best

    iters_per_s = time_track50(1)

    extra = {}
    # the reference's own pixel-subsampling lever (optimize_sampled,
    # RigidPointOptimizer.h:36-43) — measured at EVERY dim (round-4
    # VERDICT #6: no null fields in the record); its ATE cost is pinned
    # at the production anchor (+9% at stride 2, tracking/configs.py)
    extra["gn_iters_per_s_stride2"] = time_track50(2)
    if gt_batched_s is not None:
        # measured right after map build (SoA-only residency)
        extra["gt_fusion_batched_ms_per_frame"] = round(
            gt_batched_s * 1e3, 3)
        extra["gt_fusion_batched_speedup_vs_sequential"] = round(
            fuse_s / gt_batched_s, 3)

    # round-4 VERDICT #2: the configs behind the two fps numbers, with
    # their pinned production-anchor ATE — and an assert that what this
    # bench timed IS what the ATE test measures (same dict object).
    from psgradientsdf.tracking import configs as _tc

    assert {k: track_kw[k] for k in _tc.STREAMING} == _tc.STREAMING
    assert {k: track_kw_parity[k] for k in _tc.PARITY} == _tc.PARITY
    extra["tracker_config"] = dict(_tc.STREAMING)
    extra["tracker_config_production_ate_m"] = _tc.PRODUCTION_ATE_M["streaming"]
    extra["parity_tracker_config"] = dict(_tc.PARITY)
    extra["parity_production_ate_m"] = _tc.PRODUCTION_ATE_M["parity"]
    extra["cpp_production_ate_m"] = _tc.PRODUCTION_ATE_M["cpp"]

    return dict(fps=fps, per_frame_s=1.0 / fps, gn_iters=iters,
                fps_parity=fps_parity, gn_iters_parity=iters_parity,
                gn_iters_per_s=iters_per_s, backend=jax.default_backend(),
                fuse_ms_per_frame=round(fuse_s * 1e3, 3),
                fuse_gather_idx=n_idx,
                fuse_gather_ns_per_idx=round(fuse_ns_per_idx, 3),
                fuse_bytes_per_s=round(bytes_frame / fuse_s, 0), **extra)


def main() -> int:
    cpp = run_cpp_baseline()
    log(f"[bench] C++ baseline: {cpp}")
    dev = run_device()
    log(f"[bench] device: {dev}")

    # refinement distance-block benchmark (details only; headline stays the
    # per-frame tracking+fusion rate).  The scenario is 128^3-shaped —
    # running it inside a 256^3/512^3 scaling process just re-measures the
    # same thing with the big volume still resident (OOMed at 512^3).
    refine = {}
    if DIM == 128:
        try:
            sys.path.insert(0, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "bench"))
            import refine_bench
            refine = refine_bench.run(log)
        except Exception as e:  # keep the headline metric robust
            log(f"[bench] refine bench failed: {type(e).__name__}: {e}")
        try:
            # round-4 VERDICT #1: FULL alternation wall-clock to
            # convergence, identical problem both sides
            import refine_full_bench
            refine.update(refine_full_bench.run(log))
        except Exception as e:
            log(f"[bench] refine full bench failed: {type(e).__name__}: {e}")

    result = {
        "metric": f"track_fuse_frames_per_s_{DIM}cube",
        "value": round(dev["fps"], 3),
        "unit": "frames/s",
        "vs_baseline": round(dev["fps"] / cpp["fps"], 3),
        # round-4 VERDICT #2: the headline fps is coupled to its pinned
        # production-anchor ATE, and the second pair (ATE-parity tracker,
        # beats the C++ reference's accuracy) rides along
        "production_ate_m": dev.get("tracker_config_production_ate_m"),
        "fps_ate_parity": round(dev.get("fps_parity", 0.0), 3),
        "ate_parity_m": dev.get("parity_production_ate_m"),
    }
    if refine.get("refine_full_speedup") is not None:
        # round-4 VERDICT #1: full-alternation ratio on the headline line
        result["refine_full_speedup"] = refine["refine_full_speedup"]
    details = {
        **result,
        "fps_parity_vs_baseline": round(
            dev.get("fps_parity", 0.0) / cpp["fps"], 3),
        "tracker_config": dev.get("tracker_config"),
        "parity_tracker_config": dev.get("parity_tracker_config"),
        "cpp_production_ate_m": dev.get("cpp_production_ate_m"),
        "baseline_fps": cpp["fps"],
        "baseline_gn_iters_per_s": cpp["gn_iters_per_s"],
        "device_gn_iters_per_s": dev["gn_iters_per_s"],
        "gn_iters_speedup": dev["gn_iters_per_s"] / cpp["gn_iters_per_s"],
        "backend": dev["backend"],
        "fuse_ms_per_frame": dev.get("fuse_ms_per_frame"),
        "fuse_gather_idx": dev.get("fuse_gather_idx"),
        "fuse_gather_ns_per_idx": dev.get("fuse_gather_ns_per_idx"),
        "fuse_bytes_per_s": dev.get("fuse_bytes_per_s"),
        "gn_iters_per_s_stride2": dev.get("gn_iters_per_s_stride2"),
        "gt_fusion_batched_ms_per_frame": dev.get(
            "gt_fusion_batched_ms_per_frame"),
        "gt_fusion_batched_speedup_vs_sequential": dev.get(
            "gt_fusion_batched_speedup_vs_sequential"),
        "state_bytes_per_frame": 2 * dev["fuse_gather_idx"] * 36,
        "scenario": f"{W}x{H} frames, {DIM}^3 grid, 50-iter GN budget",
        "baseline_kind": "plain-C++ -O3 single-thread reimplementation of the "
                         "reference hot loops (reference repo unbuildable: "
                         "empty vendored submodules, no network)",
        **refine,
    }
    try:
        # BENCH_details.json is the headline (128^3) record; scaling-study
        # runs (PSGSDF_BENCH_DIM != 128) write a suffixed file instead
        name = ("BENCH_details.json" if DIM == 128
                else f"BENCH_details_{DIM}.json")
        with open(name, "w") as fh:
            json.dump(details, fh, indent=2)
    except OSError:
        pass
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
