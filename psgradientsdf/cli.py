"""Command-line entry point: `python -m psgradientsdf.cli --config_file x.json`.

Replaces the reference's CLI11 voxelPS binary (cpp/voxel_ps/src/main_ps.cpp:54-62)
with the same single --config_file interface plus a few extras.
"""

from __future__ import annotations

import argparse
import json
import sys

from psgradientsdf.config import load_config
from psgradientsdf.pipeline import ReconstructionPipeline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="psgradientsdf",
        description="RGB-D reconstruction via Gradient-SDF + "
        "multi-view photometric refinement (JAX/XLA)",
    )
    ap.add_argument("--config_file", required=True, help="JSON config (reference schema)")
    ap.add_argument("--no-refine", action="store_true",
                    help="stop after tracking+fusion (skip photometric refinement)")
    ap.add_argument("--summary-json", default="",
                    help="write the run summary to this JSON file")
    ap.add_argument("--platform", default="", choices=["", "cpu", "gpu"],
                    help="force a jax platform (e.g. cpu) before any device use")
    ap.add_argument("--mesh", default="", metavar="ZxF",
                    help="device mesh for multi-chip execution, e.g. 4x2 "
                         "(Z-slab shards x keyframe shards) or just 8 "
                         "(all-z); overrides the config's \"mesh shape\". "
                         "Routes the scan through the shard_map/psum "
                         "tracker + sharded fusion and the refinement "
                         "through the GSPMD blocks (SURVEY §5.7-5.8)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save a resumable checkpoint every N scan frames "
                         "and every N refinement iterations")
    ap.add_argument("--resume", default="",
                    help="resume from a checkpoint written by "
                         "--checkpoint-every (path to scan_checkpoint.npz "
                         "or refine_checkpoint.npz; the refine one resumes "
                         "mid-refinement, skipping the completed scan)")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="capture a jax.profiler device trace of the whole "
                         "run into DIR (view with tensorboard/xprof; "
                         "SURVEY §5.1 — replaces the reference's tic/toc-"
                         "only instrumentation)")
    ap.add_argument("--retries", type=int, default=0, metavar="N",
                    help="elastic recovery: on a runtime failure (device "
                         "loss, out of memory) retry the run up to N times, "
                         "resuming from the latest scan checkpoint when "
                         "--checkpoint-every produced one (SURVEY §5.3 — "
                         "the reference restarts from scratch)")
    ap.add_argument("--eval-ate", default="", metavar="GT_FILE",
                    help="after the run, associate the written "
                         "tracking_poses.txt with this TUM-format ground-"
                         "truth trajectory by timestamp and report "
                         "ATE-RMSE (the reference defers this to external "
                         "tooling; SURVEY §4)")
    args = ap.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    print(f"load the config file from: {args.config_file}")
    cfg = load_config(args.config_file)
    if args.mesh:
        parts = args.mesh.lower().split("x")
        try:
            cfg.engine.mesh_z = int(parts[0])
            cfg.engine.mesh_frames = int(parts[1]) if len(parts) > 1 else 1
        except (ValueError, IndexError):
            ap.error(f"--mesh expects ZxF or Z, got {args.mesh!r}")

    import contextlib
    if args.profile:
        import jax
        trace_ctx = jax.profiler.trace(args.profile)
    else:
        trace_ctx = contextlib.nullcontext()

    import os as _os
    import time as _time

    resume = args.resume
    attempt = 0
    t_start = _time.time()
    # deterministic setup/config errors are never worth retrying
    _NO_RETRY = (FileNotFoundError, ValueError, KeyError, TypeError,
                 NotImplementedError)
    with trace_ctx:
        while True:
            # the pipeline turns on the persistent compile cache for the
            # whole run (utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR,
            # else <checkout>/.jax_cache)
            pipe = ReconstructionPipeline(
                cfg, checkpoint_every=args.checkpoint_every, resume=resume)
            try:
                summary = pipe.run(refine=not args.no_refine)
                break
            except _NO_RETRY:
                raise
            except Exception as e:  # elastic recovery (SURVEY §5.3)
                # the failed pipeline's async init-artifact export must not
                # keep writing stale-volume files into the output dir while
                # the retry attempt runs (or be torn at interpreter exit)
                pipe._join_export(swallow=True)
                attempt += 1
                if attempt > args.retries:
                    raise
                # resume only from a checkpoint THIS run wrote — a stale
                # checkpoint from an earlier run in the same output dir
                # must not leak into this one; prefer the newest phase
                # (a refine checkpoint supersedes the scan one); skip any
                # checkpoint whose companion files are missing (a save torn
                # mid-write by the very failure being recovered from)
                def _complete(p):
                    if not (_os.path.exists(p)
                            and _os.path.exists(p + ".json")):
                        return False
                    try:
                        with open(p + ".json") as fh:
                            phase = json.load(fh).get("meta", {}).get(
                                "phase", "")
                    except (OSError, json.JSONDecodeError):
                        return False
                    if phase == "refine":
                        return (any(_os.path.exists(p + s)
                                    for s in (".refine.npz", ".refine"))
                                and any(_os.path.exists(p + s)
                                        for s in (".images.npz", ".images")))
                    return any(_os.path.exists(p + s)
                               for s in (".scan.npz", ".scan"))

                cand = [
                    _os.path.join(cfg.tracking.output, name)
                    for name in ("scan_checkpoint.npz", "refine_checkpoint.npz")
                ]
                cand = [p for p in cand if _os.path.exists(p)
                        and _os.path.getmtime(p) >= t_start and _complete(p)]
                if args.checkpoint_every > 0 and cand:
                    resume = max(cand, key=_os.path.getmtime)
                else:
                    resume = args.resume
                print(f"run failed ({type(e).__name__}: {e}); retry "
                      f"{attempt}/{args.retries}"
                      + (f" resuming from {resume}" if resume else
                         " from scratch"))
                backoff = float(_os.environ.get("PSGSDF_RETRY_BACKOFF", "30"))
                _time.sleep(min(backoff * attempt, 120.0))
    if args.eval_ate:
        from psgradientsdf.io.trajectory import evaluate_ate

        # pipeline.py writes tracking_poses.txt only when an output dir is
        # configured — a missing trajectory must not crash a successful run
        traj = (_os.path.join(cfg.tracking.output, "tracking_poses.txt")
                if cfg.tracking.output else "")
        if traj and _os.path.exists(traj):
            summary["ate"] = evaluate_ate(traj, args.eval_ate)
        else:
            print("--eval-ate: no tracking_poses.txt (config has no output "
                  "dir or the scan wrote no trajectory); skipping ATE",
                  file=sys.stderr)
            summary["ate"] = None
    summary_small = {k: v for k, v in summary.items() if k != "track_log"}
    print(json.dumps(summary_small, default=float))
    if args.summary_json:
        with open(args.summary_json, "w") as fh:
            json.dump(summary, fh, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
