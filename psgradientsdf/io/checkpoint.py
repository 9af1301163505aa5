"""Checkpoint / resume: exact snapshots of the reconstruction state.

The reference has no checkpointing (SURVEY §5.4) — a crashed run restarts
from scratch; its only artifacts are periodic mesh/pose dumps and a .sdf
volume dump with no loader.  Here the full pipeline state is a pytree of
dense arrays, so a checkpoint is exact by construction:

  * volume: dist/grad/weight/color/vis (+ grid geometry)
  * scan state: frame cursor, current pose, keyframe lists
  * refinement state: poses, lights, iteration index, energy history

Format: a single .npz (atomic rename on save) + a JSON sidecar for
metadata.  Resume is bit-exact: arrays round-trip as float32/uint32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import GradSdfVolume


def _atomic_savez(path: str, **arrays) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # NOTE: np.savez appends ".npz" unless the name already ends with it,
    # so the temp file must carry the suffix for the atomic rename to work.
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_volume(path: str, vol: GradSdfVolume, geom: GridGeometry,
                meta: Optional[Dict[str, Any]] = None) -> None:
    _atomic_savez(
        path,
        dist=np.asarray(vol.dist),
        grad=np.asarray(vol.grad),
        weight=np.asarray(vol.weight),
        color=np.asarray(vol.color),
        vis=np.asarray(vol.vis),
    )
    sidecar = {
        "geometry": {
            "dims": list(geom.dims),
            "voxel_size": geom.voxel_size,
            "shift": list(geom.shift),
        },
        "meta": meta or {},
    }
    # atomic: the sidecar is the last piece written and the first thing
    # resume looks at, so a torn multi-file checkpoint never presents a
    # valid-looking sidecar over incomplete arrays
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".",
                               suffix=".tmp.json")
    with os.fdopen(fd, "w") as fh:
        json.dump(sidecar, fh, indent=2)
    os.replace(tmp, path + ".json")


def load_volume(path: str) -> Tuple[GradSdfVolume, GridGeometry, Dict[str, Any]]:
    data = np.load(path)
    with open(path + ".json") as fh:
        sidecar = json.load(fh)
    g = sidecar["geometry"]
    geom = GridGeometry(
        dims=tuple(g["dims"]), voxel_size=float(g["voxel_size"]),
        shift=tuple(g["shift"]),
    )
    vol = GradSdfVolume(
        dist=jnp.asarray(data["dist"]),
        grad=jnp.asarray(data["grad"]),
        weight=jnp.asarray(data["weight"]),
        color=jnp.asarray(data["color"]),
        vis=jnp.asarray(data["vis"]),
    )
    return vol, geom, sidecar.get("meta", {})


@dataclasses.dataclass
class ScanState:
    """Resumable scan-loop state (the reference's frame loop has none)."""
    next_frame: int
    cur_pose: np.ndarray                  # [4,4]
    pose_lines: List[str]
    key_indices: List[int]
    key_stamps: List[str]
    key_poses: List[np.ndarray]
    dist_to_last_kf: int


def save_scan_state(path: str, vol: GradSdfVolume, geom: GridGeometry,
                    state: ScanState, key_images: List[np.ndarray]) -> None:
    save_volume(path, vol, geom, meta={
        "next_frame": state.next_frame,
        "pose_lines": state.pose_lines,
        "key_indices": state.key_indices,
        "key_stamps": state.key_stamps,
        "dist_to_last_kf": state.dist_to_last_kf,
    })
    _atomic_savez(
        path + ".scan",
        cur_pose=state.cur_pose,
        key_poses=np.stack(state.key_poses) if state.key_poses else np.zeros((0, 4, 4)),
        key_images=np.stack(key_images) if key_images else np.zeros((0, 1, 1, 3)),
    )


def load_scan_state(path: str):
    vol, geom, meta = load_volume(path)
    data = np.load(path + ".scan.npz") if os.path.exists(path + ".scan.npz") \
        else np.load(path + ".scan")
    state = ScanState(
        next_frame=int(meta["next_frame"]),
        cur_pose=data["cur_pose"],
        pose_lines=list(meta["pose_lines"]),
        key_indices=[int(v) for v in meta["key_indices"]],
        key_stamps=list(meta["key_stamps"]),
        key_poses=[p for p in data["key_poses"]],
        dist_to_last_kf=int(meta["dist_to_last_kf"]),
    )
    key_images = [im for im in data["key_images"]]
    return vol, geom, state, key_images


def save_refine_state(path: str, refiner) -> None:
    """Snapshot a PhotometricRefiner mid-optimization (exact resume).

    Saves the compacted RefineProblem arrays verbatim rather than
    re-extracting on load: refinement moves voxel distances, so a fresh
    surface-band extraction from the refined volume could select a
    *different* active set than the run being resumed (the reference also
    freezes the set after init — Optimizer.cpp:30-47).  Also saves the
    alternating-loop scalar state (refiner.loop_state: iteration index,
    auto-normalized reg weights, last energies) so the resumed loop is
    bit-exact, including the iteration-indexed upsample/Laplacian branches.
    """
    refiner.sync_to_volume()
    # the keyframe image stack is invariant during refinement and is by far
    # the largest array — write it on this run's first checkpoint only
    # (unconditionally then, so a stale .images from an older run in the
    # same output dir can never pair with this run's state)
    if not getattr(refiner, "_ckpt_images_saved", False):
        _atomic_savez(path + ".images", images=np.asarray(refiner.images))
        refiner._ckpt_images_saved = True
    prob_arrays = {
        f"prob_{name}": np.asarray(v)
        for name, v in refiner.prob._asdict().items()
    }
    _atomic_savez(
        path + ".refine",
        poses=np.asarray(refiner.poses),
        lights=np.asarray(refiner.lights),
        dist=np.asarray(refiner.dist),
        albedo=np.asarray(refiner.albedo),
        grad_stored=np.asarray(refiner.grad_stored),
        loop_state=np.frombuffer(
            json.dumps(refiner.loop_state or {}).encode(), dtype=np.uint8
        ),
        **prob_arrays,
    )
    # volume + sidecar LAST: the sidecar's phase=refine marker is what
    # resume selection keys on, so it must only appear once every other
    # piece of the checkpoint is durably on disk
    save_volume(path, refiner.vol, refiner.geom, meta={
        "keyframe_indices": refiner.keyframe_indices,
        "timestamps": refiner.timestamps,
        "model": refiner.cfg.model,
        "phase": "refine",
    })


def load_refine_state(path: str, refiner) -> None:
    """Restore a refiner saved with save_refine_state (same config)."""
    vol, geom, meta = load_volume(path)
    p = path + ".refine.npz" if os.path.exists(path + ".refine.npz") else path + ".refine"
    data = np.load(p)
    refiner.vol = vol
    refiner.geom = geom
    refiner.keyframe_indices = [int(v) for v in meta["keyframe_indices"]]
    refiner.timestamps = list(meta["timestamps"])
    if "images" in data:            # legacy checkpoint: images inline
        refiner.images = jnp.asarray(data["images"])
    else:
        ip = path + ".images.npz" if os.path.exists(path + ".images.npz") \
            else path + ".images"
        refiner.images = jnp.asarray(np.load(ip)["images"])
    refiner._ckpt_images_saved = False   # a resumed run re-saves them once
    refiner.poses = jnp.asarray(data["poses"])
    refiner.lights = jnp.asarray(data["lights"])
    from psgradientsdf.refine.problem import RefineProblem, extract_problem

    if "prob_valid" in data:
        refiner.prob = RefineProblem(**{
            name: jnp.asarray(data[f"prob_{name}"])
            for name in RefineProblem._fields
        })
    else:   # legacy checkpoint without the frozen active set
        refiner.prob = extract_problem(vol, geom, refiner.keyframe_indices)
    refiner.dist = jnp.asarray(data["dist"])
    refiner.albedo = jnp.asarray(data["albedo"])
    refiner.grad_stored = jnp.asarray(data["grad_stored"])
    if "loop_state" in data:
        ls = json.loads(bytes(data["loop_state"]).decode() or "{}")
        refiner.loop_state = ls or None
    else:
        refiner.loop_state = None
