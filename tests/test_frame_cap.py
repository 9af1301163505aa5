"""Visibility frame-capacity semantics (round-4 VERDICT #5).

The reference's per-voxel visibility `std::vector<bool>` grows with the
frame counter without limit (cpp/include/sdf_tracker/VolumetricGradSdf.h:
40-42, VolumetricGradSdf.cpp:129-131).  The rebuild bit-packs visibility
into a static word capacity; these tests pin the round-5 contract:

  * the pipeline AUTO-SIZES the capacity from the config frame range
    (last - first + 1, rounded up to a 32-bit word) unless "frame cap"
    was given explicitly — so sequences longer than the old 256 default
    get correct, un-aliased bits;
  * an explicitly-set capacity that the frame range exceeds still runs
    (late frames alias the LAST bit) but surfaces the aliasing: a
    metrics warning + the `vis_overflow` run-summary flag.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from psgradientsdf.config import parse_config
from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import fuse_frame, make_volume
from psgradientsdf.pipeline import ReconstructionPipeline


def _cfg(extra=None, **kw):
    base = {
        "input": kw.pop("input", "/nonexistent"), "output": "",
        "datatype": "tum", "first": kw.pop("first", 0),
        "last": kw.pop("last", 7), "voxel size": 0.015,
        "grid dim": 32, "chunk size": 3, "sharpness threshold": 0.0,
    }
    base.update(extra or {})
    return parse_config(base, save_copy=False)


def test_frame_cap_autosizes_from_frame_range():
    # 300 frames (0..299) > the 256 default: auto-size to ceil32(300)=320
    p = ReconstructionPipeline(_cfg(first=0, last=299), prefetch=False)
    assert p._frame_cap == 320
    # offset range: 50..250 inclusive = 201 frames -> 224
    p = ReconstructionPipeline(_cfg(first=50, last=250), prefetch=False)
    assert p._frame_cap == 224
    # unbounded `last` keeps the configured default capacity
    p = ReconstructionPipeline(_cfg(last=2 ** 31 - 1), prefetch=False)
    assert p._frame_cap == 256
    # explicit "frame cap" wins over auto-sizing
    p = ReconstructionPipeline(
        _cfg(first=0, last=299, extra={"frame cap": 64}), prefetch=False)
    assert p._frame_cap == 64


def test_vis_bits_correct_past_default_cap():
    """A frame id beyond the old 256-word default lands in the right word/
    bit of an auto-sized volume (the fusion math itself is id-agnostic)."""
    geom = GridGeometry(dims=(16, 16, 16), voxel_size=0.1, shift=(0.0, 0.0, 1.2))
    T = 0.5
    vol = make_volume(geom, truncation=T, frame_cap=320)
    assert vol.vis.shape[0] == 10
    H, W = 24, 32
    f = 30.0
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    depth = jnp.full((H, W), 1.2, jnp.float32)
    normals = jnp.broadcast_to(
        jnp.array([0.0, 0.0, -1.0], jnp.float32), (H, W, 3))
    nsq = jnp.ones((H, W), jnp.float32)
    color = jnp.full((H, W, 3), 0.5, jnp.float32)
    vol = fuse_frame(vol, geom, color, depth, normals, nsq, K,
                     jnp.eye(4, dtype=jnp.float32), jnp.int32(299),
                     truncation=T, zmin=0.1, zmax=5.0)
    vis = np.asarray(vol.vis)
    fused = np.asarray(vol.weight) > 0
    assert fused.any()
    # frame 299 = word 9, bit 11 — set exactly where fusion happened,
    # and no other word/bit anywhere
    assert (vis[9][fused] == np.uint32(1 << 11)).all()
    assert (vis[:9] == 0).all()
    assert (vis[9][~fused] == 0).all()


@pytest.fixture(scope="module")
def tum40(tmp_path_factory):
    from tests.test_e2e_tum_tracking import make_tum_dataset

    root = str(tmp_path_factory.mktemp("tum40") / "data") + "/"
    make_tum_dataset(root, n_frames=40, H=48, W=64)
    return root


def _run(root, out, extra=None):
    cfg = _cfg(input=root, first=0, last=39,
               extra={"pose filename": "groundtruth.txt", **(extra or {})})
    cfg.tracking.output = out
    os.makedirs(out, exist_ok=True)
    p = ReconstructionPipeline(cfg, prefetch=False)
    return p, p.run(refine=False)


def test_explicit_cap_overflow_warns(tmp_path, tum40):
    """40 frames into an explicit 32-bit capacity: runs, aliases the last
    bit, and says so (metrics warning + summary flag)."""
    out = str(tmp_path / "out") + "/"
    p, summary = _run(tum40, out, extra={"frame cap": 32})
    assert p._frame_cap == 32
    assert summary["vis_overflow"] is True
    assert summary["frame_cap"] == 32
    events = [json.loads(l) for l in
              open(os.path.join(out, "metrics.jsonl"))]
    warns = [e for e in events if e.get("event") == "warn_vis_overflow"]
    assert len(warns) == 1 and warns[0]["frame_cap"] == 32
    # frames 32..39 aliased onto bit 31: it must be set somewhere
    vis = np.asarray(p.vol.vis)
    assert vis.shape[0] == 1
    assert (vis[0] & np.uint32(1 << 31)).any()


def test_autosized_cap_no_overflow(tmp_path, tum40):
    """The same 40-frame run auto-sized: capacity 64, no warning, frames
    past 31 get their own bits in word 1."""
    out = str(tmp_path / "out") + "/"
    p, summary = _run(tum40, out)
    assert p._frame_cap == 64
    assert summary["vis_overflow"] is False
    events = [json.loads(l) for l in
              open(os.path.join(out, "metrics.jsonl"))]
    assert not any(e.get("event") == "warn_vis_overflow" for e in events)
    vis = np.asarray(p.vol.vis)
    assert vis.shape[0] == 2
    # frame 39 = word 1, bit 7 — present for the voxels the last frame saw
    assert (vis[1] & np.uint32(1 << 7)).any()
