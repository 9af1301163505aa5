"""Multi-process (multi-"host") runtime: 2 CPU processes, one coordinator,
a global 8-device mesh, and a cross-process collective — the SURVEY §5.8
"jax.distributed initialization per host" row, exercised for real.

Each subprocess gets 4 virtual CPU devices (xla_force_host_platform_
device_count), initializes jax.distributed against a shared coordinator,
builds the global z-mesh via parallel.distributed, and runs a sharded
computation whose result requires a cross-process psum.  Runs entirely on
CPU — no pod needed (SURVEY §4 test-strategy row d).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

from psgradientsdf.parallel import distributed

addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
distributed.initialize(coordinator_address=addr, num_processes=nproc,
                       process_id=pid)
info = distributed.process_info()
assert info["process_count"] == nproc, info
assert info["global_devices"] == 4 * nproc, info

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from psgradientsdf.parallel.distributed import make_global_mesh, host_local_slice

mesh = make_global_mesh(n_z=0, n_frames=1)
assert mesh.shape["z"] == 4 * nproc, mesh.shape

# global array sharded over z: each process contributes its local rows
Z = 16
rows_here = host_local_slice(Z, mesh)
local = np.arange(Z, dtype=np.float32)[rows_here]
arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("z")), local, (Z,))

# cross-process reduction: sum of 0..15 == 120
total = jax.jit(lambda x: jnp.sum(x))(arr)
val = float(total)
assert abs(val - 120.0) < 1e-6, val

# a shard_map psum across the global mesh
from jax import shard_map
def body(x):
    return jax.lax.psum(jnp.sum(x), "z")
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("z"),), out_specs=P()))
val2 = float(f(arr))
assert abs(val2 - 120.0) < 1e-6, val2

print(f"WORKER_OK pid={pid} devices={info['global_devices']} sum={val}")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_mesh(tmp_path):
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    nproc = 2
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    script = str(tmp_path / "worker.py")
    with open(script, "w") as fh:
        fh.write(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, script, addr, str(nproc), str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "WORKER_OK" in out, out


WORKER_PIPELINE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from psgradientsdf.parallel import distributed
from psgradientsdf.parallel.distributed import (
    make_global_mesh, host_local_slice,
)
from psgradientsdf.parallel import shard as shard_mod
from psgradientsdf.core.grid import GridGeometry
from psgradientsdf.core.volume import GradSdfVolume, fuse_frame, make_volume
from psgradientsdf.tracking.tracker import track_frame
from psgradientsdf.refine.optimizer import _dist_block
from psgradientsdf.refine.problem import extract_problem
from psgradientsdf.utils.se3 import se3_exp

addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
distributed.initialize(coordinator_address=addr, num_processes=nproc,
                       process_id=pid)

# ---- deterministic scene (every process builds identical data) ----------
DIM, H, W = 32, 48, 64
f = 50.0
h = 0.04
T = 5 * h
geom = GridGeometry(dims=(DIM, DIM, DIM), voxel_size=h, shift=(0.0, 0.0, 1.2))
cx, cy = W / 2.0, H / 2.0
u = np.arange(W, dtype=np.float32)[None, :]
v = np.arange(H, dtype=np.float32)[:, None]
x0 = np.broadcast_to((u - cx) / f, (H, W))
y0 = np.broadcast_to((v - cy) / f, (H, W))
depth = (1.2 + 0.08 * np.sin(6 * x0) * np.cos(5 * y0)
         + 0.05 * np.sin(3 * (x0 + y0))).astype(np.float32)
dgx = 0.08 * 6 * np.cos(6 * x0) * np.cos(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
dgy = -0.08 * 5 * np.sin(6 * x0) * np.sin(5 * y0) + 0.15 * np.cos(3 * (x0 + y0))
n = np.stack([-dgx, -dgy, np.ones_like(dgx)], axis=-1)
n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
nsq = (1.0 / (1.0 + x0 ** 2 + y0 ** 2)).astype(np.float32)
K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], dtype=np.float32)
color = np.full((H, W, 3), 0.5, dtype=np.float32)
eye = np.eye(4, dtype=np.float32)
kw = dict(truncation=T, zmin=0.1, zmax=5.0)

mesh = make_global_mesh(n_z=0, n_frames=1)   # 8-way z across 2 processes
n_z = mesh.shape["z"]
assert n_z == 4 * nproc

# ---- single-device reference (local) ------------------------------------
vol_ref = fuse_frame(make_volume(geom, T, frame_cap=32), geom,
                     jnp.asarray(color), jnp.asarray(depth), jnp.asarray(n),
                     jnp.asarray(nsq), jnp.asarray(K), jnp.asarray(eye),
                     jnp.int32(0), **kw)
vol_ref_np = GradSdfVolume(*(np.asarray(a) for a in vol_ref))

# ---- process-spanning culled fusion -------------------------------------
rows = host_local_slice(DIM, mesh)

def gput(local_np, global_shape, spec):
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(*spec)), np.ascontiguousarray(local_np),
        global_shape)

init = make_volume(geom, T, frame_cap=32)
init_np = GradSdfVolume(*(np.asarray(a) for a in init))
vol_g = GradSdfVolume(
    dist=gput(init_np.dist[rows], init_np.dist.shape, ("z", None, None)),
    grad=gput(init_np.grad[rows], init_np.grad.shape, ("z", None, None, None)),
    weight=gput(init_np.weight[rows], init_np.weight.shape, ("z", None, None)),
    color=gput(init_np.color[rows], init_np.color.shape, ("z", None, None, None)),
    vis=gput(init_np.vis[:, rows], init_np.vis.shape, (None, "z", None, None)),
)
cap_shard = (DIM // n_z) * DIM
fuse_g = jax.jit(shard_mod.sharded_fuse_frame_culled_fn(
    mesh, geom, **kw, row_capacity=cap_shard))
vol_g, ov = fuse_g(vol_g, color, depth, n, nsq, K, eye, jnp.int32(0))
assert not bool(ov)
for name in GradSdfVolume._fields:
    garr = getattr(vol_g, name)
    ref = getattr(vol_ref_np, name)
    for s in garr.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(s.data), ref[s.index], err_msg=f"fusion field {name}")

# ---- process-spanning shard_map/psum tracker ----------------------------
seed_pose = np.asarray(se3_exp(jnp.asarray(
    np.array([0.01, -0.008, 0.012, 0.004, -0.003, 0.005], np.float32))))
tkw = dict(truncation=T, zmin=0.1, zmax=5.0, num_iterations=8,
           conv_threshold_sq=0.0, damping=1.0)
track_g = shard_mod.make_sharded_tracker(
    mesh, geom, depth.shape, **tkw, early_exit=False, regather_every=4)
res_g = track_g(vol_g, depth, K, seed_pose)
res_ref = track_frame(vol_ref, geom, jnp.asarray(depth), jnp.asarray(K),
                      jnp.asarray(seed_pose), **tkw, early_exit=False,
                      regather_every=4)
np.testing.assert_allclose(np.asarray(res_g.pose), np.asarray(res_ref.pose),
                           atol=2e-5)

# ---- process-spanning GSPMD refinement distance block -------------------
prob_ref = extract_problem(vol_ref, geom, [0])
capacity = int(prob_ref.valid.shape[0])
assert capacity % n_z == 0
images = np.full((1, H, W, 3), 0.45, dtype=np.float32)
images[0, :, :, 0] = 0.3 + 0.3 * np.abs(np.sin(7 * x0))
poses = eye[None]
lights = np.array([[0.02, 0.1, -0.1, -0.9]], dtype=np.float32)
dist0 = np.asarray(prob_ref.dist)
albedo0 = np.asarray(prob_ref.albedo)
grad0 = np.asarray(prob_ref.grad_stored)
skw = dict(model="SH1", order=1, loss=1, lam=0.2, voxel_size=h)

d_ref, g_ref = _dist_block(
    prob_ref, geom, jnp.asarray(dist0), jnp.asarray(albedo0),
    jnp.asarray(grad0), jnp.asarray(poses), jnp.asarray(images),
    jnp.asarray(K), jnp.asarray(lights), **skw,
    reg_weight_n=0.5, reg_weight_l=0.0, damping=1.0,
    laplacian_diag_only=False)

nl = capacity // n_z
rows_n = host_local_slice(capacity, mesh)

def nshard(a):
    a = np.asarray(a)
    if a.ndim == 0 or a.shape[0] != capacity:
        return a          # scalars stay replicated (uniform on every process)
    return gput(a[rows_n], a.shape, ("z",) + (None,) * (a.ndim - 1))

prob_g = type(prob_ref)(*(nshard(a) for a in prob_ref))
d_g, g_g = _dist_block(
    prob_g, geom, nshard(dist0), nshard(albedo0), nshard(grad0),
    jnp.asarray(poses), jnp.asarray(images), jnp.asarray(K),
    jnp.asarray(lights), **skw,
    reg_weight_n=0.5, reg_weight_l=0.0, damping=1.0,
    laplacian_diag_only=False)
d_ref_np, g_ref_np = np.asarray(d_ref), np.asarray(g_ref)
for garr, ref in ((d_g, d_ref_np), (g_g, g_ref_np)):
    for s in garr.addressable_shards:
        np.testing.assert_allclose(np.asarray(s.data), ref[s.index],
                                   rtol=2e-4, atol=2e-5)

print(f"WORKER_PIPELINE_OK pid={pid} nz={n_z} cap={capacity}")
"""


@pytest.mark.slow
def test_two_process_pipeline_stages(tmp_path):
    """Round-2 VERDICT #4: actual pipeline stages — Z-slab culled fusion,
    the shard_map/psum tracker, and a GSPMD refinement distance block —
    run PROCESS-SPANNING on the 2-process global mesh and match the
    single-device reference (fusion bit-exact, tracker/dist to float
    reduction tolerance)."""
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    nproc = 2
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    script = str(tmp_path / "worker_pipeline.py")
    with open(script, "w") as fh:
        fh.write(WORKER_PIPELINE)
    procs = [
        subprocess.Popen(
            [sys.executable, script, addr, str(nproc), str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=480)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "WORKER_PIPELINE_OK" in out, out
