"""Checkpoint/resume exactness + prefetch loader semantics."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.config import OptimizerConfig, SH1
from psgradientsdf.io import checkpoint as ckpt
from psgradientsdf.io.prefetch import PrefetchLoader
from psgradientsdf.refine.optimizer import PhotometricRefiner
from psgradientsdf.utils import robust

from helpers import wavy_scene, shaded_images


def test_volume_roundtrip_exact(tmp_path):
    sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0)
    path = str(tmp_path / "vol.npz")
    ckpt.save_volume(path, sc["vol"], sc["geom"], meta={"frame": 7})
    vol2, geom2, meta = ckpt.load_volume(path)
    assert meta["frame"] == 7
    assert geom2 == sc["geom"]
    for a, b in zip(sc["vol"], vol2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_refine_state_roundtrip(tmp_path):
    sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0)
    light = jnp.array([0.1, 0.2, -0.15, 0.85], dtype=jnp.float32)
    images = shaded_images(sc["frames"], light, order=1)
    cfg = OptimizerConfig(model=SH1, loss=robust.CAUCHY, lam=0.2)

    def build():
        r = PhotometricRefiner(
            sc["vol"], sc["geom"], cfg, np.asarray(sc["K"]),
            truncation=sc["truncation"],
        )
        r.set_keyframes(images, jnp.eye(4, dtype=jnp.float32)[None], [0], ["000"])
        r.init()
        return r

    r1 = build()
    r1.init_albedo()
    r1.lights = r1.lights + 0.01
    path = str(tmp_path / "refine.npz")
    ckpt.save_refine_state(path, r1)

    r2 = build()
    ckpt.load_refine_state(path, r2)
    np.testing.assert_array_equal(np.asarray(r1.dist), np.asarray(r2.dist))
    np.testing.assert_array_equal(np.asarray(r1.albedo), np.asarray(r2.albedo))
    np.testing.assert_array_equal(np.asarray(r1.lights), np.asarray(r2.lights))
    # energies identical after resume -> exact state restoration
    np.testing.assert_allclose(r1.energies(), r2.energies(), rtol=1e-6)


def test_refine_midrun_checkpoint_resume_exact(tmp_path):
    """A run resumed from a mid-loop checkpoint must finish bit-identical
    to the uninterrupted run (SURVEY §5.4: resume must be exact)."""
    from psgradientsdf.utils import se3

    def build():
        poses = [jnp.eye(4, dtype=jnp.float32),
                 se3.se3_exp(0.02 * jnp.asarray(
                     np.random.RandomState(1).randn(6).astype(np.float32)))]
        sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0, poses=poses)
        light = jnp.array([0.1, 0.2, -0.15, 0.85], dtype=jnp.float32)
        images = shaded_images(sc["frames"], light, order=1)
        cfg = OptimizerConfig(
            max_it=4, conv_threshold=1e-9, damping=1.0, lam=0.2,
            reg_weight_n=1.0, reg_weight_l=0.0, reg_weight_rho=0.0,
            order=1, model=SH1, loss=robust.CAUCHY,
        )
        r = PhotometricRefiner(
            sc["vol"], sc["geom"], cfg, np.asarray(sc["K"]),
            truncation=sc["truncation"],
        )
        r.set_keyframes(images, jnp.stack(poses), [0, 1], ["000", "001"])
        r.init()
        return r

    rA = build()                       # uninterrupted 4-iteration run
    rA.alternating_optimize(True, True, True, True)

    rB = build()                       # same run, checkpointing at it=3
    rB.checkpoint_every = 3
    rB.checkpoint_path = str(tmp_path / "refine_checkpoint.npz")
    rB.alternating_optimize(True, True, True, True)
    assert os.path.exists(rB.checkpoint_path)

    rC = build()                       # fresh refiner, state overwritten
    ckpt.load_refine_state(rB.checkpoint_path, rC)
    assert rC.loop_state is not None and rC.loop_state["it"] == 3
    rC.alternating_optimize(True, True, True, True)
    assert rC.loop_state is None       # run-to-completion clears the state

    for name in ("dist", "albedo", "lights", "poses"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rA, name)), np.asarray(getattr(rC, name)),
            err_msg=name,
        )


def test_refine_checkpoint_after_upsample_resumes_exact(tmp_path):
    """Checkpoints straddling the iter-5 upsample (8x voxel count, new
    problem capacities) must restore the post-upsample shapes verbatim and
    resume bit-exactly.  The upsample + loop state are planted directly
    (alternating GN is not monotone on this scene, so a natural run rarely
    survives to iteration 6 — the divergence abort is reference behavior)."""
    from psgradientsdf.utils import se3

    def build():
        poses = [jnp.eye(4, dtype=jnp.float32),
                 se3.se3_exp(0.02 * jnp.asarray(
                     np.random.RandomState(1).randn(6).astype(np.float32)))]
        sc = wavy_scene(dim=24, h=0.05, H=40, W=40, f=38.0, poses=poses)
        light = jnp.array([0.1, 0.2, -0.15, 0.85], dtype=jnp.float32)
        images = shaded_images(sc["frames"], light, order=1)
        cfg = OptimizerConfig(
            max_it=7, conv_threshold=1e-12, damping=1.0, lam=0.2,
            reg_weight_n=1.0, reg_weight_l=0.0, reg_weight_rho=0.0,
            order=1, model=SH1, loss=robust.CAUCHY, upsample=True,
        )
        r = PhotometricRefiner(
            sc["vol"], sc["geom"], cfg, np.asarray(sc["K"]),
            truncation=sc["truncation"],
        )
        r.set_keyframes(images, jnp.stack(poses), [0, 1], ["000", "001"])
        r.init()
        return r

    rB = build()
    rB.init_albedo()
    rB._upsample()                  # the iter-5 8x subdivision
    assert rB.geom.dims == (48, 48, 48)
    E, E_n, E_l, E_r = (float(v) for v in rB.energies())
    rB.loop_state = {               # boundary state right after iteration 5
        "it": 6, "w_n": 1.0, "w_l": 0.5, "w_rho": 0.0,
        "normal_reg": True, "albedo_reg": False, "laplacian_reg": True,
        "E": E, "E_n": E_n, "E_l": E_l, "E_r": E_r,
        "E_vec": [1e9, E + E_n + 0.5 * E_l],   # huge first entry: no abort
    }
    path = str(tmp_path / "refine_checkpoint.npz")
    ckpt.save_refine_state(path, rB)

    rC = build()                    # pre-upsample shapes, then restored over
    ckpt.load_refine_state(path, rC)
    assert rC.loop_state is not None and rC.loop_state["it"] == 6
    assert rC.geom.dims == (48, 48, 48)
    assert rC.dist.shape == rB.dist.shape      # post-upsample capacity
    for name in ("dist", "albedo", "lights", "poses", "grad_stored"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rB, name)), np.asarray(getattr(rC, name)),
            err_msg=f"restore:{name}",
        )

    # both twins resume from it=6 and must finish bit-identically
    doneB = rB.alternating_optimize(True, True, True, True)
    doneC = rC.alternating_optimize(True, True, True, True)
    assert doneB == doneC
    for name in ("dist", "albedo", "lights", "poses"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rB, name)), np.asarray(getattr(rC, name)),
            err_msg=f"resume:{name}",
        )


class FakeLoader:
    """Deterministic in-memory loader for prefetch tests."""

    def __init__(self, n=7):
        self.n = n
        self.i = 0
        self.K = np.eye(3, dtype=np.float32)
        self.rgb_timestamp = ""
        self.depth_timestamp = ""

    def load_next(self):
        if self.i >= self.n:
            return None
        v = float(self.i)
        self.rgb_timestamp = f"r{self.i}"
        self.depth_timestamp = f"d{self.i}"
        self.i += 1
        return (np.full((4, 4, 3), v, np.float32), np.full((4, 4), v, np.float32))

    def reset(self):
        self.i = 0


def test_prefetch_order_and_timestamps():
    pf = PrefetchLoader(FakeLoader(5), depth=2)
    seen = []
    while True:
        item = pf.load_next()
        if item is None:
            break
        seen.append((float(item[1][0, 0]), pf.rgb_timestamp, pf.depth_timestamp))
    assert seen == [(float(i), f"r{i}", f"d{i}") for i in range(5)]


def test_prefetch_reset_midstream():
    pf = PrefetchLoader(FakeLoader(6), depth=2)
    a = pf.load_next()
    assert float(a[1][0, 0]) == 0.0
    pf.reset()
    b = pf.load_next()
    assert float(b[1][0, 0]) == 0.0
    # and the full sequence still arrives in order
    vals = [0.0]
    while True:
        item = pf.load_next()
        if item is None:
            break
        vals.append(float(item[1][0, 0]))
    assert vals == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
