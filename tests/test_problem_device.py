"""Device-side extract_problem == host (numpy) oracle, bit-for-bit.

The round-2 build extracted the refinement problem with host numpy
(4-6 s at 128^3 sokrates scale); round 3 moves the masked compaction +
stencil index arithmetic onto the device (refine/problem._extract_device).
Same semantics as OptimizerAux.cpp:237-257 select_vis/getSurfaceVoxel,
already pinned by the existing refinement tests — here we pin device ==
host exactly, field by field.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.refine.problem import (
    extract_problem, extract_problem_host, _pad_cap,
)
from psgradientsdf.utils import se3

from helpers import wavy_scene


@pytest.fixture(scope="module")
def scene():
    # three fused frames so visibility differs per frame, then keyframes
    # pick a strict subset (select_vis re-indexing is exercised)
    offs = [
        np.zeros(6, dtype=np.float32),
        np.array([0.01, -0.008, 0.012, 0.004, -0.003, 0.005], np.float32),
        np.array([-0.012, 0.01, -0.008, -0.005, 0.004, -0.003], np.float32),
    ]
    poses = [jnp.asarray(np.asarray(se3.se3_exp(jnp.asarray(o)))) for o in offs]
    return wavy_scene(dim=40, h=0.03, H=64, W=64, f=60.0, poses=poses)


def assert_probs_equal(pa, pb):
    for name in pa._fields:
        a, b = np.asarray(getattr(pa, name)), np.asarray(getattr(pb, name))
        np.testing.assert_array_equal(a, b, err_msg=f"field {name}")


def test_device_matches_host(scene):
    keyframes = [0, 2]   # subset of the 3 fused frames
    ph = extract_problem_host(scene["vol"], scene["geom"], keyframes)
    pd = extract_problem(scene["vol"], scene["geom"], keyframes)
    assert ph.valid.shape == pd.valid.shape
    assert int(ph.n_surface) == int(pd.n_surface) > 0
    assert_probs_equal(ph, pd)


def test_device_matches_host_explicit_capacity(scene):
    keyframes = [1]
    n = int(extract_problem_host(scene["vol"], scene["geom"], keyframes)
            .n_surface)
    cap = _pad_cap(n) * 2   # non-default capacity
    ph = extract_problem_host(scene["vol"], scene["geom"], keyframes, cap)
    pd = extract_problem(scene["vol"], scene["geom"], keyframes, cap)
    assert_probs_equal(ph, pd)


def test_capacity_overflow_raises(scene):
    keyframes = [0, 1, 2]
    with pytest.raises(ValueError):
        extract_problem(scene["vol"], scene["geom"], keyframes, capacity=4)
