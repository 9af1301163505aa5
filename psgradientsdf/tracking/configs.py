"""Named tracker configurations — the single source of truth coupling
every published fps number to its pinned ATE (round-4 VERDICT #2).

bench.py reads these dicts to run its timed legs and records them next to
the fps they produced;
tests/test_ate_parity.py measures the SAME dicts' ATE on the CI and
production anchors.  A reader of the bench artifact therefore always sees
"this fps was produced by this config, whose production-anchor ATE is
pinned at X" — the two can no longer be paired wrongly.

The production-anchor ATE numbers quoted in the comments are measured by
tests/test_ate_parity.py::test_ate_production_anchor (640x480 @ 128^3,
120-frame handheld trajectory, dropout + speckle; PSGSDF_TEST_BIG_ATE=1).
They are accuracy pins, first measured on the accelerator the system was
built for; chip_smoke.py's parity phase re-measures them on the GPU.
"""

from __future__ import annotations

# The reference's own semantics (RigidPointOptimizer.cpp:27-76): up to 50
# GN iterations, early exit on ||xi||^2 < 1e-6, fresh correspondences
# every iteration.  ATE parity: beats the C++ reference on the production
# anchor (0.372 mm vs 0.375 mm, round 4).
REFERENCE = dict(
    num_iterations=50, conv_threshold_sq=1e-6, damping=1.0,
    early_exit=True, regather_every=1, stride=1,
)

# The production streaming configuration used by bench.py's headline fps:
# fixed-trip frozen-correspondence rounds (static control flow, no
# per-iteration exit test).  Two
# gathers + 8 GN steps per frame; production ATE 0.695 mm = 1.85x C++
# (sub-voxel: 5% of a 128^3 voxel).
STREAMING = dict(
    num_iterations=8, conv_threshold_sq=1e-6, damping=1.0,
    early_exit=False, regather_every=4, stride=1,
)

# ATE-PARITY streaming config (round 5): three correspondence gathers +
# 12 fixed-trip steps.  Production ATE 0.371 mm — BEATS the C++
# reference (0.375 mm) while keeping the static-control-flow program.
# The round-5 curve (bench/ate_curve.py) showed the gather COUNT is the
# accuracy dial: 2 gathers -> 0.695 mm, >=3 gathers -> C++ parity.
PARITY = dict(
    num_iterations=12, conv_threshold_sq=1e-6, damping=1.0,
    early_exit=False, regather_every=4, stride=1,
)

# Cheaper variant the ROUND-4 bench's timed chain actually used (ONE
# gather + 4 steps).  The round-5 curve measured its production ATE at
# 4.08 mm — 10.9x the C++ reference — so it is NOT a valid headline
# config; kept only as the recorded negative on the tradeoff curve.
STREAMING_FAST = dict(
    num_iterations=4, conv_threshold_sq=1e-6, damping=1.0,
    early_exit=False, regather_every=4, stride=1,
)

# Production-anchor ATE-RMSE (meters) per config, measured 2026-08-21 by
# bench/ate_curve.py on the test_ate_parity production scenario (640x480
# @ 128^3, 120-frame handheld orbit, 6% dropout, 0.3% speckle) and
# re-asserted by test_ate_parity.py::test_ate_production_anchor.
# bench.py records these next to the fps each config produces.
PRODUCTION_ATE_M = {
    "cpp": 0.0003751,
    "reference": 0.0003743,
    "streaming": 0.0006954,         # STREAMING (it8, regather 4)
    "parity": 0.0003712,            # PARITY (it12, regather 4)
    "streaming_fast": 0.0040845,    # STREAMING_FAST — the negative
    "streaming_stride2": 0.0007555,
}
