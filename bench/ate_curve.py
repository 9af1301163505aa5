"""Production-anchor fps/ATE tradeoff curve (round-4 VERDICT #2/#3).

Builds the production ATE scene ONCE (640x480 @ 128^3, 120-frame handheld
trajectory with dropout + speckle — the same scenario as
tests/test_ate_parity.py::test_ate_production_anchor) and evaluates the
C++ reference tracker plus a grid of streaming-tracker configurations, so
the bench's headline config can be chosen with its accuracy cost pinned
(VERDICT #3: close the streaming ATE gap or pin the tradeoff curve).

Run on CPU (tracking at this scale is minutes/config):
    python bench/ate_curve.py            # prints one JSON dict
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_ate_parity import build_scene, jax_track_ate, run_cpp  # noqa: E402

from psgradientsdf.tracking import configs  # noqa: E402


def main() -> int:
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="ate_curve_")
    print(f"[ate-curve] rendering production scene ...", file=sys.stderr)
    sc = build_scene(tmp, W=640, H=480, DIM=128, F=120,
                     handheld=True, dropout=0.06, speckle=0.003)
    print(f"[ate-curve] scene ready ({time.time()-t0:.0f}s); C++ ...",
          file=sys.stderr)
    results = {"cpp": run_cpp(sc)}
    print(f"[ate-curve] cpp={results['cpp']:.6f} ({time.time()-t0:.0f}s)",
          file=sys.stderr)

    runs = {
        "reference": configs.REFERENCE,
        "streaming_it8_r4": configs.STREAMING,
        "streaming_it4_r4": configs.STREAMING_FAST,
        # polish: one full frozen round + a fresh-gather single step
        "streaming_it5_r4": dict(configs.STREAMING, num_iterations=5),
        # more rounds
        "streaming_it12_r4": dict(configs.STREAMING, num_iterations=12),
        # shorter rounds (fresher correspondences, same 8-iteration budget)
        "streaming_it8_r2": dict(configs.STREAMING, regather_every=2),
        "streaming_it6_r3": dict(configs.STREAMING, num_iterations=6,
                                 regather_every=3),
        # the reference's own pixel-subsampling lever on the shipped config
        "streaming_it8_r4_stride2": dict(configs.STREAMING, stride=2),
    }
    for name, kw in runs.items():
        t1 = time.time()
        results[name] = jax_track_ate(sc, **kw)
        print(f"[ate-curve] {name}={results[name]:.6f} "
              f"({time.time()-t1:.0f}s)", file=sys.stderr)

    out = {k: round(float(v), 7) for k, v in results.items()}
    out["scenario"] = ("640x480 @ 128^3, 120-frame handheld orbit, 6% "
                      "dropout, 0.3% speckle (test_ate_parity production "
                      "anchor)")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
