"""Named "track config" JSON key -> pinned tracker configurations
(tracking/configs.py; round-4 VERDICT #2 coupling)."""

import pytest

from psgradientsdf.config import parse_config
from psgradientsdf.tracking import configs


def _cfg(extra):
    return parse_config({
        "input": "/x", "output": "", "datatype": "tum", **extra,
    }, save_copy=False)


def test_named_track_configs():
    c = _cfg({"track config": "streaming"})
    assert c.tracking.num_iterations == configs.STREAMING["num_iterations"]
    assert c.engine.track_regather == configs.STREAMING["regather_every"]
    assert c.engine.track_static is True

    c = _cfg({"track config": "parity"})
    assert c.tracking.num_iterations == 12
    assert c.engine.track_regather == 4
    assert c.engine.track_static is True

    c = _cfg({"track config": "reference"})
    assert c.tracking.num_iterations == 50
    assert c.engine.track_regather == 1
    assert c.engine.track_static is False
    assert c.tracking.conv_threshold == pytest.approx(1e-3)


def test_unknown_track_config_raises():
    with pytest.raises(ValueError, match="track config"):
        _cfg({"track config": "warp9"})


def test_bench_and_ate_share_config_objects():
    """The coupling contract: the dicts bench.py times are the dicts the
    ATE tests measure, and every named config has a pinned production
    ATE."""
    for name in ("reference", "streaming", "parity", "streaming_fast"):
        assert name in configs.PRODUCTION_ATE_M
    # the parity config really is at C++ parity in the pinned table
    assert configs.PRODUCTION_ATE_M["parity"] <= \
        configs.PRODUCTION_ATE_M["cpp"] * 1.2
    # and the retired fast config's pinned ATE documents why it was
    # retired (an order of magnitude off)
    assert configs.PRODUCTION_ATE_M["streaming_fast"] > \
        configs.PRODUCTION_ATE_M["cpp"] * 5
