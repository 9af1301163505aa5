"""Regression pin for the round-2 keyframe-scale fix.

Under the raw-wire prefetch loader the pipeline used to store keyframe 0 as
a metric float image ([0,1]) while every gate-kept keyframe stayed raw
uint8; np.stack promoted the mix to float32 and set_keyframes skipped the
/255 conversion — the refinement ran on 0-255 intensities with keyframe 0
255x dimmer.  All keyframes must reach the refiner in the reference's
[0,1] scale (ImageLoader.h:167-188), on the same scale as each other, and
(after the device-retention change) via the already-uploaded device
buffers.
"""

import numpy as np

from psgradientsdf.config import parse_config
from psgradientsdf.pipeline import ReconstructionPipeline
from psgradientsdf.refine.optimizer import PhotometricRefiner

from test_e2e_led_cli import make_led_dataset


def test_keyframe_images_uniform_unit_scale(tmp_path, monkeypatch):
    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    make_led_dataset(data, n_frames=4)
    cfg = parse_config({
        "input": data, "output": out, "pose filename": "pose.txt",
        "datatype": "led", "first": 0, "last": 3, "voxel size": 0.02,
        "truncation factor": 5, "zmin": 0.3, "zmax": 3.5,
        "sharpness threshold": 0.0, "model type": "LED",
        "loss function": "cauchy", "lambda": 0.2, "reg norm": 0.5,
        "max iter": 1, "grid dim": 32,
    }, save_copy=False)

    captured = {}
    orig_init = PhotometricRefiner.init

    def probe_init(self):
        captured["images"] = np.asarray(self.images)
        orig_init(self)

    monkeypatch.setattr(PhotometricRefiner, "init", probe_init)
    # prefetch=True = the raw-wire path the CLI uses (the buggy one)
    ReconstructionPipeline(cfg, prefetch=True).run(refine=True)

    im = captured["images"]
    assert im.dtype == np.float32
    maxes = im.reshape(im.shape[0], -1).max(axis=1)
    # reference scale: [0,1] (ImageLoader.h:167-188)
    assert float(maxes.max()) <= 1.0 + 1e-6, maxes
    # every keyframe on the SAME scale: the scene's frames have near-equal
    # dynamic range, so no frame may be off by orders of magnitude
    assert float(maxes.min()) > 0.25 * float(maxes.max()), maxes
