"""Native libpng decoder (native/loader.cpp) vs cv2: exact equality.

The native library is this build's counterpart of the reference's C++
image loading layer (cpp/include/img_loader/ImageLoader.h:130-188); the
loaders fall back to io/png.py when it is absent, so these tests skip
rather than fail without libpng.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from psgradientsdf import native
from psgradientsdf.io.loaders import _imread_color_raw, _imread_depth_raw

SOKRATES = "/root/reference/data/sokrates-mvs"

pytestmark = pytest.mark.skipif(
    native.get_io_lib() is None, reason="native IO library unavailable"
)


def _cv2_rgb(path):
    img = cv2.imread(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    return np.ascontiguousarray(img[..., ::-1])


def test_probe_and_u16_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 65536, size=(37, 53), dtype=np.uint16)
    p = str(tmp_path / "d.png")
    assert cv2.imwrite(p, depth)

    assert native.png_probe(p) == (53, 37, 16, 1)
    arr = native.png_read_depth_u16(p)
    assert arr.dtype == np.uint16 and arr.shape == (37, 53)
    np.testing.assert_array_equal(arr, depth)
    # cv2 agreement
    ref = cv2.imread(p, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    np.testing.assert_array_equal(arr, ref)


def test_u8_gray_depth_widens_value_preserving(tmp_path):
    rng = np.random.default_rng(1)
    d8 = rng.integers(0, 256, size=(21, 34), dtype=np.uint8)
    p = str(tmp_path / "d8.png")
    assert cv2.imwrite(p, d8)
    arr = native.png_read_depth_u16(p)
    np.testing.assert_array_equal(arr, d8.astype(np.uint16))


def test_rgb8_matches_cv2(tmp_path):
    rng = np.random.default_rng(2)
    bgr = rng.integers(0, 256, size=(29, 41, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    assert cv2.imwrite(p, bgr)
    arr = native.png_read_rgb8(p)
    np.testing.assert_array_equal(arr, _cv2_rgb(p))


def test_rgba_alpha_stripped(tmp_path):
    rng = np.random.default_rng(3)
    bgra = rng.integers(0, 256, size=(15, 19, 4), dtype=np.uint8)
    p = str(tmp_path / "ca.png")
    assert cv2.imwrite(p, bgra)
    arr = native.png_read_rgb8(p)
    np.testing.assert_array_equal(arr, bgra[..., [2, 1, 0]])


def test_gray_color_promoted(tmp_path):
    rng = np.random.default_rng(4)
    g = rng.integers(0, 256, size=(17, 23), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    assert cv2.imwrite(p, g)
    arr = native.png_read_rgb8(p)
    np.testing.assert_array_equal(arr, np.repeat(g[..., None], 3, axis=-1))


def test_depth_rejects_color_png(tmp_path):
    bgr = np.zeros((8, 8, 3), dtype=np.uint8)
    p = str(tmp_path / "c2.png")
    assert cv2.imwrite(p, bgr)
    assert native.png_read_depth_u16(p) is None


def test_missing_and_corrupt_files(tmp_path):
    assert native.png_probe(str(tmp_path / "nope.png")) is None
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    assert native.png_read_rgb8(str(bad)) is None
    trunc = tmp_path / "trunc.png"
    ok = tmp_path / "ok.png"
    assert cv2.imwrite(str(ok), np.zeros((32, 32), np.uint16))
    trunc.write_bytes(ok.read_bytes()[:64])
    assert native.png_read_depth_u16(str(trunc)) is None


@pytest.mark.skipif(not os.path.isdir(SOKRATES), reason="demo data absent")
def test_sokrates_demo_frames_bit_exact():
    """Every shipped demo frame decodes identically to cv2 through the
    public loader helpers (which route PNGs to the native core)."""
    names = sorted(os.listdir(SOKRATES))
    d_names = [n for n in names if n.startswith("depth")][:5]
    c_names = [n for n in names if n.startswith("color")][:5]
    assert d_names and c_names
    for n in d_names:
        p = os.path.join(SOKRATES, n)
        ref = cv2.imread(p, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
        got = _imread_depth_raw(p)
        np.testing.assert_array_equal(got, ref)
    for n in c_names:
        p = os.path.join(SOKRATES, n)
        np.testing.assert_array_equal(_imread_color_raw(p), _cv2_rgb(p))


def test_load_albedo(tmp_path):
    """ImageLoader.load_albedo (ImageLoader.h:190-214): color file relative
    to the dataset path -> [H,W,3] float32 in [0,1]; empty filename / a
    missing file -> None (the reference returns false)."""
    from psgradientsdf.io.loaders import SynthLoader

    rng = np.random.default_rng(5)
    img = (rng.random((12, 16, 3)) * 255).astype(np.uint8)
    cv2.imwrite(os.path.join(str(tmp_path), "albedo.png"), img[..., ::-1])
    loader = SynthLoader(str(tmp_path) + "/")
    alb = loader.load_albedo("albedo.png")
    assert alb is not None and alb.shape == (12, 16, 3)
    assert alb.dtype == np.float32
    np.testing.assert_allclose(alb, img.astype(np.float32) / 255.0,
                               rtol=0, atol=1e-6)
    assert loader.load_albedo("") is None
    assert loader.load_albedo("nope.png") is None


def test_multiview_load_keyframe(tmp_path):
    """MultiviewLoader.load_keyframe (MultiviewLoader.h:60-91): 6-digit
    frame+1 naming, stateless (counter untouched)."""
    from psgradientsdf.io.loaders import MultiviewLoader

    rng = np.random.default_rng(7)
    img = (rng.random((10, 12, 3)) * 255).astype(np.uint8)
    dep = (rng.random((10, 12)) * 3000).astype(np.uint16)
    root = str(tmp_path) + "/"
    cv2.imwrite(root + "color000003.png", img[..., ::-1])
    cv2.imwrite(root + "depth000003.png", dep)
    loader = MultiviewLoader(root)
    out = loader.load_keyframe(2)
    assert out is not None
    color, depth = out
    np.testing.assert_allclose(color, img.astype(np.float32) / 255.0,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(depth, dep.astype(np.float32) / 1000.0,
                               rtol=0, atol=1e-6)
    assert loader.counter == 1          # stateless like the reference
    assert loader.timestamp_rgb == "000003"
    assert loader.load_keyframe(50) is None
