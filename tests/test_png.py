"""Stdlib PNG codec (io/png.py) and the loaders' decode through it.

The loaders decode PNG frames natively with libpng when that library
builds, and through io/png.py otherwise (PSGSDF_NO_NATIVE=1 forces the
fallback here).  The codec must be bit-exact against OpenCV's encoder for
every PNG filter type.
"""

import os

import numpy as np
import pytest

from psgradientsdf.io import png
from psgradientsdf.io.loaders import (
    _imread_color_raw, _imread_depth_raw, make_loader,
)

FILTERS = [0, 1, 2, 3, 4]   # None, Sub, Up, Average, Paeth (PNG spec 9.2)


@pytest.mark.parametrize("ftype", FILTERS)
def test_u16_gray_roundtrip(tmp_path, ftype):
    rng = np.random.default_rng(ftype)
    depth = rng.integers(0, 65536, size=(37, 53), dtype=np.uint16)
    p = str(tmp_path / "d.png")
    png.write(p, depth, filter_type=ftype)
    got = png.read(p)
    assert got.dtype == np.uint16 and got.shape == depth.shape
    np.testing.assert_array_equal(got, depth)


@pytest.mark.parametrize("ftype", FILTERS)
def test_rgb8_roundtrip(tmp_path, ftype):
    rng = np.random.default_rng(10 + ftype)
    rgb = rng.integers(0, 256, size=(29, 41, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    png.write(p, rgb, filter_type=ftype)
    got = png.read(p)
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("ftype", FILTERS)
def test_decodes_opencv_written(tmp_path, ftype):
    """PNGs written by OpenCV with each filter type decode exactly:
    16-bit gray, 8-bit RGB (BGR in OpenCV's arrays) and 8-bit RGBA."""
    cv2 = pytest.importorskip("cv2")
    flag = [cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB,
            cv2.IMWRITE_PNG_FILTER_UP, cv2.IMWRITE_PNG_FILTER_AVG,
            cv2.IMWRITE_PNG_FILTER_PAETH][ftype]
    params = [cv2.IMWRITE_PNG_FILTER, flag]
    rng = np.random.default_rng(20 + ftype)
    # smooth + noisy content so the filters see real predictions
    yy, xx = np.mgrid[0:31, 0:47]
    base = (30000 + 20000 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(
        np.int64)
    depth = (base + rng.integers(-50, 50, base.shape)).astype(np.uint16)
    bgr = rng.integers(0, 256, size=(31, 47, 3), dtype=np.uint8)
    bgra = rng.integers(0, 256, size=(31, 47, 4), dtype=np.uint8)
    for name, img, want in (("d.png", depth, depth),
                            ("c.png", bgr, bgr[..., ::-1]),
                            ("a.png", bgra, bgra[..., [2, 1, 0, 3]])):
        p = str(tmp_path / name)
        assert cv2.imwrite(p, img, params)
        np.testing.assert_array_equal(png.read(p), want, err_msg=name)


def test_written_files_read_by_opencv(tmp_path):
    """The encoder's files are ordinary PNGs to another decoder."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    depth = rng.integers(0, 65536, size=(12, 17), dtype=np.uint16)
    rgb = rng.integers(0, 256, size=(12, 17, 3), dtype=np.uint8)
    png.write(str(tmp_path / "d.png"), depth)
    png.write(str(tmp_path / "c.png"), rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED), depth)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "c.png"))[..., ::-1], rgb)


def test_rejects_what_it_cannot_decode(tmp_path):
    with pytest.raises(ValueError):
        png.decode(b"not a png at all")
    good = png.encode(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError):
        png.decode(good[:40])                       # truncated
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.float32))    # no float PNGs


def test_loaders_decode_through_codec(tmp_path, monkeypatch):
    """With the native library disabled, the loader helpers and a TUM
    loader decode through io/png.py: gray widens to u16 depth, RGBA drops
    alpha, gray promotes to RGB, corrupt and missing files give None."""
    monkeypatch.setenv("PSGSDF_NO_NATIVE", "1")
    rng = np.random.default_rng(6)
    root = str(tmp_path) + "/"
    os.makedirs(root + "rgb")
    os.makedirs(root + "depth")
    depth = rng.integers(1, 65536, size=(10, 14), dtype=np.uint16)
    rgba = rng.integers(0, 256, size=(10, 14, 4), dtype=np.uint8)
    png.write(root + "depth/0.png", depth)
    png.write(root + "rgb/0.png", rgba)
    with open(root + "associated.txt", "w") as fh:
        fh.write("1.0 rgb/0.png 1.0 depth/0.png\n")

    np.testing.assert_array_equal(_imread_depth_raw(root + "depth/0.png"),
                                  depth)
    np.testing.assert_array_equal(_imread_color_raw(root + "rgb/0.png"),
                                  rgba[..., :3])
    g8 = rng.integers(0, 256, size=(5, 6), dtype=np.uint8)
    png.write(root + "g8.png", g8)
    assert _imread_depth_raw(root + "g8.png").dtype == np.uint16
    np.testing.assert_array_equal(_imread_color_raw(root + "g8.png"),
                                  np.repeat(g8[..., None], 3, axis=-1))
    with open(root + "bad.png", "wb") as fh:
        fh.write(b"garbage")
    assert _imread_color_raw(root + "bad.png") is None
    assert _imread_depth_raw(root + "missing.png") is None

    loader = make_loader("tum", root)
    color, dep = loader.load_next()
    np.testing.assert_allclose(dep, depth / 5000.0, rtol=1e-6)
    np.testing.assert_allclose(color, rgba[..., :3] / 255.0, rtol=1e-6)


def test_save_normal_map_writes_png(tmp_path, monkeypatch):
    from psgradientsdf.utils import debug

    img = np.random.default_rng(7).integers(0, 256, (6, 8, 3), np.uint8)
    monkeypatch.setattr(debug, "normal_map_image", lambda *a, **k: img)
    fn = debug.save_normal_map(str(tmp_path) + "/")
    assert fn.endswith("normal_map.png")
    np.testing.assert_array_equal(png.read(fn), img)


def test_failed_libpng_build_falls_back_to_codec(tmp_path, monkeypatch):
    """When the native decoder does not compile (no libpng), get_io_lib
    gives None, leaves no partial library behind, and the loaders decode
    through io/png.py."""
    from psgradientsdf import native

    monkeypatch.delenv("PSGSDF_NO_NATIVE", raising=False)
    src = tmp_path / "loader.cpp"
    src.write_text("#error libpng is not installed\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_IO_SRC", str(src))
    monkeypatch.setattr(native, "_IO_LIB", None)
    monkeypatch.setattr(native, "_IO_TRIED", False)
    assert native.get_io_lib() is None
    assert os.listdir(tmp_path / "build") == []

    depth = np.arange(20, dtype=np.uint16).reshape(4, 5) * 1000
    png.write(str(tmp_path / "d.png"), depth)
    np.testing.assert_array_equal(_imread_depth_raw(str(tmp_path / "d.png")),
                                  depth)
