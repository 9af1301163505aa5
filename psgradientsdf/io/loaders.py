"""RGB-D dataset loaders: TUM-RGBD, Synth/LED, Multiview (intrinsic3d).

Port-of-semantics of cpp/include/img_loader/* — same directory layouts, depth
unit scales (TUM: 1/5000, synth & multiview: 1/1000), intrinsics file format,
and TUM pose-file parsing (ImageLoader.h:228-258).  Images are returned as
numpy float32: color RGB in [0,1] (the reference keeps BGR and swaps at
sample time, Auxilary.h:59 — we swap once at load), depth in meters.
"""

from __future__ import annotations

import os
import zlib
from typing import List, Optional, Tuple

import numpy as np

from psgradientsdf import native
from psgradientsdf.io import png
from psgradientsdf.utils import se3 as se3_np  # noqa: F401  (jax quat used via numpy below)


def _imread_depth(path: str, unit: float) -> Optional[np.ndarray]:
    raw = _imread_depth_raw(path)
    if raw is None:
        return None
    return raw.astype(np.float32) * unit


def _imread_color(path: str) -> Optional[np.ndarray]:
    raw = _imread_color_raw(path)
    if raw is None:
        return None
    return raw.astype(np.float32) / 255.0


def _read_png(path: str) -> Optional[np.ndarray]:
    """Pure-Python decode (io/png.py); None for a missing or undecodable
    file, as the reference's cv::imread returns an empty Mat."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"only PNG frames are supported: {path}")
    try:
        return png.read(path)
    except (OSError, ValueError, zlib.error):
        return None


def _imread_depth_raw(path: str) -> Optional[np.ndarray]:
    """Depth in its stored integer encoding (u16 PNG) — for wire-efficient
    host->device transfer with on-device metric conversion.

    Decode prefers the native C++ libpng core (native/loader.cpp — the
    counterpart of the reference's C++ loading layer, ImageLoader.h:130-146)
    and falls back to the zlib codec in io/png.py when the library is
    absent.  8-bit gray widens value-preserving to uint16, as natively."""
    if path.lower().endswith(".png"):
        arr = native.png_read_depth_u16(path)
        if arr is not None:
            return arr
    img = _read_png(path)
    if img is None or img.ndim != 2:
        return None
    return img.astype(np.uint16)


def _imread_color_raw(path: str) -> Optional[np.ndarray]:
    """RGB uint8 (not normalized) — 4x smaller on the wire than float32.
    Native libpng decode first, io/png.py fallback (see _imread_depth_raw):
    gray promotes to 3 channels, alpha is dropped, 16-bit narrows to its
    high byte (libpng's and cv::imread's 8-bit reduction)."""
    if path.lower().endswith(".png"):
        arr = native.png_read_rgb8(path)
        if arr is not None:
            return arr
    img = _read_png(path)
    if img is None:
        return None
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] == 4:                 # drop alpha
        img = img[..., :3]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def quat_xyzw_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


class ImageLoader:
    """Base loader (ImageLoader.h:22-265)."""

    unit: float = 1.0

    def __init__(self, path: str):
        self.path = path
        self.timestamp_rgb = ""
        self.timestamp_depth = ""
        self.K = np.eye(3, dtype=np.float32)

    @property
    def rgb_timestamp(self) -> str:
        return self.timestamp_rgb

    @property
    def depth_timestamp(self) -> str:
        return self.timestamp_depth

    def load_intrinsics(self, filename: str = "intrinsics.txt") -> bool:
        fp = os.path.join(self.path, filename)
        if not os.path.isfile(fp):
            return False
        vals = []
        with open(fp) as fh:
            for line in fh:
                vals.extend(float(v) for v in line.split())
        if len(vals) < 9:
            return False
        self.K = np.array(vals[:9], dtype=np.float32).reshape(3, 3)
        return True

    def load_pose(self, filename: str) -> Optional[List[np.ndarray]]:
        """TUM format: `timestamp tx ty tz qx qy qz qw` per line
        (ImageLoader.h:228-258). Returns list of 4x4 camera-to-world poses."""
        fp = os.path.join(self.path, filename)
        if not os.path.isfile(fp):
            return None
        poses = []
        with open(fp) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 8 or parts[0].startswith("#"):
                    continue
                t = np.array([float(v) for v in parts[1:4]], dtype=np.float32)
                q = np.array([float(v) for v in parts[4:8]], dtype=np.float32)
                if float(np.sum(q * q)) < 0.99:
                    print(f"pose {parts[0]} has invalid rotation")
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = quat_xyzw_to_rot(q)
                T[:3, 3] = t
                poses.append(T)
        return poses if poses else None

    def load_next(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def load_albedo(self, filename: str) -> Optional[np.ndarray]:
        """[H,W,3] float32 albedo image in [0,1] from `filename` relative
        to the dataset path, grayscale promoted to 3 channels
        (ImageLoader.h:190-214 — dead API in the reference, uncalled by
        main_ps.cpp; provided for drop-in parity).  None on failure
        (the reference returns false)."""
        if not filename:
            return None
        img = _imread_color(os.path.join(self.path, filename))
        if img is None:
            return None
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img

    def frame_paths(
        self, idx: int
    ) -> Optional[Tuple[str, str, str, str]]:
        """(rgb_path, depth_path, ts_rgb, ts_depth) for 0-based frame idx,
        or None past the end.  Stateless — enables parallel decode-ahead
        (io/prefetch.py).  Loaders without an indexable layout return None."""
        return None

    def skip(self, n: int) -> None:
        """Advance past n frames without decoding them."""
        for _ in range(n):
            self.load_next()

    def reset(self) -> None:
        raise NotImplementedError

    def reset_counter(self) -> None:
        self.reset()


class TumrgbdLoader(ImageLoader):
    """Streams rgb-depth pairs from associated.txt (TumrgbdLoader.h:83-119)."""

    unit = 1.0 / 5000.0

    def __init__(self, path: str):
        super().__init__(path)
        self._lines: List[str] = []
        self._pos = 0
        assoc = os.path.join(path, "associated.txt")
        if os.path.isfile(assoc):
            with open(assoc) as fh:
                self._lines = [l for l in fh if l.strip() and not l.startswith("#")]

    def load_next(self):
        if self._pos >= len(self._lines):
            return None
        ts_rgb, rgb_file, ts_depth, depth_file = self._lines[self._pos].split()[:4]
        self._pos += 1
        self.timestamp_rgb = ts_rgb
        self.timestamp_depth = ts_depth
        depth = _imread_depth(os.path.join(self.path, depth_file), self.unit)
        color = _imread_color(os.path.join(self.path, rgb_file))
        if depth is None or color is None:
            return None
        return color, depth

    def frame_paths(self, idx: int):
        if idx >= len(self._lines):
            return None
        ts_rgb, rgb_file, ts_depth, depth_file = self._lines[idx].split()[:4]
        return (os.path.join(self.path, rgb_file),
                os.path.join(self.path, depth_file), ts_rgb, ts_depth)

    def skip(self, n: int):
        self._pos = min(self._pos + n, len(self._lines))

    def reset(self):
        self._pos = 0


class SynthLoader(ImageLoader):
    """depth/NNN.png + rgb/NNN.png, 3-digit counter from 1 (SynthLoader.h:35-57)."""

    unit = 1.0 / 1000.0

    def __init__(self, path: str):
        super().__init__(path)
        self.counter = 1

    def load_next(self):
        stamp = f"{self.counter:03d}"
        self.timestamp_rgb = self.timestamp_depth = stamp
        depth = _imread_depth(os.path.join(self.path, "depth", stamp + ".png"), self.unit)
        color = _imread_color(os.path.join(self.path, "rgb", stamp + ".png"))
        if depth is None or color is None:
            return None
        self.counter += 1
        return color, depth

    def frame_paths(self, idx: int):
        stamp = f"{idx + 1:03d}"
        rp = os.path.join(self.path, "rgb", stamp + ".png")
        dp = os.path.join(self.path, "depth", stamp + ".png")
        if not (os.path.isfile(rp) and os.path.isfile(dp)):
            return None
        return rp, dp, stamp, stamp

    def skip(self, n: int):
        self.counter += n

    def load_keyframe(self, frame: int):
        """Load by index (SynthLoader.h:77-97; note it reads the *albedo*
        directory in the reference — we read rgb, albedo via load_reflectance)."""
        stamp = f"{frame + 1:03d}"
        depth = _imread_depth(os.path.join(self.path, "depth", stamp + ".png"), self.unit)
        color = _imread_color(os.path.join(self.path, "rgb", stamp + ".png"))
        if depth is None or color is None:
            return None
        return color, depth

    def load_reflectance(self):
        """GT albedo + depth for evaluation (SynthLoader.h:59-75)."""
        stamp = f"{self.counter:03d}"
        albedo = _imread_color(os.path.join(self.path, "albedo", stamp + ".png"))
        depth = _imread_depth(os.path.join(self.path, "depth", stamp + ".png"), self.unit)
        if albedo is None or depth is None:
            return None
        self.counter += 1
        return albedo, depth

    def reset(self):
        self.counter = 1


class MultiviewLoader(ImageLoader):
    """colorNNNNNN.png / depthNNNNNN.png, 6-digit counter from 1
    (MultiviewLoader.h:35-58)."""

    unit = 1.0 / 1000.0

    def __init__(self, path: str):
        super().__init__(path)
        self.counter = 1

    def load_next(self):
        stamp = f"{self.counter:06d}"
        self.timestamp_rgb = self.timestamp_depth = stamp
        depth = _imread_depth(os.path.join(self.path, "depth" + stamp + ".png"), self.unit)
        color = _imread_color(os.path.join(self.path, "color" + stamp + ".png"))
        if depth is None or color is None:
            return None
        self.counter += 1
        return color, depth

    def frame_paths(self, idx: int):
        stamp = f"{idx + 1:06d}"
        rp = os.path.join(self.path, "color" + stamp + ".png")
        dp = os.path.join(self.path, "depth" + stamp + ".png")
        if not (os.path.isfile(rp) and os.path.isfile(dp)):
            return None
        return rp, dp, stamp, stamp

    def skip(self, n: int):
        self.counter += n

    def load_keyframe(self, frame: int):
        """Load by 0-based index (MultiviewLoader.h:60-91 — dead API in
        the reference, uncalled by main_ps.cpp; drop-in parity).  Sets the
        scalar rgb/depth timestamps; the reference ALSO appends to its
        timestamps_rgb_/timestamps_depth_ history vectors on every call —
        this port keeps no such history (nothing reads it), so that side
        effect is intentionally omitted."""
        stamp = f"{frame + 1:06d}"
        self.timestamp_rgb = self.timestamp_depth = stamp
        depth = _imread_depth(
            os.path.join(self.path, "depth" + stamp + ".png"), self.unit)
        color = _imread_color(
            os.path.join(self.path, "color" + stamp + ".png"))
        if depth is None or color is None:
            return None
        return color, depth

    def reset(self):
        self.counter = 1


def make_loader(datatype: str, path: str) -> ImageLoader:
    """Datatype -> loader dispatch (ConfigLoader.h:42-57)."""
    if datatype == "tum":
        return TumrgbdLoader(path)
    if datatype in ("synth", "led"):
        return SynthLoader(path)
    if datatype in ("multiview", "intrinsic3d"):
        return MultiviewLoader(path)
    raise ValueError(f"dataset type {datatype!r} is not supported")
