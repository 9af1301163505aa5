"""Minimal PNG codec on the standard library's zlib.

The loaders decode PNG frames through the native libpng core
(native/loader.cpp) when it builds; this module is the fallback that needs
nothing beyond numpy, and the writer for synthetic datasets and debug
images.  Scope (what RGB-D datasets use):

  decode: non-interlaced, bit depth 8 or 16, gray / RGB / RGBA; all five
          filter types (PNG spec 9.2).
  encode: 8-bit gray / RGB / RGBA and 16-bit gray, one filter type for
          every row (default Up).

Arrays are [H,W] for one channel, else [H,W,C], RGB(A) order, uint8 or
uint16 (16-bit samples are big-endian on disk).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (gray, RGB, RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_FILTER_NONE, _FILTER_SUB, _FILTER_UP, _FILTER_AVG, _FILTER_PAETH = range(5)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def _unfilter_sequential(ftype: int, row: bytearray, prior: bytes,
                         bpp: int) -> None:
    """Average and Paeth rows (in place): each byte depends on the
    reconstructed byte bpp to its left, so they run byte by byte."""
    n = len(row)
    if ftype == _FILTER_AVG:
        for i in range(bpp):
            row[i] = (row[i] + (prior[i] >> 1)) & 0xFF
        for i in range(bpp, n):
            row[i] = (row[i] + ((row[i - bpp] + prior[i]) >> 1)) & 0xFF
        return
    for i in range(bpp):                       # Paeth, left = upleft = 0
        row[i] = (row[i] + prior[i]) & 0xFF
    for i in range(bpp, n):
        a, b, c = row[i - bpp], prior[i], prior[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """[H, 1+stride] filtered scanlines -> [H, stride] uint8 samples."""
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(raw[y, 0])
        cur = raw[y, 1:]
        if ftype == _FILTER_NONE:
            rec = cur
        elif ftype == _FILTER_SUB:
            # running sum along each byte lane, modulo 256
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == _FILTER_UP:
            rec = cur + prior
        elif ftype in (_FILTER_AVG, _FILTER_PAETH):
            row = bytearray(cur.tobytes())
            _unfilter_sequential(ftype, row, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = rec
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> numpy array (see module docstring for the layout)."""
    header = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(
            f"unsupported PNG format: color type {ctype}, bit depth {depth}")
    chans = _CHANNELS[ctype]
    bpp = chans * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(height, width, chans)
    return img[..., 0] if chans == 1 else img


def read(path: str) -> np.ndarray:
    """Decode the PNG file at `path`."""
    with open(path, "rb") as fh:
        return decode(fh.read())


def _filter_rows(samples: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """[H, stride] uint8 -> [H, stride] filtered bytes (all rows at once:
    encoding reads only unfiltered neighbours)."""
    x = samples.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if ftype == _FILTER_NONE:
        pred = np.zeros_like(x)
    elif ftype == _FILTER_SUB:
        pred = left
    elif ftype == _FILTER_UP:
        pred = up
    elif ftype == _FILTER_AVG:
        pred = (left + up) >> 1
    elif ftype == _FILTER_PAETH:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"bad PNG filter type {ftype}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode(img: np.ndarray, filter_type: int = _FILTER_UP) -> bytes:
    """numpy array -> PNG bytes.  uint8 [H,W] / [H,W,3] / [H,W,4] or
    uint16 [H,W]."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
        samples = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (3, 4))):
        ctype = 0 if img.ndim == 2 else (2 if img.shape[2] == 3 else 6)
        depth = 8
        samples = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(
            f"cannot encode {img.dtype} array of shape {img.shape} as PNG")
    height, width = img.shape[:2]
    bpp = _CHANNELS[ctype] * depth // 8
    filt = _filter_rows(samples, bpp, filter_type)
    raw = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8), filt], axis=1)

    def chunk(ctype_b: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype_b + body
                + struct.pack(">I", zlib.crc32(ctype_b + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, filter_type: int = _FILTER_UP) -> None:
    """Encode `img` (see encode) and write it to `path`."""
    with open(path, "wb") as fh:
        fh.write(encode(img, filter_type=filter_type))
