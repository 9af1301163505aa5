"""Prefetching frame loader: overlap PNG decode with device compute.

The reference loads every frame synchronously inside the scan loop
(main_ps.cpp:167); at 2-megapixel 16-bit PNGs the decode alone costs
0.2-0.4 s/frame — far more than the whole fused device frame step.  Two modes:

  * indexed (preferred): when the base loader exposes `frame_paths(idx)`
    (all three shipped loaders do), a thread pool decodes several frames
    ahead IN PARALLEL with order-preserving delivery — the native decoder and
    the numpy conversions release the GIL, so N workers give ~N× decode
    throughput;
  * streaming fallback: a single worker thread calling `load_next()` for
    loaders without an indexable layout.

Timestamps are captured at decode/schedule time and replayed in order, so
the rgb_timestamp/depth_timestamp contract of the base loader holds.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from psgradientsdf.io.loaders import (
    ImageLoader,
    _imread_color,
    _imread_color_raw,
    _imread_depth,
    _imread_depth_raw,
)


class PrefetchLoader:
    """Wraps an ImageLoader; load_next() returns pre-decoded frames.

    `raw=True` (indexed mode only) skips the float conversions: color is
    RGB uint8, depth its stored integer encoding — 3.7x less host->device
    transfer; the fused kernels convert on device (`depth_unit`)."""

    def __init__(self, loader: ImageLoader, depth: int = 8, workers: int = 4,
                 raw: bool = False):
        self._loader = loader
        self._depth = depth
        self.timestamp_rgb = ""
        self.timestamp_depth = ""
        fp = getattr(loader, "frame_paths", None)   # duck-typed custom loaders
        self._indexed = fp is not None and fp(0) is not None
        self._raw = raw and self._indexed
        if self._indexed:
            self._pool = ThreadPoolExecutor(max_workers=workers)
            self._futures: "deque[Future]" = deque()
            self._next_sub = 0    # next frame index to submit
            self._ended = False
            self._fill()
        else:
            self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
            self._thread: Optional[threading.Thread] = None
            self._start_stream()

    # ------------------------------------------------------------ pass-throughs
    @property
    def K(self):
        return self._loader.K

    @property
    def rgb_timestamp(self) -> str:
        return self.timestamp_rgb

    @property
    def depth_timestamp(self) -> str:
        return self.timestamp_depth

    def load_intrinsics(self, filename: str = "intrinsics.txt") -> bool:
        return self._loader.load_intrinsics(filename)

    def load_pose(self, filename: str):
        return self._loader.load_pose(filename)

    # ------------------------------------------------------------ indexed mode

    @property
    def unit(self) -> float:
        return self._loader.unit

    @property
    def raw(self) -> bool:
        return self._raw

    def _decode(self, idx: int):
        paths = self._loader.frame_paths(idx)
        if paths is None:
            return None
        rgb_path, depth_path, ts_rgb, ts_depth = paths
        if self._raw:
            depth = _imread_depth_raw(depth_path)
            color = _imread_color_raw(rgb_path)
        else:
            depth = _imread_depth(depth_path, self._loader.unit)
            color = _imread_color(rgb_path)
        if depth is None or color is None:
            return None
        return color, depth, ts_rgb, ts_depth

    def _fill(self) -> None:
        while not self._ended and len(self._futures) < self._depth:
            # cheap EOF probe on the scheduling thread keeps the pool from
            # queueing past the end of the dataset
            if self._loader.frame_paths(self._next_sub) is None:
                self._ended = True
                break
            self._futures.append(self._pool.submit(self._decode, self._next_sub))
            self._next_sub += 1

    def _drain_indexed(self) -> None:
        for f in self._futures:
            f.cancel()
        for f in self._futures:
            if not f.cancelled():
                try:
                    f.result()
                except Exception:
                    pass
        self._futures.clear()

    # ------------------------------------------------------------ stream mode

    def _start_stream(self) -> None:
        self._stop = threading.Event()
        q, stop, loader = self._queue, self._stop, self._loader

        def worker():
            while not stop.is_set():
                item = loader.load_next()
                payload = None if item is None else (
                    item[0], item[1], loader.rgb_timestamp, loader.depth_timestamp
                )
                while not stop.is_set():
                    try:
                        q.put(payload, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if payload is None:
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public API

    def load_next(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self._indexed:
            if not self._futures:
                return None
            item = self._futures.popleft().result()
            self._fill()
        else:
            item = self._queue.get()
        if item is None:
            if self._indexed:
                self._ended = True
                self._drain_indexed()
            return None
        color, depth, ts_rgb, ts_depth = item
        self.timestamp_rgb = ts_rgb
        self.timestamp_depth = ts_depth
        return color, depth

    def skip(self, n: int) -> None:
        """Advance past n frames without decoding them (indexed mode) or by
        draining decoded frames (stream mode)."""
        if n <= 0:
            return
        if self._indexed:
            consumed = self._next_sub - len(self._futures)
            self._drain_indexed()
            self._ended = False
            self._next_sub = consumed + n
            self._fill()
        else:
            for _ in range(n):
                if self.load_next() is None:
                    return

    def reset(self) -> None:
        if self._indexed:
            self._drain_indexed()
            self._loader.reset()
            self._ended = False
            self._next_sub = 0
            self._fill()
            return
        # stream mode: stop the worker (it aborts any blocked put), drain, restart
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive():
                try:
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            self._thread.join()
        self._loader.reset()
        self._queue = queue.Queue(maxsize=self._queue.maxsize)
        self._start_stream()

    def reset_counter(self) -> None:
        self.reset()
