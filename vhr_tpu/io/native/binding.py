"""ctypes bindings + on-demand build for the C++ framestore.

The shared library builds once per environment with g++ against the system
OpenCV (no pybind11 in this image — plain C ABI + ctypes).  All consumers
must go through :func:`is_available` and fall back to the pure-cv2 reader
(``vhr_tpu.io.video``) when the toolchain or OpenCV dev libraries are absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "framestore.cpp"
_LIB = _DIR / "libvhrframestore.so"

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def build(force: bool = False) -> bool:
    """Compile the shared library if needed (source newer than the .so
    triggers a rebuild — the C ABI may have changed); returns success."""
    global _build_error
    if (_LIB.exists() and not force
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime):
        return True
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(_LIB),
           "-I/usr/include/opencv4",
           "-lopencv_core", "-lopencv_imgproc", "-lopencv_videoio",
           "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        _build_error = getattr(e, "stderr", str(e))
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not build():
            raise RuntimeError(f"framestore build failed: {_build_error}")
        lib = ctypes.CDLL(str(_LIB))
        lib.vhr_open.restype = ctypes.c_int64
        lib.vhr_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
        lib.vhr_meta.restype = ctypes.c_int
        lib.vhr_meta.argtypes = [ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_double)]
        lib.vhr_next_chunk.restype = ctypes.c_int
        lib.vhr_next_chunk.argtypes = [ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int64]
        lib.vhr_stats.restype = ctypes.c_int
        lib.vhr_stats.argtypes = [ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_double)]
        lib.vhr_close.argtypes = [ctypes.c_int64]
        lib.vhr_writer_open.restype = ctypes.c_int64
        lib.vhr_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_double,
                                        ctypes.c_char_p]
        lib.vhr_writer_put.restype = ctypes.c_int
        lib.vhr_writer_put.argtypes = [ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int]
        lib.vhr_writer_close.argtypes = [ctypes.c_int64]
        _lib = lib
        return _lib


def is_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeVideoReader:
    """Background-threaded chunked decode into padded contiguous buffers.

    Chunks arrive as ``(n, H, W_pad, 3)`` uint8 with ``W_pad*3`` a multiple
    of ``pad_row_to``; decode of chunk k+1 overlaps
    the caller's device work on chunk k.
    """

    def __init__(self, path: str, chunk_frames: int = 256,
                 pad_row_to: int = 128, n_decoders: int = 1,
                 fmt: str = "bgr"):
        """``n_decoders > 1`` decodes disjoint chunk-aligned segments in
        parallel (one private VideoCapture per worker, seeked to its
        segment), re-serialized in order through a sliding-window buffer —
        SURVEY §7 risk (b): parallel decoder instances so 500 fps of 1080p
        decode does not starve the device.  Falls back to one worker when the
        container reports no frame count (live streams).

        ``fmt="i420"`` stages planar YUV 4:2:0 instead of interleaved BGR —
        1.5 B/px, so host->device transfer halves; chunks arrive as
        ``(n, frame_stride)`` uint8 and ``ops.color.i420_to_bgr_flat``
        reconstructs BGR on device bit-exactly vs OpenCV."""
        if fmt not in ("bgr", "i420"):
            raise ValueError(f"fmt must be 'bgr' or 'i420', got {fmt!r}")
        self.fmt = fmt
        self._lib = _load()
        self._h = self._lib.vhr_open(str(path).encode(), chunk_frames,
                                     pad_row_to, n_decoders,
                                     1 if fmt == "i420" else 0)
        if self._h == 0:
            raise IOError(f"native open failed: {path}")
        meta = (ctypes.c_double * 5)()
        self._lib.vhr_meta(self._h, meta)
        self.width = int(meta[0])
        self.height = int(meta[1])
        self.fps = float(meta[2])
        self.frame_count = int(meta[3])
        if fmt == "i420":
            self.frame_stride = int(meta[4])  # staged bytes per frame
            self.padded_width = self.width
        else:
            self.padded_width = int(meta[4])
        self.chunk_frames = chunk_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        """Yields ``(n, H, W_pad, 3)`` BGR chunks, or ``(n, frame_stride)``
        planar-I420 byte chunks when ``fmt="i420"``."""
        if self.fmt == "i420":
            buf = np.empty((self.chunk_frames, self.frame_stride), np.uint8)
        else:
            row = self.padded_width * 3
            buf = np.empty((self.chunk_frames, self.height, row), np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            n = self._lib.vhr_next_chunk(self._h, ptr, buf.nbytes)
            if n < 0:
                raise IOError(f"native read error {n}")
            if n == 0:
                return
            if self.fmt == "i420":
                yield buf[:n].copy()
            else:
                yield (buf[:n].reshape(n, self.height, self.padded_width, 3)
                       .copy())

    def stats(self) -> dict:
        """Staging-ring occupancy counters: who stalled on whom.

        ``consumer_blocked`` counts next-chunk calls that had to wait for the
        decode thread (decode-bound); ``producer_blocked`` counts decoder
        stalls on a full ring (compute-bound — the healthy state)."""
        out = (ctypes.c_double * 4)()
        if not self._h or not self._lib.vhr_stats(self._h, out):
            return {}
        return {"produced": int(out[0]), "consumed": int(out[1]),
                "producer_blocked": int(out[2]),
                "consumer_blocked": int(out[3])}

    def close(self):
        if self._h:
            self._lib.vhr_close(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeVideoWriter:
    def __init__(self, path: str, width: int, height: int, fps: float,
                 fourcc: str = "mp4v"):
        self._lib = _load()
        self.width, self.height = width, height
        self._h = self._lib.vhr_writer_open(str(path).encode(), width, height,
                                            fps, fourcc.encode())
        if self._h == 0:
            raise IOError(f"native writer open failed: {path}")

    def write(self, frames: np.ndarray):
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3:
            frames = frames[None]
        assert frames.shape[1:] == (self.height, self.width, 3)
        ptr = frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n = self._lib.vhr_writer_put(self._h, ptr, frames.shape[0])
        if n != frames.shape[0]:
            raise IOError("native write failed")

    def close(self):
        if self._h:
            self._lib.vhr_writer_close(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
