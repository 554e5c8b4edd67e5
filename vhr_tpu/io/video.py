"""Host-side video decode/encode and ground-truth handling.

A rethink of ``analysis/utils/video_io.py``: video decode runs on the host,
so this layer's job is to deliver contiguous ``(T, H, W, 3)`` uint8 arrays
(optionally row-padded to a 128-pixel multiple) and stream them chunk-wise so hour-long recordings never require
whole-video RAM (the reference reads everything eagerly,
``video_io.py:26-31``).  The multithreaded C++ decode/staging service lives
in ``vhr_tpu/io/native``; this module is the pure-Python(cv2) implementation
and fallback.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

try:
    import cv2
    HAVE_CV2 = True
except Exception:  # pragma: no cover - environment without OpenCV
    cv2 = None
    HAVE_CV2 = False

__all__ = [
    "HAVE_CV2",
    "read_video",
    "iter_video_chunks",
    "write_video",
    "video_metadata",
    "read_truth_csv",
    "align_truth_to_measurement",
]


def _require_cv2():
    if not HAVE_CV2:
        raise RuntimeError("OpenCV (cv2) is required for video I/O but is "
                           "not available in this environment")


def video_metadata(path: str) -> Tuple[int, int, float, int, float]:
    """(width, height, fps, frame_count, bitrate_bps) of a video file."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"failed to open video: {path}")
    meta = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            float(cap.get(cv2.CAP_PROP_FPS)),
            int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            float(cap.get(cv2.CAP_PROP_BITRATE)) * 1000.0)
    cap.release()
    return meta


def read_video(path: str, max_frames: Optional[int] = None
               ) -> Tuple[np.ndarray, float]:
    """Decode a whole video into one contiguous ``(T, H, W, 3)`` uint8 array.

    The array-of-frames contract of ``video_io.read_video`` but contiguous
    (one host buffer -> one device transfer) instead of a Python list.
    """
    _require_cv2()
    if not os.path.exists(path):
        raise FileNotFoundError(f"video not found: {path}")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"failed to open video: {path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    frames: List[np.ndarray] = []
    while max_frames is None or len(frames) < max_frames:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        return np.zeros((0, 0, 0, 3), np.uint8), fps
    return np.ascontiguousarray(np.stack(frames)), fps


def iter_video_chunks(path: str, chunk_frames: int
                      ) -> Iterator[Tuple[np.ndarray, float, int]]:
    """Stream ``(frames, fps, start_index)`` chunks without whole-video RAM."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"failed to open video: {path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    start = 0
    buf: List[np.ndarray] = []
    while True:
        ret, frame = cap.read()
        if ret:
            buf.append(frame)
        if buf and (len(buf) == chunk_frames or not ret):
            yield np.ascontiguousarray(np.stack(buf)), fps, start
            start += len(buf)
            buf = []
        if not ret:
            break
    cap.release()


def write_video(frames: np.ndarray, path: str, fps: float) -> None:
    """Write ``(T, H, W, 3)`` uint8 BGR frames as MP4 (mp4v fourcc, matching
    ``video_io.write_video``)."""
    _require_cv2()
    frames = np.asarray(frames)
    if frames.size == 0:
        raise ValueError("no frames to write")
    h, w = frames.shape[1:3]
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            out.write(np.ascontiguousarray(f))
    finally:
        out.release()


def read_truth_csv(path: str) -> np.ndarray:
    """Load a ground-truth CSV with columns (timestamp, heart_rate).

    Cleaning contract of ``video_io.read_truth_for_video``: keep the two
    columns, drop NaNs, de-duplicate timestamps (first wins), sort by time.
    Returns ``(N, 2)`` float64.
    """
    import pandas as pd
    df = pd.read_csv(path)
    if not {"timestamp", "heart_rate"}.issubset(df.columns):
        raise ValueError(
            "ground truth must have columns ['timestamp', 'heart_rate']")
    df = (df[["timestamp", "heart_rate"]]
          .dropna(subset=["timestamp", "heart_rate"])
          .drop_duplicates(subset=["timestamp"])
          .sort_values("timestamp"))
    if df.empty:
        raise ValueError("ground truth has no valid rows")
    return df.to_numpy(dtype=np.float64)


def align_truth_to_measurement(truth: np.ndarray, measured: np.ndarray
                               ) -> np.ndarray:
    """Zero-order-hold alignment of truth HR to measurement timestamps.

    Semantics of ``video_io.interpolate_hr_to_frames``: for each measured
    timestamp, take the last truth sample at or before it (clamped to the
    first sample).  Returns ``(N, 2)`` ``[t, hr]``.
    """
    truth = np.asarray(truth, dtype=float)
    measured = np.asarray(measured)
    if measured.ndim != 2 or measured.shape[1] < 1:
        raise ValueError("measured must be 2D with timestamps in column 0")
    t_meas = measured[:, 0].astype(float)
    idx = np.searchsorted(truth[:, 0], t_meas, side="right") - 1
    idx = np.clip(idx, 0, len(truth) - 1)
    return np.column_stack([t_meas, truth[idx, 1]])
