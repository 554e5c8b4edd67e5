"""Classical batched face localization via skin-tone segmentation.

A batched, weight-free stand-in for MediaPipe's FaceLandmarker bounding box
(the reference derives its ROI purely from the landmark cloud's min/max box,
``rppg_VIDEO.py:93-98`` — the 478 landmarks are only ever used as a bbox).
This detector produces that bbox directly from a skin-probability mask:

  u8 BGR -> YCbCr chroma box test -> box-filter smoothing -> threshold ->
  bbox from row/column occupancy -> validity from skin-pixel count.

Everything is a fixed-shape batched tensor op under ``jit`` — no per-frame
Python.  The learned Flax landmark model (``vhr_tpu.models.landmarker``) is
the high-fidelity alternative; both emit the same ``(boxes, valid)``
interface consumed by ``vhr_tpu.ops.roi.holdover``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["SkinDetectorConfig", "skin_mask", "pooled_skin_mask",
           "detect_faces"]


@dataclasses.dataclass(frozen=True)
class SkinDetectorConfig:
    # YCbCr chroma bounds for skin (classic Chai & Ngan style box).
    cb_min: float = 77.0
    cb_max: float = 127.0
    cr_min: float = 133.0
    cr_max: float = 173.0
    y_min: float = 40.0
    smooth: int = 5            # box-filter half-width (pixels)
    threshold: float = 0.5
    min_area_fraction: float = 0.005  # of the frame, else invalid
    # Detect on a k-x reduced frame; all float work at 1/k^2 resolution and
    # boxes scale back up.  "sample" strides the pixel grid (reads 1/k^2 of
    # the bytes, never materializes a full-res float tensor — required for
    # many-stream batches); "mean" average-pools (one full uint8 read).
    downsample: int = 1
    pool_mode: str = "sample"


def _bgr_to_ycbcr(frames: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    b = frames[..., 0].astype(jnp.float32)
    g = frames[..., 1].astype(jnp.float32)
    r = frames[..., 2].astype(jnp.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return y, cb, cr


def skin_mask(frames: jnp.ndarray, cfg: SkinDetectorConfig = SkinDetectorConfig()
              ) -> jnp.ndarray:
    """Smoothed skin probability in [0, 1], shape ``(T, H, W)``."""
    y, cb, cr = _bgr_to_ycbcr(frames)
    raw = ((cb >= cfg.cb_min) & (cb <= cfg.cb_max) &
           (cr >= cfg.cr_min) & (cr <= cfg.cr_max) &
           (y >= cfg.y_min)).astype(jnp.float32)
    if cfg.smooth > 0:
        k = 2 * cfg.smooth + 1
        # Separable box filter (two 1-D passes, k+k adds instead of k*k).
        win = jax.lax.reduce_window(
            raw, 0.0, jax.lax.add, (1, k, 1), (1, 1, 1), "SAME")
        win = jax.lax.reduce_window(
            win, 0.0, jax.lax.add, (1, 1, k), (1, 1, 1), "SAME")
        # Border normalization depends only on (H, W): a tiny host-side
        # constant (a jnp ones-reduce here would get constant-folded over the
        # whole video tensor at compile time).
        import numpy as _np
        H, W = frames.shape[1], frames.shape[2]
        ny = _np.minimum(_np.arange(H) + cfg.smooth + 1, H) - _np.maximum(
            _np.arange(H) - cfg.smooth, 0)
        nx = _np.minimum(_np.arange(W) + cfg.smooth + 1, W) - _np.maximum(
            _np.arange(W) - cfg.smooth, 0)
        norm = jnp.asarray((ny[:, None] * nx[None, :]).astype(_np.float32))
        raw = win / norm
    return raw


def pooled_skin_mask(frames: jnp.ndarray, cfg: SkinDetectorConfig
                     ) -> jnp.ndarray:
    """Thresholded skin mask on the (optionally ``downsample``-reduced)
    pixel grid, shape ``(T, H//k, W//k)`` bool."""
    T, H0, W0, _ = frames.shape
    k = cfg.downsample
    if k > 1:
        Hc, Wc = (H0 // k) * k, (W0 // k) * k
        if cfg.pool_mode == "sample":
            frames = frames[:, k // 2:Hc:k, k // 2:Wc:k]
        else:
            frames = frames[:, :Hc, :Wc].reshape(
                T, Hc // k, k, Wc // k, k, 3).astype(jnp.float32).mean((2, 4))
    return skin_mask(frames, cfg) >= cfg.threshold


@partial(jax.jit, static_argnames=("cfg",))
def detect_faces(frames: jnp.ndarray,
                 cfg: SkinDetectorConfig = SkinDetectorConfig()
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame face boxes from skin occupancy.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
    Returns:
      ``(boxes, valid)`` — ``(T, 4)`` int32 ``[x1, y1, x2, y2]`` (inclusive
      ends, like the landmark bbox) and ``(T,)`` bool.
    """
    T, H0, W0, _ = frames.shape
    k = cfg.downsample
    mask = pooled_skin_mask(frames, cfg)                    # (T, H, W)
    T, H, W = mask.shape

    col_any = jnp.any(mask, axis=1)                          # (T, W)
    row_any = jnp.any(mask, axis=2)                          # (T, H)

    col_idx = jax.lax.broadcasted_iota(jnp.int32, (T, W), 1)
    row_idx = jax.lax.broadcasted_iota(jnp.int32, (T, H), 1)

    x1 = jnp.min(jnp.where(col_any, col_idx, W), axis=1)
    x2 = jnp.max(jnp.where(col_any, col_idx, -1), axis=1)
    y1 = jnp.min(jnp.where(row_any, row_idx, H), axis=1)
    y2 = jnp.max(jnp.where(row_any, row_idx, -1), axis=1)

    area = jnp.sum(mask.reshape(T, -1), axis=1)
    valid = area >= cfg.min_area_fraction * (H * W)
    boxes = jnp.stack([x1, y1, x2, y2], axis=-1).astype(jnp.int32)
    if k > 1:
        # Scale pooled-grid coords back to pixels (outer pixel of each cell).
        boxes = jnp.stack([boxes[..., 0] * k, boxes[..., 1] * k,
                           boxes[..., 2] * k + (k - 1),
                           boxes[..., 3] * k + (k - 1)], axis=-1)
        boxes = jnp.minimum(boxes, jnp.asarray([W0 - 1, H0 - 1, W0 - 1,
                                                H0 - 1], jnp.int32))
    boxes = jnp.where(valid[:, None], boxes, 0)
    return boxes, valid
