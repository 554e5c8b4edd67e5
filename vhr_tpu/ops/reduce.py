"""Batched ROI channel means and frame statistics (pure XLA path).

Replaces the reference's per-frame ``np.mean(roi[:, :, c])`` spatial pooling
(``rppg_VIDEO.py:60-66,110``, ``analysis/measurement/green_avg.py:34``,
``ica.py:48``) with one masked reduction over the whole ``(T, H, W, 3)``
tensor, and ``bpp.py``'s per-frame entropy/noise/NSR statistics
(``bpp.py:34-176``) with batched JAX reductions.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "roi_channel_means",
    "roi_channel_means_multi",
    "grayscale_u8",
    "frame_entropy",
    "frame_noise_variance",
    "frame_nsr",
    "FrameStats",
    "video_stats",
]

# Pixel sums reach ~5e5 per partial row sum; a TF32 contraction (about 11
# significant bits) would round them, so every contraction here is exact f32.
_HIGHEST = jax.lax.Precision.HIGHEST


def roi_channel_means(frames: jnp.ndarray, rois: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean of each color channel over a per-frame ROI rectangle.

    Args:
      frames: ``(T, H, W, C)`` uint8 (or float).
      rois: ``(T, 4)`` int32 ``[x1, y1, x2, y2]`` (x2/y2 exclusive).

    Returns:
      ``(means, count)`` — ``(T, C)`` float32 channel means (0 where the ROI
      is empty) and ``(T,)`` float32 pixel counts.
    """
    T, H, W, C = frames.shape
    x1, y1 = rois[:, 0], rois[:, 1]
    x2, y2 = rois[:, 2], rois[:, 3]

    rows = jax.lax.broadcasted_iota(jnp.int32, (T, H), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (T, W), 1)
    row_m = (rows >= y1[:, None]) & (rows < y2[:, None])    # (T, H)
    col_m = (cols >= x1[:, None]) & (cols < x2[:, None])    # (T, W)

    fr = frames.astype(jnp.float32)
    # Reduce W first under the column mask, then H under the row mask; XLA
    # fuses the mask broadcast into the reductions (one pass over memory).
    partial = jnp.einsum("thwc,tw->thc", fr, col_m.astype(jnp.float32),
                         precision=_HIGHEST)
    sums = jnp.einsum("thc,th->tc", partial, row_m.astype(jnp.float32),
                      precision=_HIGHEST)

    count = (jnp.maximum(y2 - y1, 0) * jnp.maximum(x2 - x1, 0)).astype(jnp.float32)
    means = sums / jnp.maximum(count, 1.0)[:, None]
    return means, count


def roi_channel_means_multi(frames: jnp.ndarray, rois: jnp.ndarray
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """K ROIs per frame with ONE pass over the frame tensor.

    A vmap of :func:`roi_channel_means` over the face axis re-reads the
    whole ``(T, H, W, C)`` tensor K times; here the K column masks join the
    first einsum so memory traffic stays one frame read regardless of K (the
    multi-subject monitoring hot path, offline and live).

    Args:
      frames: ``(T, H, W, C)`` uint8 (or float).
      rois: ``(T, K, 4)`` int32 ``[x1, y1, x2, y2]`` (exclusive ends).
    Returns:
      ``(means (T, K, C) float32, count (T, K) float32)``.
    """
    T, H, W, C = frames.shape
    x1, y1 = rois[..., 0], rois[..., 1]                     # (T, K)
    x2, y2 = rois[..., 2], rois[..., 3]

    rows = jax.lax.broadcasted_iota(jnp.int32, (T, H), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (T, W), 1)
    row_m = ((rows[:, None, :] >= y1[..., None])
             & (rows[:, None, :] < y2[..., None]))          # (T, K, H)
    col_m = ((cols[:, None, :] >= x1[..., None])
             & (cols[:, None, :] < x2[..., None]))          # (T, K, W)

    fr = frames.astype(jnp.float32)
    partial = jnp.einsum("thwc,tkw->tkhc", fr, col_m.astype(jnp.float32),
                         precision=_HIGHEST)
    sums = jnp.einsum("tkhc,tkh->tkc", partial, row_m.astype(jnp.float32),
                      precision=_HIGHEST)

    count = (jnp.maximum(y2 - y1, 0)
             * jnp.maximum(x2 - x1, 0)).astype(jnp.float32)  # (T, K)
    means = sums / jnp.maximum(count, 1.0)[..., None]
    return means, count


def grayscale_u8(frames: jnp.ndarray) -> jnp.ndarray:
    """BGR uint8 -> gray uint8 with OpenCV's exact fixed-point weights.

    ``cv2.cvtColor(f, COLOR_BGR2GRAY)`` computes
    ``(R*9798 + G*19235 + B*3735 + 16384) >> 15`` (verified bit-exact against
    OpenCV 5.0) so the ``bpp.py`` statistics match the reference tool.
    """
    b = frames[..., 0].astype(jnp.int32)
    g = frames[..., 1].astype(jnp.int32)
    r = frames[..., 2].astype(jnp.int32)
    y = (r * 9798 + g * 19235 + b * 3735 + 16384) >> 15
    return y.astype(jnp.uint8)


def _histogram256(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-frame 256-bin histogram of ``(T, H, W)`` uint8, shape ``(T, 256)``."""
    T = gray.shape[0]
    flat = gray.reshape(T, -1).astype(jnp.int32)
    one_hot = jax.nn.one_hot(flat, 256, dtype=jnp.float32)
    return jnp.sum(one_hot, axis=1)


def frame_entropy(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-frame grayscale entropy, mirroring ``calculate_entropy``
    (``bpp.py:34-46``): normalized 256-bin histogram,
    ``-sum(p * log2(p + 1e-6))``."""
    hist = _histogram256(gray)
    p = hist / jnp.sum(hist, axis=-1, keepdims=True)
    return -jnp.sum(p * jnp.log2(p + 1e-6), axis=-1)


def frame_noise_variance(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-frame pixel variance, mirroring ``calculate_noise`` (``bpp.py:83-91``)."""
    g = gray.reshape(gray.shape[0], -1).astype(jnp.float32)
    return jnp.var(g, axis=-1)


def frame_nsr(gray: jnp.ndarray) -> jnp.ndarray:
    """Per-frame noise-to-signal ratio (std/mean), mirroring
    ``calculate_ns_ratio`` (``bpp.py:128-140``), 0 where mean == 0."""
    g = gray.reshape(gray.shape[0], -1).astype(jnp.float32)
    mean = jnp.mean(g, axis=-1)
    std = jnp.std(g, axis=-1)
    return jnp.where(mean == 0, 0.0, std / jnp.maximum(mean, 1e-30))


class FrameStats(NamedTuple):
    entropy: jnp.ndarray
    noise_variance: jnp.ndarray
    nsr: jnp.ndarray


@jax.jit
def video_stats(frames: jnp.ndarray) -> FrameStats:
    """All per-frame statistics of ``(T, H, W, 3)`` BGR uint8 in one pass."""
    gray = grayscale_u8(frames)
    return FrameStats(entropy=frame_entropy(gray),
                      noise_variance=frame_noise_variance(gray),
                      nsr=frame_nsr(gray))
