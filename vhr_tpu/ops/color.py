"""Batched colorspace conversions.

The reference's EVM path exists only as a broken stub (``bgr2yiq`` at
``rppg_VIDEO.py:120-124`` calls ``colorsys.rgb_to_yiq`` with arrays — a
TypeError if ever invoked; SURVEY.md §4 item 3).  These are the working
batched equivalents, using colorsys's exact NTSC YIQ coefficients so the
intended transform is preserved.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["bgr_u8_to_yiq", "yiq_to_bgr_u8", "rgb_to_yiq", "yiq_to_rgb",
           "i420_to_bgr_flat", "i420_roi_means"]

# OpenCV's ITU-R BT.601 studio-swing fixed-point constants (20-bit descale,
# modules/imgproc color_yuv: CY=1.164, CVR=1.596, CVG=-0.813, CUG=-0.391,
# CUB=2.018).  Kept as the exact integers so the device reconstruction is
# BIT-EXACT vs cv2.COLOR_YUV2BGR_I420 (pinned in tests/test_native_io.py).
_CY, _CUB, _CUG, _CVG, _CVR = 1220542, 2116026, -409993, -852492, 1673527


def i420_to_bgr_flat(chunk: jnp.ndarray, h: int, w: int,
                     w_out: int | None = None) -> jnp.ndarray:
    """Planar YUV 4:2:0 bytes -> flat interleaved BGR, on device.

    ``chunk`` is ``(n, stride)`` uint8 with the first ``h*w*3//2`` bytes of
    each row holding Y (h, w) then U, V ((h//2, w//2) each) — the layout the
    native framestore stages in ``fmt="i420"`` mode (1.5 B/px, half the
    host->device bytes of interleaved BGR).

    Chroma is replicated over each 2x2 block and the studio-swing BT.601
    matrix applied in int32 fixed point — bit-exact vs OpenCV's
    ``cv2.COLOR_YUV2BGR_I420`` (the decoder the reference's whole pipeline
    rides through, ``analysis/utils/video_io.py:19-31``).

    Returns ``(n, h, w_out*3)`` uint8 (``w_out`` defaults to ``w``; a wider
    ``w_out`` adds zero columns, matching the BGR staging path's row
    padding).
    """
    n = chunk.shape[0]
    ysz, csz = h * w, (h // 2) * (w // 2)
    y = chunk[:, :ysz].reshape(n, h, w).astype(jnp.int32)
    u = chunk[:, ysz:ysz + csz].reshape(n, h // 2, w // 2).astype(jnp.int32)
    v = (chunk[:, ysz + csz:ysz + 2 * csz]
         .reshape(n, h // 2, w // 2).astype(jnp.int32))
    up = jnp.repeat(jnp.repeat(u, 2, axis=1), 2, axis=2) - 128
    vp = jnp.repeat(jnp.repeat(v, 2, axis=1), 2, axis=2) - 128
    yv = jnp.maximum(y - 16, 0) * _CY
    half = 1 << 19
    b = (yv + _CUB * up + half) >> 20
    g = (yv + _CUG * up + _CVG * vp + half) >> 20
    r = (yv + _CVR * vp + half) >> 20
    bgr = jnp.clip(jnp.stack([b, g, r], axis=-1), 0, 255).astype(jnp.uint8)
    if w_out is not None and w_out != w:
        bgr = jnp.pad(bgr, ((0, 0), (0, 0), (0, w_out - w), (0, 0)))
    return bgr.reshape(n, h, -1)


def rgb_to_yiq(rgb: jnp.ndarray) -> jnp.ndarray:
    """``(..., 3)`` RGB in [0,1] -> YIQ (colorsys.rgb_to_yiq coefficients)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.30 * r + 0.59 * g + 0.11 * b
    i = 0.74 * (r - y) - 0.27 * (b - y)
    q = 0.48 * (r - y) + 0.41 * (b - y)
    return jnp.stack([y, i, q], axis=-1)


def yiq_to_rgb(yiq: jnp.ndarray) -> jnp.ndarray:
    """YIQ -> RGB in [0,1] (colorsys.yiq_to_rgb coefficients + clamp)."""
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    r = y + 0.9468822170900693 * i + 0.6235565819861433 * q
    g = y - 0.27478764629897834 * i - 0.6356910791873801 * q
    b = y - 1.1085450346420322 * i + 1.7090069284064666 * q
    return jnp.clip(jnp.stack([r, g, b], axis=-1), 0.0, 1.0)


def bgr_u8_to_yiq(frames: jnp.ndarray) -> jnp.ndarray:
    """``(..., 3)`` uint8 BGR -> float32 YIQ in [0,1] luminance scale."""
    rgb = frames[..., ::-1].astype(jnp.float32) / 255.0
    return rgb_to_yiq(rgb)


def yiq_to_bgr_u8(yiq: jnp.ndarray) -> jnp.ndarray:
    rgb = yiq_to_rgb(yiq)
    bgr = rgb[..., ::-1]
    return jnp.clip(jnp.round(bgr * 255.0), 0, 255).astype(jnp.uint8)


def i420_roi_means(chunk: jnp.ndarray, rois: jnp.ndarray, h: int, w: int
                   ) -> tuple:
    """BGR channel means over per-frame ROIs, directly on planar YUV 4:2:0.

    The ingest-native fast path: the reconstruction
    (``b = (CY*relu(y-16) + CUB*(u-128) + half) >> 20``, clipped) is affine
    per pixel, so channel *means* over a region are the same affine map of
    the plane means — RGB never materializes, and the masked reductions
    read 1.5 B/px of planes instead of writing + re-reading a 3 B/px BGR
    tensor.  ``relu`` is applied per Y pixel before reduction (exact);
    chroma replication makes the full-res chroma mean equal the half-res
    plane mean when the box is even-aligned (odd edges contribute a
    half-pixel boundary approximation).  Dropping the per-pixel
    floor-descale and clip shifts a mean by <0.5 u8 unless the ROI holds
    out-of-gamut pixels (pinned vs the reconstruction path in
    tests/test_native_io.py).

    Args:
      chunk: ``(T, stride)`` uint8 planar I420 frames
        (``NativeVideoReader(fmt="i420")`` layout).
      rois: ``(T, 4)`` int32 ``[x1, y1, x2, y2]`` (exclusive ends) in
        full-resolution coordinates.
    Returns:
      ``(means (T, 3) float32 BGR, count (T,) float32)`` — same contract
      as :func:`vhr_tpu.ops.reduce.roi_channel_means`.
    """
    import jax

    T = chunk.shape[0]
    h2, w2 = h // 2, w // 2
    ysz, csz = h * w, h2 * w2
    y = chunk[:, :ysz].reshape(T, h, w)
    u = chunk[:, ysz:ysz + csz].reshape(T, h2, w2)
    v = chunk[:, ysz + csz:ysz + 2 * csz].reshape(T, h2, w2)

    x1, y1 = rois[:, 0], rois[:, 1]
    x2, y2 = rois[:, 2], rois[:, 3]

    def masked_sum(plane, px1, py1, px2, py2, hh, ww, pre=None):
        rows = jax.lax.broadcasted_iota(jnp.int32, (T, hh), 1)
        cols = jax.lax.broadcasted_iota(jnp.int32, (T, ww), 1)
        row_m = ((rows >= py1[:, None]) & (rows < py2[:, None]))
        col_m = ((cols >= px1[:, None]) & (cols < px2[:, None]))
        fr = plane.astype(jnp.float32)
        if pre is not None:
            fr = pre(fr)
        part = jnp.einsum("thw,tw->th", fr, col_m.astype(jnp.float32),
                          precision=jax.lax.Precision.HIGHEST)
        s = jnp.einsum("th,th->t", part, row_m.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)
        n = (jnp.maximum(py2 - py1, 0)
             * jnp.maximum(px2 - px1, 0)).astype(jnp.float32)
        return s, n

    ysum, yn = masked_sum(y, x1, y1, x2, y2, h, w,
                          pre=lambda f: jnp.maximum(f - 16.0, 0.0))
    # chroma box: replication maps full-res (r, c) -> plane (r//2, c//2);
    # even-aligned boxes cover whole cells (exact), odd edges round outward
    cx1, cy1 = x1 // 2, y1 // 2
    cx2, cy2 = -(-x2 // 2), -(-y2 // 2)
    usum, un = masked_sum(u, cx1, cy1, cx2, cy2, h2, w2,
                          pre=lambda f: f - 128.0)
    vsum, _ = masked_sum(v, cx1, cy1, cx2, cy2, h2, w2,
                         pre=lambda f: f - 128.0)

    ym = ysum / jnp.maximum(yn, 1.0)
    um = usum / jnp.maximum(un, 1.0)
    vm = vsum / jnp.maximum(un, 1.0)
    scale = 1.0 / float(1 << 20)
    b = (_CY * ym + _CUB * um) * scale
    g = (_CY * ym + _CUG * um + _CVG * vm) * scale
    r = (_CY * ym + _CVR * vm) * scale
    means = jnp.stack([b, g, r], axis=-1)
    means = jnp.where(yn[:, None] > 0, jnp.clip(means, 0.0, 255.0), 0.0)
    return means, yn
