"""Mesh-polygon skin-mask ROI: masked channel means over a convex polygon.

Beyond-parity accuracy work: the reference only ever measures a *rectangle*
carved from the landmark min/max box (``/root/reference/analysis/utils/
roi.py:53-59``), so at the face's sides the cheek band includes background,
hair and face-edge shading.  With a dense 478-point mesh available
(:mod:`vhr_tpu.models.mediapipe_face`) the measurement region can instead
be a polygon of actual mesh vertices — it hugs the face silhouette and
rides the skin under pose changes, because mesh vertex *indices* have fixed
semantic positions on every face.

Array-program formulation (no gathers, no dynamic shapes):

1. the polygon's bounding box is resampled to a fixed ``grid x grid``
   patch as two separable bilinear interp-matrix products (the
   ``_crop_axis_mxu`` trick: dense matmuls in place of per-position
   gathers);
2. the polygon mask is rasterized on that same sample grid with
   half-plane tests against the polygon's edges — static-shape VPU
   elementwise math, one ``(T, E, G, G)`` cross-product tensor;
3. masked mean = one einsum.

The mask test is normalized by the polygon's signed area, so either
winding works; a slightly non-convex vertex ring (mesh vertices move per
face) degrades gracefully to its half-plane kernel (a subset of the
polygon), never to garbage.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["CHEEK_POLY_IDX", "polygon_channel_means", "polygon_bbox"]

# Convex hull of the 478-point face-mesh vertices that fall inside the
# reference's cheek band (ROIConfig ratios 0.15/0.40/0.65 of the rolled
# landmark bbox), derived on the bundled real portrait
# (utils/realface.real_face_image) with the production MediaPipe weights
# and pinned by tests/test_polyroi.py.  Listed in ring order (scipy
# ConvexHull order on that face); covers 79% of the band rectangle — the
# clipped 21% is exactly the off-silhouette corner area the rectangle
# wrongly includes.  Mesh topology is shared by every face, so these
# indices land on the cheeks/nose of any subject.
CHEEK_POLY_IDX = (207, 50, 118, 119, 277, 330, 427, 436, 165)


def _interp_rows(coords: jnp.ndarray, n_src: int) -> jnp.ndarray:
    """Batched bilinear interp matrices: ``(T, G)`` sample coordinates ->
    ``(T, G, n_src)`` with the crop-op edge-clamp semantics (floor tap
    clipped into range, second tap = clip(+1); matches
    ``models.mediapipe_face._interp_matrix``)."""
    x0 = jnp.floor(coords)
    f = coords - x0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, n_src - 1)
    x1i = jnp.clip(x0i + 1, 0, n_src - 1)
    src = jnp.arange(n_src, dtype=jnp.int32)
    return ((1.0 - f)[..., None] * (src == x0i[..., None])
            + f[..., None] * (src == x1i[..., None]))


def polygon_bbox(verts: jnp.ndarray, W: int, H: int) -> jnp.ndarray:
    """``(T, E, 2)`` float vertices -> ``(T, 4)`` int32 clipped
    ``[x1, y1, x2, y2]`` (exclusive ends), for display/compat with the
    rectangle-ROI conventions."""
    x1 = jnp.clip(jnp.floor(jnp.min(verts[..., 0], axis=-1)), 0, W - 1)
    y1 = jnp.clip(jnp.floor(jnp.min(verts[..., 1], axis=-1)), 0, H - 1)
    x2 = jnp.clip(jnp.ceil(jnp.max(verts[..., 0], axis=-1)), 0, W)
    y2 = jnp.clip(jnp.ceil(jnp.max(verts[..., 1], axis=-1)), 0, H)
    return jnp.stack([x1, y1, x2, y2], axis=-1).astype(jnp.int32)


def _convex_mask(verts: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray
                 ) -> jnp.ndarray:
    """Half-plane rasterization: verts ``(T, E, 2)``, sample coords
    ``xs (T, G)`` / ``ys (T, G)`` -> mask ``(T, G_y, G_x)`` float32.

    inside(p) = all_e cross(v[e+1]-v[e], p-v[e]) * sign(area) >= 0.
    Repeated vertices (padding) contribute zero cross products and drop
    out of the ``all``.
    """
    v1 = jnp.roll(verts, -1, axis=1)
    e = v1 - verts                                        # (T, E, 2)
    X = xs[:, None, None, :]                              # (T, 1, 1, Gx)
    Y = ys[:, None, :, None]                              # (T, 1, Gy, 1)
    cross = (e[..., 0][:, :, None, None] * (Y - verts[..., 1][:, :, None, None])
             - e[..., 1][:, :, None, None] * (X - verts[..., 0][:, :, None, None]))
    area2 = jnp.sum(verts[..., 0] * v1[..., 1]
                    - v1[..., 0] * verts[..., 1], axis=1)  # (T,) 2*signed
    sgn = jnp.where(area2 >= 0.0, 1.0, -1.0)
    inside = jnp.all(cross * sgn[:, None, None, None] >= 0.0, axis=1)
    return inside.astype(jnp.float32)


def polygon_channel_means(frames: jnp.ndarray, verts: jnp.ndarray,
                          grid: int = 32
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean of each color channel over a per-frame convex polygon.

    Args:
      frames: ``(T, H, W, C)`` uint8 (or float).
      verts: ``(T, E, 2)`` float32 polygon vertices in image pixels, ring
        order (either winding).  All-zero vertices (an invalid frame's
        convention) produce zero means and zero count.
      grid: resampling resolution per axis; the mean is estimated over
        ``grid**2`` bilinear samples uniform in the polygon's bbox.

    Returns:
      ``(means, count)`` — ``(T, C)`` float32 channel means (0 where the
      mask is empty) and ``(T,)`` float32 *pixel-unit* mask areas
      (mask fraction x bbox area, comparable to
      :func:`vhr_tpu.ops.reduce.roi_channel_means` counts).
    """
    T, H, W, C = frames.shape
    x1 = jnp.min(verts[..., 0], axis=-1)
    x2 = jnp.max(verts[..., 0], axis=-1)
    y1 = jnp.min(verts[..., 1], axis=-1)
    y2 = jnp.max(verts[..., 1], axis=-1)
    u = (jnp.arange(grid, dtype=jnp.float32) + 0.5) / grid
    xs = x1[:, None] + u[None, :] * (x2 - x1)[:, None]    # (T, G)
    ys = y1[:, None] + u[None, :] * (y2 - y1)[:, None]
    gx = _interp_rows(xs, W)                              # (T, G, W)
    gy = _interp_rows(ys, H)                              # (T, G, H)
    fr = frames.astype(jnp.float32)
    # Separable resample as two matmuls: x-pass then y-pass.
    tmp = jnp.einsum("thwc,tgw->thgc", fr, gx)            # (T, H, G, C)
    patch = jnp.einsum("tmh,thgc->tmgc", gy, tmp)         # (T, Gy, Gx, C)
    mask = _convex_mask(verts, xs, ys)                    # (T, Gy, Gx)
    # Clip to the image: samples whose coordinates fall outside
    # [0, W) x [0, H) would otherwise edge-clamp (replicating border
    # pixels into the mean) and over-report the pixel-unit area — the
    # reference clips its ROI to the frame (analysis/utils/roi.py:56-59),
    # so off-image polygon area must contribute neither to sums nor count.
    in_x = jnp.logical_and(xs >= 0.0, xs < float(W)).astype(jnp.float32)
    in_y = jnp.logical_and(ys >= 0.0, ys < float(H)).astype(jnp.float32)
    mask = mask * in_y[:, :, None] * in_x[:, None, :]
    sums = jnp.einsum("tmgc,tmg->tc", patch, mask)
    frac = jnp.sum(mask, axis=(1, 2))                     # grid cells
    means = sums / jnp.maximum(frac, 1.0)[:, None]
    count = (frac / float(grid * grid)
             * jnp.maximum(x2 - x1, 0.0) * jnp.maximum(y2 - y1, 0.0))
    means = jnp.where(count[:, None] > 0.0, means, 0.0)
    return means, count
