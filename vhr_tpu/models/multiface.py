"""Multi-subject face localization: top-K skin regions per frame.

The reference configures MediaPipe for two faces (``num_faces=2``,
``rppg_LIVESTREAM.py:308``) but only ever processes ``face_landmarks[0]``
(``rppg_LIVESTREAM.py:339-340``) — true multi-subject monitoring is new
capability here.  Array-program design: no sequential connected-component
labeling; faces separate as *runs of occupied columns* in the skin mask's
x-projection (side-by-side subjects — the webcam multi-person geometry),
each run's box recovered by masked min/max reductions.  Everything is
fixed-shape and batched over ``(T,)`` under ``jit``:

  skin mask -> column occupancy -> run ids (cumsum of run starts) ->
  per-candidate masked box + area -> top-K by area -> x-sorted identity.

Identity across frames is x-order (stable for seated subjects); per-face
dropout tolerance is the same <=15-frame holdover as single-face, vmapped
over the face axis.  Vertically stacked faces do not separate in the
x-projection — a documented limitation of the run heuristic (the learned
landmarker path is the general alternative).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .skin_detector import SkinDetectorConfig, pooled_skin_mask

__all__ = ["detect_faces_multi"]


@partial(jax.jit, static_argnames=("k_faces", "cfg", "candidates"))
def detect_faces_multi(frames: jnp.ndarray, k_faces: int = 2,
                       cfg: SkinDetectorConfig = SkinDetectorConfig(),
                       candidates: int = None
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame top-``k_faces`` face boxes from skin occupancy.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
      candidates: column runs considered before the top-K cut (default
        ``k_faces + 2`` — spurious slivers lose the area ranking).
    Returns:
      ``(boxes, valid)`` — ``(T, K, 4)`` int32 ``[x1, y1, x2, y2]``
      (inclusive ends), x-sorted (leftmost face first), and ``(T, K)`` bool.
    """
    T, H0, W0, _ = frames.shape
    k = cfg.downsample
    n_cand = candidates or (k_faces + 2)
    mask = pooled_skin_mask(frames, cfg)                    # (T, H, W)
    T, H, W = mask.shape

    counts = jnp.sum(mask, axis=1)                          # (T, W) per col
    col_occ = counts >= 2                                   # noise floor
    prev = jnp.pad(col_occ[:, :-1], ((0, 0), (1, 0)))
    starts = jnp.logical_and(col_occ, jnp.logical_not(prev))
    run_id = jnp.cumsum(starts, axis=1) - 1                 # (T, W)
    run_id = jnp.where(col_occ, run_id, -1)

    col_idx = jax.lax.broadcasted_iota(jnp.int32, (T, W), 1)
    row_idx = jax.lax.broadcasted_iota(jnp.int32, (T, H), 1)

    def one_candidate(r):
        sel = run_id == r                                   # (T, W)
        x1 = jnp.min(jnp.where(sel, col_idx, W), axis=1)
        x2 = jnp.max(jnp.where(sel, col_idx, -1), axis=1)
        m_r = jnp.logical_and(mask, sel[:, None, :])        # (T, H, W)
        rowsum = jnp.sum(m_r, axis=2)                       # (T, H)
        row_occ = rowsum >= 2
        y1 = jnp.min(jnp.where(row_occ, row_idx, H), axis=1)
        y2 = jnp.max(jnp.where(row_occ, row_idx, -1), axis=1)
        area = jnp.sum(rowsum, axis=1)
        box = jnp.stack([x1, y1, x2, y2], axis=-1)
        return box, area

    boxes_c, area_c = jax.vmap(one_candidate, out_axes=(1, 1))(
        jnp.arange(n_cand))                                 # (T, C, 4), (T, C)
    exists = boxes_c[..., 2] >= boxes_c[..., 0]
    ok = jnp.logical_and(exists,
                         area_c >= cfg.min_area_fraction * (H * W))
    ranked = jnp.where(ok, area_c, -1)

    _, top = jax.lax.top_k(ranked, k_faces)                 # (T, K)
    boxes = jnp.take_along_axis(boxes_c, top[..., None], axis=1)
    valid = jnp.take_along_axis(ok, top, axis=1)

    # Stable identity: sort the kept faces left-to-right (invalid last).
    sort_key = jnp.where(valid, boxes[..., 0], W + 1)
    order = jnp.argsort(sort_key, axis=1)
    boxes = jnp.take_along_axis(boxes, order[..., None], axis=1)
    valid = jnp.take_along_axis(valid, order, axis=1)

    if k > 1:
        boxes = jnp.stack([boxes[..., 0] * k, boxes[..., 1] * k,
                           boxes[..., 2] * k + (k - 1),
                           boxes[..., 3] * k + (k - 1)], axis=-1)
        boxes = jnp.minimum(boxes, jnp.asarray(
            [W0 - 1, H0 - 1, W0 - 1, H0 - 1], jnp.int32))
    boxes = jnp.where(valid[..., None], boxes, 0).astype(jnp.int32)
    return boxes, valid
