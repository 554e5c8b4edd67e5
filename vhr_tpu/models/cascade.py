"""Two-stage cascade detection: proposals + landmarker crop refinement.

The reference's MediaPipe pipeline is itself a cascade (BlazeFace proposal
-> face-mesh refinement on a crop).  Two compositions here, measured on the
held-out hard generator (see tests):

* **self-refinement** (:func:`make_refined_detector`) — full-frame
  landmarker proposes, a second landmarker pass on a pad-0.3 crop around
  its own box sharpens it: held-out IoU 0.890 -> 0.924.  The accuracy
  flagship for single-face.
* **multi-face cascade** (:func:`make_cascade_detector_multi`) — top-K skin
  proposals, each refined on its crop with a presence veto.  Refinement
  helps when proposals are roughly right (clean scenes) and vetoes junk
  regions; when the skin stage itself collapses (skin-colored backgrounds)
  the crops miss the faces.
* **tiled multi-face** (:func:`make_tiled_detector_multi`) — fully-learned
  proposals: the landmarker swept over a static two-scale window grid,
  score-descending NMS with IoMin containment suppression, crop refinement
  with presence veto, cross-slot dedupe.  Survives the skin-background
  matrix row that defeats the chroma proposal stage (docs/DETECTION.md).

All crops are fixed-size separable bilinear resamples run as two dense
interp-matrix products (static shapes, vmappable over time and faces;
dense matmuls in place of per-position gathers — see
``mediapipe_face._crop_axis_mxu``); weights ride as `jax.tree_util.Partial` args
(traced, not baked literals).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .landmarker import FaceLandmarker, LandmarkerConfig
from .skin_detector import SkinDetectorConfig

__all__ = ["crop_boxes_bilinear", "refine_boxes", "make_refined_detector",
           "make_cascade_detector_multi", "tiled_landmark_proposals",
           "select_faces_nms", "make_tiled_detector_multi"]


def crop_boxes_bilinear(frames: jnp.ndarray, boxes: jnp.ndarray,
                        out_size: int, pad: float = 0.5) -> Tuple[
                            jnp.ndarray, jnp.ndarray]:
    """Sample padded square crops around per-frame boxes.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
      boxes: ``(T, 4)`` int32 ``[x1, y1, x2, y2]``.
      pad: fractional margin per side (0.3 measured best for
        self-refinement; the face then spans ~60% of the crop).
    Returns:
      ``(crops (T, S, S, 3) float32 RGB in [0, 1], origins (T, 4) float32
      [x0, y0, w, h])`` — origins map crop coordinates back to pixels.
    """
    T, H, W, _ = frames.shape
    S = out_size
    b = boxes.astype(jnp.float32)
    cx = (b[:, 0] + b[:, 2]) * 0.5
    cy = (b[:, 1] + b[:, 3]) * 0.5
    half = jnp.maximum(jnp.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]),
                       2.0) * 0.5 * (1.0 + 2.0 * pad)
    x0, y0 = cx - half, cy - half
    side = 2.0 * half

    u = jnp.arange(S, dtype=jnp.float32) / (S - 1)            # (S,)
    xs = x0[:, None] + u[None, :] * side[:, None]             # (T, S)
    ys = y0[:, None] + u[None, :] * side[:, None]

    def interp_mat(coords, n):
        """(S,) sample coords -> (S, n) bilinear matrix: coords clamped to
        [0, n-1], floor tap clipped to n-2 — the edge-clamp semantics of
        the gather form this replaced (values outside the frame repeat the
        edge row/column)."""
        cc = jnp.clip(coords, 0.0, n - 1.0)
        i0 = jnp.clip(jnp.floor(cc).astype(jnp.int32), 0, n - 2)
        f = cc - i0.astype(jnp.float32)
        src = jnp.arange(n, dtype=jnp.int32)[None, :]
        return ((1.0 - f)[:, None] * (src == i0[:, None])
                + f[:, None] * (src == (i0 + 1)[:, None]))

    def sample_one(img, xr, yr):
        """Separable bilinear resample of one frame at the (S, S) grid:
        an x-pass and a y-pass dense matmul (bf16 inputs with
        f32 accumulation bound the error at ~1 u8 LSB: pixel values are
        exact in bf16, interp weights round to 2^-9)."""
        gx = interp_mat(xr, W)                                # (S, W)
        gy = interp_mat(yr, H)                                # (S, H)
        imgf = img.astype(jnp.float32)
        tmp = jnp.einsum("hwc,sw->hsc", imgf, gx)             # (H, S, 3)
        return jnp.einsum("th,hsc->tsc", gy, tmp)             # (S, S, 3)

    crops = jax.vmap(sample_one)(frames, xs, ys)              # (T, S, S, 3)
    crops = crops[..., ::-1] / 255.0                          # BGR -> RGB
    origins = jnp.stack([x0, y0, side, side], axis=-1)
    return crops, origins


def refine_boxes(params, frames: jnp.ndarray, boxes: jnp.ndarray,
                 valid: jnp.ndarray,
                 cfg: LandmarkerConfig = LandmarkerConfig(),
                 threshold: float = 0.0, pad: float = 0.3
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Refine proposal boxes with the landmarker on padded crops.

    Returns refined ``(boxes, valid)``; invalid proposals pass through
    unchanged (masked), and a proposal whose crop the landmarker rejects
    (presence below ``threshold``) turns invalid.
    """
    T, H, W, _ = frames.shape
    model = FaceLandmarker(cfg)
    crops, origins = crop_boxes_bilinear(frames, boxes, cfg.input_size, pad)
    lm, presence = model.apply({"params": params}, crops)    # (T, L, 2)
    px = origins[:, 0:1] + lm[..., 0] * origins[:, 2:3]      # (T, L)
    py = origins[:, 1:2] + lm[..., 1] * origins[:, 3:4]
    x1 = jnp.clip(jnp.min(px, axis=1), 0, W - 1).astype(jnp.int32)
    y1 = jnp.clip(jnp.min(py, axis=1), 0, H - 1).astype(jnp.int32)
    x2 = jnp.clip(jnp.max(px, axis=1), 0, W - 1).astype(jnp.int32)
    y2 = jnp.clip(jnp.max(py, axis=1), 0, H - 1).astype(jnp.int32)
    refined = jnp.stack([x1, y1, x2, y2], axis=-1)
    ok = jnp.logical_and(valid, presence > threshold)
    out = jnp.where(ok[:, None], refined, boxes)
    return out, ok


def make_refined_detector(params,
                          cfg: LandmarkerConfig = LandmarkerConfig(),
                          threshold: float = 0.0, pad: float = 0.3,
                          passes: int = 1):
    """Single-face accuracy flagship: landmarker + crop self-refinement.

    Full-frame landmarker proposes; ``passes`` additional landmarker runs on
    a crop around the current box sharpen it (held-out IoU 0.890 -> 0.924
    with one pass).  Same ``frames -> (boxes, valid)`` interface as
    ``skin_detector.detect_faces``; drops into ``extract_signals``.
    """
    from .landmarker import landmarks_to_bbox_valid, preprocess_frames

    model = FaceLandmarker(cfg)

    def _detect(p, frames):
        T, H, W, _ = frames.shape
        x = preprocess_frames(frames, cfg.input_size)
        lm, presence = model.apply({"params": p}, x)
        boxes, valid = landmarks_to_bbox_valid(lm, presence, W, H, threshold)
        for _ in range(passes):
            boxes, valid = refine_boxes(p, frames, boxes, valid, cfg,
                                        threshold, pad)
        return boxes, valid

    return jax.tree_util.Partial(_detect, params)


def load_default_refined_detector(path: str = None, threshold: float = 0.0,
                                  passes: int = 1):
    """The repo checkpoint wrapped as the self-refining detector."""
    from .landmarker import load_default_detector

    det = load_default_detector(path, threshold)   # Partial(_detect, params)
    params = det.args[0]
    from .train import TrainConfig
    return make_refined_detector(params, TrainConfig().model, threshold,
                                 passes=passes)


def _tile_windows(H: int, W: int, scales=(1.0, 0.6)):
    """Static (Python-time) square window grid covering the frame.

    Per scale ``s``: windows of side ``s * min(H, W)`` laid out with ~50%
    overlap along each axis (``linspace`` so the last window always touches
    the frame edge), plus one full-frame window for the large-single-face
    case.  Returns ``(Nw, 4)`` int32 ``[x1, y1, x2, y2]`` inclusive.
    """
    import numpy as np

    wins = []
    for s in scales:
        side = max(int(round(min(H, W) * s)), 8)
        stride = max(side // 2, 1)
        nx = max(1, int(np.ceil((W - side) / stride)) + 1)
        ny = max(1, int(np.ceil((H - side) / stride)) + 1)
        xs = np.round(np.linspace(0, W - side, nx)).astype(np.int32)
        ys = np.round(np.linspace(0, H - side, ny)).astype(np.int32)
        for y0 in ys:
            for x0 in xs:
                wins.append([x0, y0, x0 + side - 1, y0 + side - 1])
    wins.append([0, 0, W - 1, H - 1])
    return np.unique(np.array(wins, np.int32), axis=0)


def tiled_landmark_proposals(params, frames: jnp.ndarray,
                             cfg: LandmarkerConfig = LandmarkerConfig(),
                             scales=(1.0, 0.6), window_batch: int = None
                             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Learned multi-face proposals: the single-face landmarker swept over a
    static window grid.

    The reference gets multi-face proposals from BlazeFace inside MediaPipe
    (``rppg_LIVESTREAM.py:308`` ``num_faces=2``); here the trained
    single-face landmarker plays both roles — each window that contains a
    face yields that face's landmark box (mapped back to frame pixels) with
    the presence logit as its score.  Windows run in ``window_batch``
    groups under ``lax.map`` (crop gather vmapped within a group, one
    ``G*T`` conv batch per step); ``window_batch=None`` (default) auto-
    sizes the group to the ~50 MB crop-stack budget, so short-T calls (the
    live path, detection-cadence offline chunks) put EVERY window in one
    conv batch and the sequential ``lax.map`` disappears entirely (one
    batched launch instead of ~Nw sequential landmarker passes), while long whole-clip calls still bound memory by grouping.

    Returns ``(boxes (T, Nw, 4) int32, scores (T, Nw) float32)``.
    """
    T, H, W, _ = frames.shape
    wins_np = _tile_windows(H, W, scales)                    # (Nw, 4)
    Nw = len(wins_np)
    # Cap the group so G*T crop stacks stay ~50 MB regardless of clip
    # length (512 crops of 96x96x3 f32 ~= 54 MB).
    cap = max(1, 512 // max(T, 1))
    G = max(1, min(Nw, cap if window_batch is None
                   else min(window_batch, cap)))
    n_groups = -(-Nw // G)
    pad = n_groups * G - Nw
    if pad:                  # repeat the last window; masked out below
        import numpy as np
        wins_np = np.concatenate([wins_np, np.repeat(wins_np[-1:], pad, 0)])
    wins = jnp.asarray(wins_np).reshape(n_groups, G, 4)
    model = FaceLandmarker(cfg)
    S = cfg.input_size

    def one_group(group):                                    # (G, 4)
        def crop_one(win):
            b = jnp.broadcast_to(win[None, :], (T, 4))
            return crop_boxes_bilinear(frames, b, S, pad=0.0)
        crops, origins = jax.vmap(crop_one)(group)           # (G,T,S,S,3)
        lm, presence = model.apply({"params": params},
                                   crops.reshape(G * T, S, S, 3))
        lm = lm.reshape(G, T, -1, 2)
        presence = presence.reshape(G, T)
        px = origins[..., 0:1] + lm[..., 0] * origins[..., 2:3]  # (G,T,L)
        py = origins[..., 1:2] + lm[..., 1] * origins[..., 3:4]
        x1 = jnp.clip(jnp.min(px, axis=-1), 0, W - 1)
        y1 = jnp.clip(jnp.min(py, axis=-1), 0, H - 1)
        x2 = jnp.clip(jnp.max(px, axis=-1), 0, W - 1)
        y2 = jnp.clip(jnp.max(py, axis=-1), 0, H - 1)
        boxes = jnp.stack([x1, y1, x2, y2], axis=-1).astype(jnp.int32)
        return boxes, presence

    boxes, scores = jax.lax.map(one_group, wins)     # (n_groups, G, T, ...)
    boxes = boxes.reshape(n_groups * G, T, 4)[:Nw]
    scores = scores.reshape(n_groups * G, T)[:Nw]
    return boxes.transpose(1, 0, 2), scores.T


def _iomin(box: jnp.ndarray, boxes: jnp.ndarray) -> jnp.ndarray:
    """Intersection over MINIMUM area of ``box`` vs each of ``boxes``.

    Unlike IoU this flags containment: a spurious merged/partial detection
    that contains (or is contained by) an accepted face scores ~1 even when
    the union is large.
    """
    def area(b):
        return jnp.maximum(b[..., 2] - b[..., 0] + 1, 0) * \
               jnp.maximum(b[..., 3] - b[..., 1] + 1, 0)
    ix1 = jnp.maximum(box[0], boxes[:, 0])
    iy1 = jnp.maximum(box[1], boxes[:, 1])
    ix2 = jnp.minimum(box[2], boxes[:, 2])
    iy2 = jnp.minimum(box[3], boxes[:, 3])
    inter = jnp.maximum(ix2 - ix1 + 1, 0) * jnp.maximum(iy2 - iy1 + 1, 0)
    denom = jnp.minimum(area(box), area(boxes)).astype(jnp.float32)
    return inter.astype(jnp.float32) / jnp.maximum(denom, 1.0)


def select_faces_nms(boxes: jnp.ndarray, scores: jnp.ndarray,
                     k_faces: int, threshold: float = 0.0,
                     suppress: float = 0.35,
                     min_area_fraction: float = 0.001,
                     frame_hw: Tuple[int, int] = None
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-shape greedy NMS of ``k_faces`` from window proposals.

    Score-descending with IoMin containment suppression.  The presence
    head naturally ranks clean single-face windows far above merged or
    partial views (measured on the shipped checkpoint: +16..+18 for a
    centered face vs +0.3..+5.6 for a window straddling two faces), so
    score order picks each true face before any merged box; IoMin (rather
    than IoU) also dedupes a *partial* re-detection of an already-picked
    face, whose union-based IoU would slip under an IoU gate.  All shapes
    static; vmapped over time.

    Args:
      boxes/scores: ``(T, Nw, 4)`` / ``(T, Nw)`` from
        :func:`tiled_landmark_proposals`.
    Returns:
      ``(boxes (T, K, 4) int32, valid (T, K) bool)`` in pick order.
    """
    H, W = frame_hw if frame_hw is not None else (None, None)
    min_area = (min_area_fraction * H * W) if frame_hw is not None else 0.0

    def one_frame(bx, sc):
        area = ((bx[:, 2] - bx[:, 0] + 1) *
                (bx[:, 3] - bx[:, 1] + 1)).astype(jnp.float32)
        ok = sc > threshold
        if min_area:
            ok = jnp.logical_and(ok, area >= min_area)
        key = jnp.where(ok, sc, -jnp.inf)
        picked_b, picked_v = [], []
        for _ in range(k_faces):
            i = jnp.argmax(key)
            keep = jnp.isfinite(key[i])
            b = bx[i]
            picked_b.append(jnp.where(keep, b, 0))
            picked_v.append(keep)
            overlap = _iomin(b, bx) > suppress
            key = jnp.where(jnp.logical_and(keep, overlap), -jnp.inf, key)
        return jnp.stack(picked_b), jnp.stack(picked_v)

    return jax.vmap(one_frame)(boxes, scores)


def make_tiled_detector_multi(params,
                              cfg: LandmarkerConfig = LandmarkerConfig(),
                              k_faces: int = 2, scales=(1.0, 0.6),
                              threshold: float = 0.0, pad: float = 0.3,
                              suppress: float = 0.5, refine: bool = True):
    """Fully-learned multi-face detector: tiled landmarker proposals +
    containment selection + per-slot crop refinement.

    Closes the documented gap of :func:`make_cascade_detector_multi`: no
    chroma stage anywhere, so skin-colored backgrounds (which collapse the
    skin-occupancy proposals of ``multiface.detect_faces_multi``) cannot
    take down the proposal stage.  ``frames -> (boxes (T, K, 4), valid
    (T, K))``, x-sorted identity — drops into
    ``pipeline.offline.extract_signals_multi(detector=...)``.
    """

    def _detect(p, frames):
        T, H, W, _ = frames.shape
        props, scores = tiled_landmark_proposals(p, frames, cfg, scales)
        boxes, valid = select_faces_nms(
            props, scores, k_faces, threshold, suppress, frame_hw=(H, W))
        if refine:
            def one(bk, vk):
                return refine_boxes(p, frames, bk, vk, cfg, threshold, pad)
            boxes, valid = jax.vmap(one, in_axes=(1, 1), out_axes=1)(
                boxes, valid)

            # Cross-slot dedupe: a half-face proposal at a window edge can
            # slip past NMS (low IoMin with the true box) but its refine
            # crop re-centers on the face, so the refined box converges
            # onto an earlier slot's — invalidate the lower-priority
            # (pick-order = score-order) duplicate.
            def dedupe(bx, vv):
                for j in range(1, k_faces):
                    for i in range(j):
                        dup = jnp.logical_and(
                            vv[i], _iomin(bx[j], bx[i][None])[0] > 0.6)
                        vv = vv.at[j].set(jnp.logical_and(vv[j], ~dup))
                return vv
            valid = jax.vmap(dedupe)(boxes, valid)
        # Stable x-order identity (matches multiface.detect_faces_multi).
        sort_key = jnp.where(valid, boxes[..., 0], W + 1)
        order = jnp.argsort(sort_key, axis=1)
        boxes = jnp.take_along_axis(boxes, order[..., None], axis=1)
        valid = jnp.take_along_axis(valid, order, axis=1)
        boxes = jnp.where(valid[..., None], boxes, 0)
        return boxes, valid

    return jax.tree_util.Partial(_detect, params)


def make_cascade_detector_multi(params,
                                cfg: LandmarkerConfig = LandmarkerConfig(),
                                k_faces: int = 2,
                                det: SkinDetectorConfig = SkinDetectorConfig(),
                                threshold: float = 0.0, pad: float = 0.3):
    """Multi-face cascade: top-K skin proposals, each refined on its crop.

    ``frames -> (boxes (T, K, 4), valid (T, K))`` — the multi-face detector
    interface of ``multiface.detect_faces_multi``.
    """
    from .multiface import detect_faces_multi

    def _detect(p, frames):
        boxes, valid = detect_faces_multi(frames, k_faces, det)

        def one(bk, vk):
            return refine_boxes(p, frames, bk, vk, cfg, threshold, pad)

        return jax.vmap(one, in_axes=(1, 1), out_axes=1)(boxes, valid)

    return jax.tree_util.Partial(_detect, params)
