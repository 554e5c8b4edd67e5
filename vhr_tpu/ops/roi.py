"""ROI geometry as pure batched index math.

A batched re-design of the reference's per-frame ROI extraction
(``analysis/utils/roi.py:43-59``, ``rppg_VIDEO.py:49-55,91-103``): bounding
boxes and ROI rectangles are ``(..., 4)`` int32 tensors ``[x1, y1, x2, y2]``
computed for *all* frames at once; detection dropout becomes a validity mask
threaded through a ``lax.scan`` holdover (mirroring the <=15-frame landmark
reuse at ``analysis/utils/roi.py:10,91-95``) instead of Python branching.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ROIConfig

__all__ = [
    "BoxTrack",
    "bbox_from_landmarks",
    "roi_from_bbox",
    "roi_from_landmarks",
    "cheek_roi",
    "cheek_roi_from_landmarks",
    "forehead_roi",
    "measurement_roi",
    "holdover",
    "holdover_multi",
    "holdover_multi_step",
    "init_multi_carry",
]


class BoxTrack(NamedTuple):
    """Per-frame boxes with validity after dropout holdover."""

    box: jnp.ndarray    # (..., T, 4) int32 [x1, y1, x2, y2]
    valid: jnp.ndarray  # (..., T) bool


def bbox_from_landmarks(landmarks: jnp.ndarray, width: int, height: int
                        ) -> jnp.ndarray:
    """Face bounding box from normalized landmarks.

    Mirrors ``_bbox_from_landmarks`` (``analysis/utils/roi.py:43-50``):
    min/max over the landmark cloud, scaled to pixels, clamped to the frame.

    Args:
      landmarks: ``(..., L, 2)`` normalized [x, y] in [0, 1].
    Returns:
      ``(..., 4)`` int32 ``[x1, y1, x2, y2]``.
    """
    xs = landmarks[..., 0]
    ys = landmarks[..., 1]
    x1 = jnp.clip((jnp.min(xs, axis=-1) * width).astype(jnp.int32), 0, None)
    y1 = jnp.clip((jnp.min(ys, axis=-1) * height).astype(jnp.int32), 0, None)
    x2 = jnp.minimum((jnp.max(xs, axis=-1) * width).astype(jnp.int32), width - 1)
    y2 = jnp.minimum((jnp.max(ys, axis=-1) * height).astype(jnp.int32), height - 1)
    return jnp.stack([x1, y1, x2, y2], axis=-1)


def roi_from_bbox(bbox: jnp.ndarray, horizontal: float, top: float,
                  bottom: float, width: int, height: int) -> jnp.ndarray:
    """Sub-rectangle of a bbox by ratios, clamped to the frame.

    Mirrors ``get_roi_coords`` (``rppg_VIDEO.py:49-55``) /
    ``_cheek_roi_from_bbox`` (``analysis/utils/roi.py:53-59``): the ROI spans
    ``[x1 + r*(x2-x1), x2 - r*(x2-x1)]`` horizontally and
    ``[y1 + top*h, y1 + bottom*h]`` vertically.

    Args:
      bbox: ``(..., 4)`` int32.
    Returns:
      ``(..., 4)`` int32 ``[x1, y1, x2, y2]`` (x2/y2 exclusive).
    """
    x1, y1, x2, y2 = (bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3])
    bw = (x2 - x1).astype(jnp.float32)
    bh = (y2 - y1).astype(jnp.float32)
    # The reference truncates the *final* float expression (int(x2 - r*bw)),
    # so the upper-x edge rounds via ceil of the margin.
    rx1 = x1 + jnp.floor(horizontal * bw).astype(jnp.int32)
    rx2 = x2 - jnp.ceil(horizontal * bw).astype(jnp.int32)
    ry1 = y1 + jnp.floor(top * bh).astype(jnp.int32)
    ry2 = y1 + jnp.floor(bottom * bh).astype(jnp.int32)
    rx1 = jnp.clip(rx1, 0, width - 1)
    ry1 = jnp.clip(ry1, 0, height - 1)
    rx2 = jnp.clip(rx2, 0, width)
    ry2 = jnp.clip(ry2, 0, height)
    return jnp.stack([rx1, ry1, rx2, ry2], axis=-1)


def cheek_roi(bbox: jnp.ndarray, cfg: ROIConfig, width: int, height: int
              ) -> jnp.ndarray:
    return roi_from_bbox(bbox, cfg.cheek_horizontal, cfg.cheek_top,
                         cfg.cheek_bottom, width, height)


def forehead_roi(bbox: jnp.ndarray, cfg: ROIConfig, width: int, height: int
                 ) -> jnp.ndarray:
    return roi_from_bbox(bbox, cfg.forehead_horizontal, cfg.forehead_top,
                         cfg.forehead_bottom, width, height)


def measurement_roi(bbox: jnp.ndarray, cfg: ROIConfig, width: int,
                    height: int, site: str = "cheek") -> jnp.ndarray:
    """The configured measurement site's ROI (``PipelineConfig.roi_site``)."""
    if site == "cheek":
        return cheek_roi(bbox, cfg, width, height)
    if site == "forehead":
        return forehead_roi(bbox, cfg, width, height)
    raise ValueError(f"unknown roi_site {site!r} (cheek|forehead)")


def roi_from_landmarks(landmarks: jnp.ndarray, horizontal: float,
                       top: float, bottom: float, width: int, height: int
                       ) -> jnp.ndarray:
    """Pose-robust ROI directly from the landmark cloud.

    The reference collapses its 478 landmarks to an axis-aligned min/max box
    before carving ROI ratios out of it (``rppg_VIDEO.py:93-103``) — under
    head roll the interior ratios drift off the cheeks.  Here the same
    ratios are applied in the face's OWN frame: the landmark set samples the
    face boundary at uniform angles (``models/facegen.py`` ground truth), so
    the first circular Fourier harmonic of the cloud recovers the center and
    the rotated semi-axis vectors exactly,

      ``c = mean(lms)``, ``u = (2/L) sum lms_i cos(theta_i)`` (rotated
      ``(rx, 0)``), ``v = (2/L) sum lms_i sin(theta_i)`` (rotated
      ``(0, ry)``),

    and the ROI ratios map to local corners ``alpha in [-(1-2*horizontal)]
    ... , beta in [2*top-1, 2*bottom-1]``.  The returned axis-aligned rect
    is the bounding box of the four rotated corners — identical to
    :func:`roi_from_bbox` (up to rounding) for an upright face, and tracking
    the rotated cheek band otherwise.  Using every landmark (not just the 4
    extremes) averages down per-point regression noise.

    Args:
      landmarks: ``(..., L, 2)`` normalized [x, y] in [0, 1].
    Returns:
      ``(..., 4)`` int32 ``[x1, y1, x2, y2]`` (x2/y2 exclusive).
    """
    L = landmarks.shape[-2]
    theta = 2.0 * np.pi * np.arange(L, dtype=np.float32) / L
    cosw = jnp.asarray(np.cos(theta))
    sinw = jnp.asarray(np.sin(theta))
    scale = jnp.asarray([width, height], jnp.float32)
    pts = landmarks * scale                                   # pixels
    c = jnp.mean(pts, axis=-2)                                # (..., 2)
    u = 2.0 / L * jnp.sum(pts * cosw[:, None], axis=-2)       # (..., 2)
    v = 2.0 / L * jnp.sum(pts * sinw[:, None], axis=-2)       # (..., 2)

    alphas = np.array([-(1.0 - 2.0 * horizontal), 1.0 - 2.0 * horizontal],
                      np.float32)
    betas = np.array([2.0 * top - 1.0, 2.0 * bottom - 1.0], np.float32)
    corners = jnp.stack([c + a * u + b * v
                         for a in alphas for b in betas], axis=-2)
    x1 = jnp.clip(jnp.min(corners[..., 0], axis=-1).astype(jnp.int32),
                  0, width - 1)
    y1 = jnp.clip(jnp.min(corners[..., 1], axis=-1).astype(jnp.int32),
                  0, height - 1)
    x2 = jnp.clip(jnp.max(corners[..., 0], axis=-1).astype(jnp.int32),
                  0, width)
    y2 = jnp.clip(jnp.max(corners[..., 1], axis=-1).astype(jnp.int32),
                  0, height)
    return jnp.stack([x1, y1, x2, y2], axis=-1)


def cheek_roi_from_landmarks(landmarks: jnp.ndarray, cfg: ROIConfig,
                             width: int, height: int) -> jnp.ndarray:
    return roi_from_landmarks(landmarks, cfg.cheek_horizontal, cfg.cheek_top,
                              cfg.cheek_bottom, width, height)


def holdover(box: jnp.ndarray, valid: jnp.ndarray,
             hold_frames: int = 15, carry=None,
             attempted=None) -> BoxTrack:
    """Detection-dropout tolerance as a scan over the time axis.

    Mirrors the reference's reuse rule (``analysis/utils/roi.py:91-101``):
    a detected frame refreshes the box and resets the budget; an undetected
    frame reuses the last box for up to ``hold_frames`` frames; past the
    budget (or before the first detection) the frame is invalid.  (The
    reference's past-budget path also *double-yields* a stale ROI — a known
    desync bug, SURVEY.md §4 item 1 — here the intent, a single invalid
    sample, is implemented.)

    Args:
      box: ``(T, 4)`` int32 raw per-frame detections.
      valid: ``(T,)`` bool detection success.
      carry: optional scan carry from a previous chunk (chunked decode of
        long recordings carries tracking state across chunk boundaries).
      attempted: optional ``(T,)`` bool — frames where detection actually
        ran.  A frame that was *not attempted* (detection cadence
        ``detect_every > 1``) reuses the tracked box WITHOUT draining the
        holdover budget: the budget counts consecutive detection
        *failures*, per the reference's rule, and a skipped frame is not a
        failure.  ``None`` = every frame attempted.
    Returns:
      :class:`BoxTrack` with holdover applied (use
      :func:`holdover_with_carry` to also get the final scan state).
    """
    track, _ = holdover_with_carry(box, valid, hold_frames, carry, attempted)
    return track


def holdover_with_carry(box: jnp.ndarray, valid: jnp.ndarray,
                        hold_frames: int = 15, carry=None, attempted=None):
    """:func:`holdover` variant returning the final scan carry, for chunked
    processing of long recordings (state flows across chunk boundaries)."""
    def step(c, inp):
        last_box, budget, has_last = c
        b, v, att = inp
        new_last = jnp.where(v, b, last_box)
        new_has = jnp.logical_or(v, has_last)
        failed = jnp.logical_and(jnp.logical_not(v), att)
        reuse_ok = jnp.logical_and(failed,
                                   jnp.logical_and(has_last, budget > 0))
        tracked = jnp.logical_and(jnp.logical_not(att), has_last)
        new_budget = jnp.where(v, hold_frames,
                               jnp.where(reuse_ok, budget - 1, budget))
        out_valid = jnp.logical_or(v, jnp.logical_or(reuse_ok, tracked))
        return (new_last, new_budget, new_has), (new_last, out_valid)

    if attempted is None:
        attempted = jnp.ones(valid.shape, bool)
    if carry is None:
        carry = (jnp.zeros((4,), jnp.int32), jnp.int32(0), jnp.asarray(False))
    final, (boxes, valids) = jax.lax.scan(step, carry,
                                          (box, valid, attempted))
    return BoxTrack(box=boxes, valid=valids), final


def holdover_multi(box: jnp.ndarray, valid: jnp.ndarray,
                   hold_frames: int = 15, attempted=None) -> BoxTrack:
    """K-track holdover with identity assignment (multi-subject monitoring).

    Per-frame candidate boxes arrive in arbitrary (or x-sorted) order and
    identity must persist through dropouts — a pure per-frame ordering
    re-numbers the survivors when one face disappears, corrupting every
    track.  This scan keeps K persistent tracks:

    1. greedy nearest-center matching of valid candidates to live tracks
       (K small — a K-step argmin loop, all fixed shapes);
    2. matched tracks refresh their box + holdover budget; unmatched live
       tracks hold their last box for ``hold_frames`` frames (the single-face
       rule, ``analysis/utils/roi.py:91-101``);
    3. still-unmatched candidates claim free slots (never-used or
       budget-expired tracks) left-to-right, so first appearances get
       x-ordered identities.

    Args:
      box: ``(T, K, 4)`` int32 per-frame candidate detections.
      valid: ``(T, K)`` bool.
    Returns:
      :class:`BoxTrack` with ``box (T, K, 4)``, ``valid (T, K)`` — slot k is
      one subject for the whole clip.
    """
    K = box.shape[1]

    def step(carry, inp):
        return holdover_multi_step(carry, inp[0], inp[1], hold_frames,
                                   attempted=inp[2])

    if attempted is None:
        attempted = jnp.ones((box.shape[0],), bool)
    _, (boxes, valids) = jax.lax.scan(step, init_multi_carry(K),
                                      (box, valid, attempted))
    return BoxTrack(box=boxes, valid=valids)


def init_multi_carry(k_faces: int):
    """Zeroed K-track carry for :func:`holdover_multi_step`."""
    return (jnp.zeros((k_faces, 4), jnp.int32),
            jnp.zeros((k_faces,), jnp.int32),
            jnp.zeros((k_faces,), bool))


def holdover_multi_step(carry, cand: jnp.ndarray, cval: jnp.ndarray,
                        hold_frames: int = 15, attempted=True):
    """One frame of the K-track identity-matched holdover.

    Shared by the offline scan (:func:`holdover_multi`) and the live
    multi-face step (``pipeline.live.step_multi``), so both paths track
    identity with bit-identical semantics.

    Args:
      carry: ``(last (K, 4), budget (K,), has (K,))``.
      cand/cval: this frame's ``(K, 4)`` candidates and ``(K,)`` validity.
      attempted: scalar bool — detection ran this frame.  ``False``
        (detection cadence) holds every live track without matching,
        budget drain, or slot claiming (the single-face ``attempted``
        semantics, :func:`holdover`).
    Returns:
      ``(new_carry, (boxes (K, 4), valid (K,)))``.
    """
    K = cand.shape[0]
    INF = jnp.float32(1e9)

    def centers(b):
        bf = b.astype(jnp.float32)
        return (bf[..., 0] + bf[..., 2]) * 0.5, (bf[..., 1] + bf[..., 3]) * 0.5

    last, budget, has = carry                 # (K,4), (K,), (K,)
    tx, ty = centers(last)
    cx, cy = centers(cand)
    cost = (jnp.abs(tx[:, None] - cx[None, :])
            + jnp.abs(ty[:, None] - cy[None, :]))
    cost = jnp.where(jnp.logical_and(has[:, None], cval[None, :]),
                     cost, INF)

    def match(i, st):
        assign, avail_t, avail_c = st
        masked = jnp.where(
            jnp.logical_and(avail_t[:, None], avail_c[None, :]),
            cost, INF)
        flat = jnp.argmin(masked.reshape(-1))
        ti, ci = flat // K, flat % K
        ok = masked.reshape(-1)[flat] < INF
        assign = jnp.where(ok, assign.at[ti].set(ci.astype(jnp.int32)),
                           assign)
        avail_t = jnp.logical_and(
            avail_t, ~jnp.logical_and(jnp.arange(K) == ti, ok))
        avail_c = jnp.logical_and(
            avail_c, ~jnp.logical_and(jnp.arange(K) == ci, ok))
        return assign, avail_t, avail_c

    assign, _, avail_c = jax.lax.fori_loop(
        0, K, match, (jnp.full((K,), -1, jnp.int32), has, cval))
    got = assign >= 0

    # New subjects claim free slots (never used, or holdover expired),
    # leftmost candidate -> lowest free slot.
    unmatched = jnp.logical_and(cval, avail_c)
    free = jnp.logical_and(~got, jnp.logical_or(~has, budget <= 0))
    cand_order = jnp.argsort(jnp.where(unmatched, cx, INF))
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    n_new = jnp.sum(unmatched.astype(jnp.int32))
    seed = jnp.logical_and(free, free_rank < n_new)
    cidx = cand_order[jnp.clip(free_rank, 0, K - 1)]
    assign = jnp.where(seed, cidx.astype(jnp.int32), assign)
    got = assign >= 0

    a = jnp.clip(assign, 0, K - 1)
    new_last = jnp.where(got[:, None], cand[a], last)
    reuse = jnp.logical_and(~got,
                            jnp.logical_and(has, budget > 0))
    new_budget = jnp.where(got, hold_frames,
                           jnp.where(reuse, budget - 1, budget))
    new_has = jnp.logical_or(got, has)
    out_valid = jnp.logical_or(got, reuse)

    # Not-attempted frame (detection cadence): pure tracking — every live
    # track holds its box and budget; the matching above is discarded.
    att = jnp.asarray(attempted, bool)
    new_last = jnp.where(att, new_last, last)
    new_budget = jnp.where(att, new_budget, budget)
    new_has = jnp.where(att, new_has, has)
    out_valid = jnp.where(att, out_valid, has)
    return ((new_last, new_budget, new_has), (new_last, out_valid))
