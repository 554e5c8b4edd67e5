"""The reference's production face pipeline, as batched JAX.

Ports the *weights* of MediaPipe's ``face_landmarker.task`` (BlazeFace
short-range detector + 478-point face-mesh landmarks) into JAX via the
first-party TFLite reader (:mod:`vhr_tpu.models.tflite`), and re-implements
the surrounding graph logic — SSD anchor generation, box decode, weighted
NMS, rotated square ROI, 256x256 crop sampling and landmark re-projection —
as batched, jit-compatible array code.

Reference consumers: ``/root/reference/analysis/utils/roi.py:70-110``
(FaceLandmarker VIDEO mode -> landmarks -> min/max bbox -> cheek ROI) and
``/root/reference/rppg_VIDEO.py:25-46,380``.  Graph-parameter provenance
(public MediaPipe graph configs, transcribed constants):

* face detector: input 128x128 RGB in [-1, 1], letterboxed; SSD anchors
  num_layers=4, strides [8,16,16,16], min/max scale 0.1484375/0.75,
  aspect 1.0 + interpolated, fixed_anchor_size (=> only centers matter:
  16x16x2 + 8x8x6 = 896); decode scales x=y=w=h=128, 6 keypoints,
  sigmoid scores clipped at +-100, min score 0.5; weighted NMS at IoU 0.3.
* landmarks: ROI = detection box rotated so the eye keypoints are level
  (kp0 -> kp1, target angle 0), scaled 1.5x, long-side square; input
  256x256 RGB in [0, 1]; outputs 478 xyz landmarks in crop pixels and a
  face-presence logit (sigmoid -> min_face_presence_confidence 0.5).

Shape: all T frames run the conv nets as one batch, the per-frame
NMS/crop logic is vmapped, and the whole detector is exposed as a
``jax.tree_util.Partial`` so weights stay traced arguments.

Crop modes: ``crop_mode="axis"`` (default) samples the mesh-net crop
axis-aligned as two separable interp-matrix products
(:func:`_crop_axis_mxu` — <1 px landmark delta at 10 deg roll,
docs/DETECTION.md); ``"exact"`` keeps MediaPipe's rotated
bilinear sampling via the packed-tap gather.  The detector's eye-line
roll is still used by :func:`make_mediapipe_roi_detector` to carve
pose-robust cheek ROIs in the rolled face frame.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["blazeface_anchors", "load_face_models", "detect_faces_mp",
           "face_landmarks", "make_mediapipe_detector",
           "make_mediapipe_detector_multi", "make_mediapipe_roi_detector",
           "make_mediapipe_poly_detector", "default_task_path",
           "MediaPipeFaceParams"]

_MIN_DET_SCORE = 0.5          # TensorsToDetections min_score_thresh
_NMS_IOU = 0.3                # min_suppression_threshold
_ROI_SCALE = 1.5              # RectTransformation scale_x/scale_y
_MIN_PRESENCE = 0.5           # min_face_presence_confidence
_DET_SIZE = 128
_LM_SIZE = 256


def default_task_path() -> str:
    """The bundled model asset (repo copy of the reference's .task zip)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ours = os.path.join(os.path.dirname(here), "checkpoints",
                        "face_landmarker.task")
    if os.path.exists(ours):
        return ours
    return "/root/reference/face_landmarker.task"


def blazeface_anchors() -> np.ndarray:
    """(896, 2) anchor centers (x, y), normalized to the 128px square.

    SsdAnchorsCalculator with fixed_anchor_size=true: every anchor is unit
    sized, so only the center grid survives — 2 anchors per cell on the
    stride-8 16x16 map, 6 per cell on the merged stride-16 8x8 maps.
    """
    out = []
    for fm, per_cell in ((16, 2), (8, 6)):
        for y in range(fm):
            for x in range(fm):
                cx, cy = (x + 0.5) / fm, (y + 0.5) / fm
                out.extend([(cx, cy)] * per_cell)
    a = np.asarray(out, np.float32)
    assert a.shape == (896, 2)
    return a


class MediaPipeFaceParams(NamedTuple):
    det: dict                 # BlazeFace conv weights (tensor-idx -> array)
    lm: dict                  # face-mesh conv weights


_CACHE = {}


def load_face_models(task_path: Optional[str] = None, compute_dtype=None,
                     activation_dtype=None):
    """Parse the .task zip once -> (params pytree, det apply, lm apply).

    ``compute_dtype=jnp.bfloat16`` runs both conv nets' convolutions in
    bf16 (f32 accumulate; see :func:`vhr_tpu.models.tflite_exec.build_jax`
    for the precision of each mode).  ``activation_dtype=jnp.bfloat16``
    additionally stores the feature maps in bf16 — these nets move far
    more bytes of feature maps than of weights (the mesh graph holds ~90 MB
    of f32 feature maps per frame), so this is the mode that halves their
    traffic; landmark RMS delta vs f32 is pinned in
    tests/test_mediapipe_face.py.
    """
    task_path = task_path or default_task_path()
    key = (task_path,
           np.dtype(compute_dtype).name if compute_dtype else None,
           np.dtype(activation_dtype).name if activation_dtype else None)
    if key in _CACHE:
        return _CACHE[key]
    from .tflite import load_task_models
    from .tflite_exec import build_jax
    models = load_task_models(task_path)
    det_params, det_apply = build_jax(models["face_detector.tflite"].graph,
                                      compute_dtype=compute_dtype,
                                      activation_dtype=activation_dtype)
    lm_params, lm_apply = build_jax(
        models["face_landmarks_detector.tflite"].graph,
        compute_dtype=compute_dtype, activation_dtype=activation_dtype)
    # In the bf16-activation mode, letterbox/crops interchange in bf16 too
    # (the net stores bf16 feature maps anyway; the full-res input casts
    # are the pre-net stages' dominant memory term — detect_faces_mp /
    # face_landmarks read this tag).
    det_apply.io_dtype = activation_dtype
    lm_apply.io_dtype = activation_dtype
    params = MediaPipeFaceParams(det=det_params, lm=lm_params)
    _CACHE[key] = (params, det_apply, lm_apply)
    return _CACHE[key]


# --- detector stage ---------------------------------------------------------

def _letterbox_geometry(H: int, W: int, size: int):
    """Static (Python-time) keep-aspect letterbox: scale + centered pads."""
    scale = size / max(H, W)
    h2, w2 = int(round(H * scale)), int(round(W * scale))
    pad_y, pad_x = (size - h2) // 2, (size - w2) // 2
    return scale, h2, w2, pad_x, pad_y


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) matrix equal to ``jax.image.resize('bilinear')``
    along one axis, INCLUDING its antialiasing triangle kernel on
    downscale.  resize is linear per axis, so the matrix is just resize
    applied to the identity — here written out in pure numpy (a mirror of
    ``jax._src.image.scale.compute_weight_mat`` with translation=0,
    antialias=True, triangle kernel) so the cache fill stays host-side
    even when the first call happens inside a jit/shard_map trace
    (omnistaging would stage a ``jax.image.resize`` call and the
    ``np.asarray`` would see a tracer).  Pinned equal to
    ``jax.image.resize`` in tests/test_mediapipe_face.py."""
    scale = n_dst / n_src
    kernel_scale = max(1.0 / scale, 1.0)                 # antialias dilation
    sample_f = (np.arange(n_dst) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_src)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)                         # triangle kernel
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample_f >= -0.5) & (sample_f <= n_src - 0.5))[None, :],
                 w, 0.0)
    return np.asarray(w, np.float32).T


def _letterbox(frames_bgr_u8: jnp.ndarray, size: int, lo: float, hi: float,
               dtype=jnp.float32):
    """(T, H, W, 3) BGR u8 -> (T, size, size, 3) RGB in [lo, hi].

    ``dtype=jnp.bfloat16`` (the bf16-activation pipeline) casts the frame
    ONCE to bf16 instead of f32 before the interp products — the
    full-resolution cast may be a materialized tensor (the dot can't read
    u8), so halving it halves this stage's dominant traffic term.  u8
    values are exact in bf16; the interp weights round to 2^-9 — the same
    ~1 LSB bound as the bf16 crop (docstring at _crop_axis_mxu).  In the
    f32 mode the products run at XLA's default precision (TF32 on an
    NVIDIA GPU), a bound of the same order.

    The resize runs as two separable interp-matrix products straight off
    the u8 input (the ``_crop_axis_mxu`` trick) instead of
    ``jax.image.resize`` on a pre-materialized f32 frame, so the u8 frame
    is read once and the intermediates are already 128 wide.  Values
    match ``jax.image.resize('bilinear')`` (antialiased) to
    matmul-reassociation tolerance (tests/test_mediapipe_face.py)."""
    T, H, W, _ = frames_bgr_u8.shape
    scale, h2, w2, pad_x, pad_y = _letterbox_geometry(H, W, size)
    ax = jnp.asarray(_resize_matrix(W, w2), dtype)       # (w2, W)
    ay = jnp.asarray(_resize_matrix(H, h2), dtype)       # (h2, H)
    # BGR->RGB AFTER the resize, on the (T, h2, w2, 3) sliver: resize is
    # channel-wise, so flipping the small output is bit-identical math and
    # touches 3 channels of a 128x128 canvas instead of the full frame.
    bgr = frames_bgr_u8.astype(dtype)
    tmp = jnp.einsum("thwc,mw->thmc", bgr, ax)           # x-pass (T,H,w2,3)
    small = jnp.einsum("nh,thmc->tnmc", ay, tmp)[..., ::-1]   # (T,h2,w2,3)
    canvas = jnp.zeros((T, size, size, 3), dtype)
    canvas = jax.lax.dynamic_update_slice(canvas, small, (0, pad_y, pad_x, 0))
    return canvas * jnp.asarray((hi - lo) / 255.0, dtype) + jnp.asarray(
        lo, dtype)


def _decode_detections(reg: jnp.ndarray, cls: jnp.ndarray,
                       anchors: jnp.ndarray):
    """Raw SSD outputs -> (boxes x1y1x2y2, scores, keypoints), letterbox-
    normalized.  reg (T, 896, 16): [cx, cy, w, h, 6x(kx, ky)] each /128
    relative to its (unit-size) anchor center."""
    s = 1.0 / _DET_SIZE
    cxy = reg[..., 0:2] * s + anchors                    # (T, 896, 2)
    wh = reg[..., 2:4] * s
    half = wh * 0.5
    boxes = jnp.concatenate([cxy - half, cxy + half], axis=-1)
    kps = reg[..., 4:16].reshape(reg.shape[:-1] + (6, 2)) * s \
        + anchors[..., None, :]
    scores = jax.nn.sigmoid(jnp.clip(cls[..., 0], -100.0, 100.0))
    return boxes, scores, kps


def _iou_one_vs_all(box: jnp.ndarray, boxes: jnp.ndarray) -> jnp.ndarray:
    lt = jnp.maximum(box[:2], boxes[:, :2])
    rb = jnp.minimum(box[2:], boxes[:, 2:])
    inter = jnp.prod(jnp.maximum(rb - lt, 0.0), axis=-1)
    a = jnp.prod(jnp.maximum(box[2:] - box[:2], 0.0))
    b = jnp.prod(jnp.maximum(boxes[:, 2:] - boxes[:, :2], 0.0), axis=-1)
    return inter / jnp.maximum(a + b - inter, 1e-9)


def _weighted_nms(boxes, scores, kps, k_faces: int,
                  min_score: float = _MIN_DET_SCORE,
                  iou_thresh: float = _NMS_IOU):
    """MediaPipe WEIGHTED NonMaxSuppression, vectorized, static top-K.

    Per slot: take the highest-scoring remaining candidate, blend every
    remaining candidate with IoU >= threshold into it (score-weighted box
    and keypoints), retire them.  One frame: boxes (A, 4), scores (A,),
    kps (A, 6, 2) -> (K, 4), (K,), (K, 6, 2).
    """
    def slot(carry, _):
        remaining = carry
        masked = jnp.where(remaining, scores, -jnp.inf)
        i = jnp.argmax(masked)
        top = masked[i]
        ok = top >= min_score
        sim = jnp.logical_and(remaining,
                              _iou_one_vs_all(boxes[i], boxes) >= iou_thresh)
        w = jnp.where(sim, scores, 0.0)[:, None]
        wsum = jnp.maximum(jnp.sum(w), 1e-9)
        blend_box = jnp.sum(boxes * w, axis=0) / wsum
        blend_kps = jnp.sum(kps * w[..., None], axis=0) / wsum
        remaining = jnp.logical_and(remaining, ~sim)
        return remaining, (blend_box, top, blend_kps, ok)

    init = scores >= min_score
    _, (b, s, kp, ok) = jax.lax.scan(slot, init, None, length=k_faces)
    return b, s, kp, ok


class _Rect(NamedTuple):
    cx: jnp.ndarray           # image px
    cy: jnp.ndarray
    side: jnp.ndarray         # square side, image px
    rot: jnp.ndarray          # radians


def _detection_to_rect(box, kps, H: int, W: int) -> _Rect:
    """Letterbox-normalized detection -> rotated square ROI in image px.

    DetectionsToRects (rotation: kp0 -> kp1 levelled to 0 deg) +
    RectTransformation (scale 1.5, square_long).
    """
    scale, h2, w2, pad_x, pad_y = _letterbox_geometry(H, W, _DET_SIZE)
    to_px = lambda p: ((p[..., 0] * _DET_SIZE - pad_x) / scale,
                       (p[..., 1] * _DET_SIZE - pad_y) / scale)
    x1, y1 = to_px(box[..., 0:2])
    x2, y2 = to_px(box[..., 2:4])
    kx, ky = to_px(kps)                                  # (..., 6)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    rot = -jnp.arctan2(-(ky[..., 1] - ky[..., 0]),
                       kx[..., 1] - kx[..., 0])
    side = jnp.maximum(x2 - x1, y2 - y1) * _ROI_SCALE
    return _Rect(cx=cx, cy=cy, side=side, rot=rot)


def _pack_taps(img_rgb_f32: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) f32 -> (H-1, W-1, 12) with each pixel's 2x2 bilinear-tap
    neighborhood packed into channels: [p(y,x), p(y,x+1), p(y+1,x),
    p(y+1,x+1)].

    Why: a gather pays per gathered *position* more than per byte, so
    packing the four taps into channels lets the rotated-crop gather fetch
    all of them in ONE position per output pixel -- 65k positions instead
    of 262k.  The pack is stored bf16 (halves gather bandwidth) which is
    lossless for u8 pixel values (integers <= 256 are exact in bf16); taps
    are cast back to f32 before the lerp, so the result stays bit-exact vs
    ``_crop_rotated_ref``.
    """
    img = img_rgb_f32.astype(jnp.bfloat16)
    a = jnp.concatenate([img[:, :-1], img[:, 1:]], axis=-1)
    packed = jnp.concatenate([a[:-1], a[1:]], axis=-1)
    # Barrier: force the packed array to materialize.  Without it XLA can
    # fuse the concats back into the gather, recreating the slow
    # multi-position form this packing exists to avoid.
    return jax.lax.optimization_barrier(packed)


def _crop_rotated_from_taps(packed: jnp.ndarray, H: int, W: int,
                            rect: _Rect, size: int):
    """Bilinear-sample a rotated square rect from a ``_pack_taps`` array ->
    (size, size, 3) RGB [0, 1].  Bit-exact vs the direct 4-gather
    formulation (``_crop_rotated_ref``): the gathered values are exact
    pixel copies and the lerp arithmetic is identical; frame-edge taps
    (where the reference clamps x1/y1 onto x0/y0) are reproduced with
    selects on the clipped indices."""
    u = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size - 0.5
    uu, vv = jnp.meshgrid(u, u)                          # (size, size) x, y
    c, s = jnp.cos(rect.rot), jnp.sin(rect.rot)
    xs = rect.cx + (uu * c - vv * s) * rect.side
    ys = rect.cy + (uu * s + vv * c) * rect.side
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    # Explicit gather with uncollapsed size-1 slice dims + CLIP mode (no
    # out-of-bounds fill select, unlike jnp __getitem__).
    idx = jnp.stack([jnp.minimum(y0i, H - 2).ravel(),
                     jnp.minimum(x0i, W - 2).ravel()], axis=-1)
    g = jax.lax.gather(
        packed, idx,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3), collapsed_slice_dims=(),
            start_index_map=(0, 1)),
        slice_sizes=(1, 1, 12),
        mode=jax.lax.GatherScatterMode.CLIP)
    g = g.reshape(size, size, 12).astype(jnp.float32)
    A, B = g[..., 0:3], g[..., 3:6]     # row y  : x, x+1
    C, D = g[..., 6:9], g[..., 9:12]    # row y+1: x, x+1
    x_edge = (x0i == W - 1)[..., None]
    y_edge = (y0i == H - 1)[..., None]
    a = jnp.where(x_edge, B, A)
    cc = jnp.where(x_edge, D, C)
    p00 = jnp.where(y_edge, cc, a)
    p01 = jnp.where(y_edge, D, B)
    p10, p11 = cc, D
    top = p00 * (1 - fx[..., None]) + p01 * fx[..., None]
    bot = p10 * (1 - fx[..., None]) + p11 * fx[..., None]
    out = top * (1 - fy[..., None]) + bot * fy[..., None]
    return out / 255.0


def _crop_rotated(frame_bgr_u8: jnp.ndarray, rect: _Rect, size: int):
    """Bilinear-sample a rotated square rect -> (size, size, 3) RGB [0,1]."""
    H, W, _ = frame_bgr_u8.shape
    packed = _pack_taps(frame_bgr_u8[..., ::-1].astype(jnp.float32))
    return _crop_rotated_from_taps(packed, H, W, rect, size)


def _crop_rotated_ref(frame_bgr_u8: jnp.ndarray, rect: _Rect, size: int):
    """Direct 4-gather reference formulation (test oracle for the packed
    fast path, kept for parity tests only)."""
    H, W, _ = frame_bgr_u8.shape
    img = frame_bgr_u8[..., ::-1].astype(jnp.float32)
    u = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size - 0.5
    uu, vv = jnp.meshgrid(u, u)                          # (size, size) x, y
    c, s = jnp.cos(rect.rot), jnp.sin(rect.rot)
    xs = rect.cx + (uu * c - vv * s) * rect.side
    ys = rect.cy + (uu * s + vv * c) * rect.side
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)
    p00, p01 = img[y0i, x0i], img[y0i, x1i]
    p10, p11 = img[y1i, x0i], img[y1i, x1i]
    top = p00 * (1 - fx[..., None]) + p01 * fx[..., None]
    bot = p10 * (1 - fx[..., None]) + p11 * fx[..., None]
    out = top * (1 - fy[..., None]) + bot * fy[..., None]
    return out / 255.0


def _interp_matrix(coords: jnp.ndarray, n_src: int) -> jnp.ndarray:
    """(n_out,) f32 sample coordinates -> (n_out, n_src) bilinear
    interpolation matrix with ``_crop_rotated_ref``'s edge-clamp
    semantics (clip the floor tap into range, second tap = clip(+1))."""
    x0 = jnp.floor(coords)
    f = coords - x0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, n_src - 1)
    x1i = jnp.clip(x0i + 1, 0, n_src - 1)
    src = jnp.arange(n_src, dtype=jnp.int32)[None, :]
    return ((1.0 - f)[:, None] * (src == x0i[:, None])
            + f[:, None] * (src == x1i[:, None]))


def _crop_axis_mxu(frame_bgr_u8: jnp.ndarray, rect: _Rect, size: int,
                   dtype=jnp.float32):
    """Axis-aligned bilinear crop as two matmuls (rect.rot ignored) ->
    (size, size, 3) RGB [0, 1] in ``dtype``.

    ``dtype=jnp.bfloat16``: the full-frame cast feeding the x-pass is this
    stage's dominant memory term; bf16 halves it AND feeds the
    bf16-activation mesh net its input dtype directly (no second cast).

    An axis-aligned crop is separable, so it runs as two dense
    interp-matrix products instead of a per-output-pixel gather.
    Fidelity: the mesh net tolerates in-crop roll (measured on the
    real-portrait corpus: mean landmark deviation vs the exact rotated
    crop is <1 px up to 10 deg, 2.2 px at 20 deg, landmark-bbox IoU >=0.98
    through 20 deg), so ``crop_mode="axis"`` is the product path and
    ``"exact"`` keeps the gather for MediaPipe-exact sampling at large
    rolls.

    Matmuls run at DEFAULT precision (bf16 inputs in the product mode;
    TF32 on an NVIDIA GPU in the f32 mode): u8 pixel values are exact in
    bf16 and the interp weights round to 2^-9, bounding the output error
    at ~1 u8 LSB — pinned by the tolerance test vs
    ``_crop_rotated_ref(rot=0)``.
    """
    H, W, _ = frame_bgr_u8.shape
    u = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size - 0.5
    gx = _interp_matrix(rect.cx + u * rect.side, W).astype(dtype)  # (size,W)
    gy = _interp_matrix(rect.cy + u * rect.side, H).astype(dtype)  # (size,H)
    # Channel reverse AFTER the products, on the small output (see
    # _letterbox).
    img = frame_bgr_u8.astype(dtype)
    tmp = jnp.einsum("hwc,mw->hmc", img, gx)             # x-pass (H, size, 3)
    out = jnp.einsum("nh,hmc->nmc", gy, tmp)[..., ::-1]  # y-pass, BGR->RGB
    return out / jnp.asarray(255.0, dtype)


def _project_landmarks(lm_crop: jnp.ndarray, rect: _Rect) -> jnp.ndarray:
    """Crop-pixel landmarks (478, 3) -> image-pixel (x, y) (478, 2)."""
    u = lm_crop[..., 0] / _LM_SIZE - 0.5
    v = lm_crop[..., 1] / _LM_SIZE - 0.5
    c, s = jnp.cos(rect.rot), jnp.sin(rect.rot)
    x = rect.cx + (u * c - v * s) * rect.side
    y = rect.cy + (u * s + v * c) * rect.side
    return jnp.stack([x, y], axis=-1)


# --- public stages ----------------------------------------------------------

def detect_faces_mp(params: MediaPipeFaceParams, det_apply, frames,
                    k_faces: int = 1):
    """BlazeFace over a frame batch: (T, H, W, 3) BGR u8 ->
    (rects, scores (T, K), ok (T, K)) — rotated square ROIs in image px."""
    T, H, W, _ = frames.shape
    # bf16 interchange when the net stores bf16 activations anyway
    # (load_face_models tags the apply): halves the full-res cast traffic.
    io = getattr(det_apply, "io_dtype", None) or jnp.float32
    x = _letterbox(frames, _DET_SIZE, -1.0, 1.0, dtype=io)
    # One flat (T, ...) batch through the conv net — build_jax reshapes
    # are batch-agnostic, so no vmap of a batch-1 apply is needed.
    reg, cls = det_apply(params.det, x)                  # (T,896,16),(T,896,1)
    anchors = jnp.asarray(blazeface_anchors())
    boxes, scores, kps = _decode_detections(reg, cls, anchors)
    b, s, kp, ok = jax.vmap(
        functools.partial(_weighted_nms, k_faces=k_faces))(boxes, scores, kps)
    rects = _detection_to_rect(b, kp, H, W)              # fields (T, K)
    return rects, s, ok


_CROP_BLOCK = 16      # frames per packed-tap block: bounds the (blk, H-1,
#                       W-1, 12) f32 intermediate to ~0.7 GB at 1080p


def _crop_faces(frames: jnp.ndarray, rects: _Rect, size: int,
                mode: str = "exact", dtype=jnp.float32):
    """(T, H, W, 3) BGR u8 + rects with (T, K) fields -> (T, K, size,
    size, 3) RGB [0, 1] crops, blocking over T to bound intermediate
    memory.  ``mode="exact"``: rotated bilinear sampling via the packed
    -tap gather (one packed array per frame shared across the K faces).
    ``mode="axis"``: axis-aligned separable matmul crop (``_crop_axis_mxu``;
    rect.rot must already be zeroed by the caller so projection agrees)."""
    T, H, W, _ = frames.shape
    K = rects.cx.shape[-1]

    def crop_block(args):
        fr, rk = args

        if mode == "axis":
            def crop_one(frame, rect_k):
                return jax.vmap(lambda r: _crop_axis_mxu(
                    frame, r, size, dtype=dtype))(rect_k)
        else:
            def crop_one(frame, rect_k):
                packed = _pack_taps(frame[..., ::-1].astype(jnp.float32))
                return jax.vmap(lambda r: _crop_rotated_from_taps(
                    packed, H, W, r, size))(rect_k)

        return jax.vmap(crop_one)(fr, rk)

    rects_tk = jax.tree.map(lambda a: a.reshape(T, K), rects)
    # Blocking exists to bound the exact mode's (blk, H-1, W-1, 12) packed
    # -tap intermediate; the axis mode's intermediates are (H, size, 3)
    # slivers, so it runs the whole batch in one vmap (lax.map's
    # sequential blocks serialized the T=256 pipeline for nothing).
    if T <= _CROP_BLOCK or mode == "axis":
        return crop_block((frames, rects_tk))
    pad = (-T) % _CROP_BLOCK
    fr = jnp.pad(frames, ((0, pad), (0, 0), (0, 0), (0, 0)))
    rk = jax.tree.map(
        lambda a: jnp.pad(a, ((0, pad), (0, 0))), rects_tk)
    nb = (T + pad) // _CROP_BLOCK
    out = jax.lax.map(crop_block, (
        fr.reshape(nb, _CROP_BLOCK, H, W, 3),
        jax.tree.map(lambda a: a.reshape(nb, _CROP_BLOCK, K), rk)))
    return out.reshape(nb * _CROP_BLOCK, K, size, size, 3)[:T]


def face_landmarks(params: MediaPipeFaceParams, lm_apply, frames, rects,
                   crop_mode: str = "axis"):
    """Face-mesh over per-frame rects: -> (landmarks_px (T, K, 478, 2),
    presence (T, K)).  ``crop_mode="axis"`` (product default) feeds the
    mesh an unrotated crop — the ROI rotation is dropped consistently
    from both sampling and re-projection, trading <1 px landmark
    deviation at typical rolls (see ``_crop_axis_mxu``) for a dense
    product in place of a gather; ``"exact"`` keeps MediaPipe's rotated
    sampling."""
    if crop_mode == "axis":
        rects = rects._replace(rot=jnp.zeros_like(rects.rot))
    T = frames.shape[0]
    K = rects.cx.shape[-1]
    io = getattr(lm_apply, "io_dtype", None) or jnp.float32
    crops = _crop_faces(frames, rects, _LM_SIZE, mode=crop_mode,
                        dtype=io)                        # (T, K, 256, 256, 3)
    flat = crops.reshape(T * K, _LM_SIZE, _LM_SIZE, 3)
    out = lm_apply(params.lm, flat)                      # flat batch (no vmap)
    lm = out[0].reshape(T, K, 478, 3)
    presence = jax.nn.sigmoid(out[1].reshape(T, K))
    flat_rects = jax.tree.map(lambda a: a.reshape(T, K), rects)
    lm_px = jax.vmap(jax.vmap(_project_landmarks))(lm, flat_rects)
    return lm_px, presence


def _landmarks_to_bbox(lm_px: jnp.ndarray, H: int, W: int) -> jnp.ndarray:
    """Landmark cloud -> int bbox, the reference's `_bbox_from_landmarks`
    (analysis/utils/roi.py:43-51): min/max over all points, clipped."""
    x1 = jnp.clip(jnp.min(lm_px[..., 0], axis=-1), 0, W - 1)
    y1 = jnp.clip(jnp.min(lm_px[..., 1], axis=-1), 0, H - 1)
    x2 = jnp.clip(jnp.max(lm_px[..., 0], axis=-1), 0, W - 1)
    y2 = jnp.clip(jnp.max(lm_px[..., 1], axis=-1), 0, H - 1)
    return jnp.stack([x1, y1, x2, y2], axis=-1).astype(jnp.int32)


def _detect_single(params: MediaPipeFaceParams, det_apply, lm_apply,
                   frames: jnp.ndarray, crop_mode: str = "axis"):
    T, H, W, _ = frames.shape
    rects, _, det_ok = detect_faces_mp(params, det_apply, frames, k_faces=1)
    lm_px, presence = face_landmarks(params, lm_apply, frames, rects,
                                     crop_mode=crop_mode)
    boxes = _landmarks_to_bbox(lm_px[:, 0], H, W)
    valid = jnp.logical_and(det_ok[:, 0], presence[:, 0] >= _MIN_PRESENCE)
    boxes = jnp.where(valid[:, None], boxes, 0)
    return boxes, valid


def _detect_multi(params: MediaPipeFaceParams, det_apply, lm_apply,
                  k_faces: int, frames: jnp.ndarray,
                  crop_mode: str = "axis"):
    T, H, W, _ = frames.shape
    rects, _, det_ok = detect_faces_mp(params, det_apply, frames,
                                       k_faces=k_faces)
    lm_px, presence = face_landmarks(params, lm_apply, frames, rects,
                                     crop_mode=crop_mode)
    boxes = _landmarks_to_bbox(lm_px, H, W)              # (T, K, 4)
    valid = jnp.logical_and(det_ok, presence >= _MIN_PRESENCE)
    # Stable x-order identity, matching multiface.detect_faces_multi.
    sort_key = jnp.where(valid, boxes[..., 0], W + 1)
    order = jnp.argsort(sort_key, axis=1)
    boxes = jnp.take_along_axis(boxes, order[..., None], axis=1)
    valid = jnp.take_along_axis(valid, order, axis=1)
    boxes = jnp.where(valid[..., None], boxes, 0)
    return boxes, valid


def _rotated_cheek_roi(lm_px: jnp.ndarray, rot: jnp.ndarray,
                       horizontal: float, top: float, bottom: float,
                       W: int, H: int) -> jnp.ndarray:
    """Cheek ROI carved in the face's OWN (rolled) frame.

    The reference applies its cheek ratios to the axis-aligned landmark
    min/max box (``analysis/utils/roi.py:53-59``), so under head roll the
    interior rectangle drifts off the cheeks.  Here the same ratios are
    applied in the frame defined by the detector's eye-line roll ``rot``
    (the angle MediaPipe itself uses to orient the mesh crop): project
    the landmark cloud into that frame, take its min/max box, carve the
    ratio rectangle there, rotate the four corners back, and return their
    axis-aligned bounding box — identical to the reference's ROI for an
    upright face, tracking the rotated cheek band otherwise (the
    production-weights counterpart of ``ops.roi.roi_from_landmarks``).

    Args: ``lm_px (..., 478, 2)`` pixel landmarks, ``rot (...,)`` radians.
    Returns ``(..., 4)`` int32 ``[x1, y1, x2, y2]``.
    """
    c, s = jnp.cos(rot), jnp.sin(rot)
    # Rotate by -rot into the face frame.
    px = lm_px[..., 0] * c[..., None] + lm_px[..., 1] * s[..., None]
    py = -lm_px[..., 0] * s[..., None] + lm_px[..., 1] * c[..., None]
    x1, x2 = jnp.min(px, axis=-1), jnp.max(px, axis=-1)
    y1, y2 = jnp.min(py, axis=-1), jnp.max(py, axis=-1)
    w, h = x2 - x1, y2 - y1
    lx1 = x1 + horizontal * w
    lx2 = x2 - horizontal * w
    ly1 = y1 + top * h
    ly2 = y1 + bottom * h
    corners_local = jnp.stack(
        [jnp.stack([lx1, ly1], -1), jnp.stack([lx2, ly1], -1),
         jnp.stack([lx1, ly2], -1), jnp.stack([lx2, ly2], -1)], axis=-2)
    # Rotate corners back into image coordinates (+rot).
    qx = (corners_local[..., 0] * c[..., None]
          - corners_local[..., 1] * s[..., None])
    qy = (corners_local[..., 0] * s[..., None]
          + corners_local[..., 1] * c[..., None])
    rx1 = jnp.clip(jnp.min(qx, axis=-1).astype(jnp.int32), 0, W - 1)
    ry1 = jnp.clip(jnp.min(qy, axis=-1).astype(jnp.int32), 0, H - 1)
    rx2 = jnp.clip(jnp.max(qx, axis=-1).astype(jnp.int32), 0, W)
    ry2 = jnp.clip(jnp.max(qy, axis=-1).astype(jnp.int32), 0, H)
    return jnp.stack([rx1, ry1, rx2, ry2], axis=-1)


def _detect_single_roi(params: MediaPipeFaceParams, det_apply, lm_apply,
                       frames: jnp.ndarray, roi_ratios,
                       crop_mode: str = "axis"):
    T, H, W, _ = frames.shape
    rects, _, det_ok = detect_faces_mp(params, det_apply, frames, k_faces=1)
    lm_px, presence = face_landmarks(params, lm_apply, frames, rects,
                                     crop_mode=crop_mode)
    boxes = _landmarks_to_bbox(lm_px[:, 0], H, W)
    horizontal, top, bottom = roi_ratios
    rois = _rotated_cheek_roi(lm_px[:, 0], rects.rot[:, 0],
                              horizontal, top, bottom, W, H)
    valid = jnp.logical_and(det_ok[:, 0], presence[:, 0] >= _MIN_PRESENCE)
    boxes = jnp.where(valid[:, None], boxes, 0)
    rois = jnp.where(valid[:, None], rois, 0)
    return boxes, rois, valid


def _detect_single_poly(params: MediaPipeFaceParams, det_apply, lm_apply,
                        frames: jnp.ndarray, poly_idx,
                        crop_mode: str = "axis"):
    T, H, W, _ = frames.shape
    rects, _, det_ok = detect_faces_mp(params, det_apply, frames, k_faces=1)
    lm_px, presence = face_landmarks(params, lm_apply, frames, rects,
                                     crop_mode=crop_mode)
    boxes = _landmarks_to_bbox(lm_px[:, 0], H, W)
    verts = lm_px[:, 0, jnp.asarray(poly_idx, jnp.int32), :]  # (T, E, 2)
    valid = jnp.logical_and(det_ok[:, 0], presence[:, 0] >= _MIN_PRESENCE)
    boxes = jnp.where(valid[:, None], boxes, 0)
    verts = jnp.where(valid[:, None, None], verts, 0.0)
    return boxes, verts, valid


def make_mediapipe_poly_detector(task_path: Optional[str] = None,
                                 compute_dtype=None, crop_mode: str = "axis",
                                 poly_idx=None, activation_dtype="default"):
    """Mesh-polygon variant of :func:`make_mediapipe_detector`:
    ``frames -> (boxes (T, 4), verts (T, E, 2) float32, valid (T,))`` —
    the ``pipeline.offline.extract_signals_polygon`` interface.  ``verts``
    are the pixel positions of the ``poly_idx`` mesh vertices (default
    :data:`vhr_tpu.ops.polyroi.CHEEK_POLY_IDX`, the cheek-band silhouette
    hull), so the measurement region is actual skin that tracks the face
    under pose — beyond the reference's rectangle
    (``analysis/utils/roi.py:53-59``)."""
    from ..ops.polyroi import CHEEK_POLY_IDX

    poly_idx = tuple(poly_idx) if poly_idx is not None else CHEEK_POLY_IDX
    if activation_dtype == "default":
        activation_dtype = jnp.bfloat16        # see make_mediapipe_detector
    params, det_apply, lm_apply = load_face_models(
        task_path, compute_dtype, activation_dtype=activation_dtype)
    fn = functools.partial(_detect_single_poly, det_apply=det_apply,
                           lm_apply=lm_apply, poly_idx=poly_idx,
                           crop_mode=crop_mode)
    return jax.tree_util.Partial(
        lambda p, frames: fn(p, frames=frames), params)


def make_mediapipe_roi_detector(task_path: Optional[str] = None,
                                compute_dtype=None, crop_mode: str = "axis",
                                roi_cfg=None, activation_dtype="default"):
    """Pose-robust ROI variant of :func:`make_mediapipe_detector`:
    ``frames -> (boxes (T, 4), rois (T, 4), valid (T,))`` — the
    ``pipeline.offline.extract_signals_landmark_roi`` interface, with the
    cheek ROI carved in the face's rolled frame (``_rotated_cheek_roi``)
    instead of the axis-aligned bbox interior."""
    from ..config import ROIConfig

    roi_cfg = roi_cfg or ROIConfig()
    ratios = (float(roi_cfg.cheek_horizontal), float(roi_cfg.cheek_top),
              float(roi_cfg.cheek_bottom))
    if activation_dtype == "default":
        activation_dtype = jnp.bfloat16        # see make_mediapipe_detector
    params, det_apply, lm_apply = load_face_models(
        task_path, compute_dtype, activation_dtype=activation_dtype)
    fn = functools.partial(_detect_single_roi, det_apply=det_apply,
                           lm_apply=lm_apply, roi_ratios=ratios,
                           crop_mode=crop_mode)
    return jax.tree_util.Partial(
        lambda p, frames: fn(p, frames=frames), params)


def make_mediapipe_detector(task_path: Optional[str] = None,
                            compute_dtype=None, crop_mode: str = "axis",
                            activation_dtype="default"):
    """The production-weight face detector as a pipeline detector:
    ``frames (T, H, W, 3) u8 -> (boxes (T, 4), valid (T,))`` — drops into
    ``pipeline.offline.extract_signals(detector=...)`` / ``live.step``
    exactly like the learned-landmarker detector.  Boxes are landmark
    min/max, the reference's definition (analysis/utils/roi.py:43-51).
    ``crop_mode``: "axis" (separable matmul crop) or "exact" (MediaPipe's
    rotated bilinear sampling).

    The product default is the **bf16-activation** pipeline: the
    reference's own runtime executes these weights as fp16 TFLite
    kernels, so bf16 storage is precision-comparable to the system being
    reproduced, and it halves the feature-map traffic that dominates
    these nets.  Landmark RMS vs the f32 path is pinned in
    tests/test_mediapipe_face.py; pass ``activation_dtype=None`` for the
    f32-storage path."""
    if activation_dtype == "default":
        activation_dtype = jnp.bfloat16
    params, det_apply, lm_apply = load_face_models(
        task_path, compute_dtype, activation_dtype=activation_dtype)
    fn = functools.partial(_detect_single, det_apply=det_apply,
                           lm_apply=lm_apply, crop_mode=crop_mode)
    return jax.tree_util.Partial(
        lambda p, frames: fn(p, frames=frames), params)


def make_mediapipe_detector_multi(task_path: Optional[str] = None,
                                  k_faces: int = 2, compute_dtype=None,
                                  crop_mode: str = "axis",
                                  activation_dtype="default"):
    """Multi-face variant: ``frames -> (boxes (T, K, 4), valid (T, K))``,
    x-sorted identity — the ``extract_signals_multi`` detector interface."""
    if activation_dtype == "default":
        activation_dtype = jnp.bfloat16        # see make_mediapipe_detector
    params, det_apply, lm_apply = load_face_models(
        task_path, compute_dtype, activation_dtype=activation_dtype)
    fn = functools.partial(_detect_multi, det_apply=det_apply,
                           lm_apply=lm_apply, k_faces=k_faces,
                           crop_mode=crop_mode)
    return jax.tree_util.Partial(
        lambda p, frames: fn(p, frames=frames), params)
