"""Real-face validation corpus from in-image photo assets.

The reference validates on private real videos with ground-truth CSVs
(``/root/reference/analysis/utils/video_io.py:60-77`` reads them).  This
repository carries one real photograph instead: matplotlib's public-domain
sample portrait (``mpl-data/sample_data/grace_hopper.jpg``, a 512x600
frontal portrait), decoded once to ``checkpoints/real_face.npy`` (uint8
BGR) so that loading it needs numpy only.  The ported production detector
(:mod:`vhr_tpu.models.mediapipe_face`) finds it with high confidence.
This module turns that photo into a *measurable* real-face corpus:

* :func:`real_face_image` — the raw BGR photo (``None`` when the asset is
  absent, so consumers can skip gracefully).
* :func:`synthesize_real_face_clip` — animates the photo into an rPPG clip
  with a *known* injected pulse (green-channel modulation inside the face
  region, the same physiology model as :mod:`vhr_tpu.utils.synth`) plus
  optional rigid micro-motion and sensor noise, returning per-frame
  ground-truth face boxes and the BPM truth.

This closes the round-2/3 "the learned detectors have never seen a real
face" measurement gap: detector fidelity on real imagery becomes an IoU
number against :data:`REAL_FACE_BOX` (the production-weight detection,
pinned), and pipeline fidelity becomes BPM recovery of the injected pulse
through ``pipeline.offline`` with ``--detector mediapipe``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["real_face_image", "REAL_FACE_BOX", "RealFaceClip",
           "synthesize_real_face_clip"]

# The committed decode of the portrait (uint8 BGR, numpy only).
_ASSET_NPY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "checkpoints", "real_face.npy")

# Production-weight (mediapipe port) landmark-min/max box on the unscaled
# photo — the oracle for real-face detector IoU (measured, jax+numpy paths
# agree; see tests/test_realface.py).
REAL_FACE_BOX = (169, 132, 353, 333)


def real_face_image() -> Optional[np.ndarray]:
    """The bundled real portrait as a BGR uint8 array (the committed
    ``checkpoints/real_face.npy``), or ``None`` when the file is absent."""
    if not os.path.exists(_ASSET_NPY):
        return None
    return np.load(_ASSET_NPY)


@dataclasses.dataclass(frozen=True)
class RealFaceClip:
    frames: np.ndarray          # (T, H, W, 3) BGR uint8
    fps: float
    bpm_truth: float
    face_boxes: np.ndarray      # (T, 4) int32 x1,y1,x2,y2 (motion-tracked)
    pulse: np.ndarray           # (T,) the injected waveform (u8 units)


def synthesize_real_face_clip(
        bpm: float = 72.0,
        fps: float = 10.0,
        duration_s: float = 12.0,
        pulse_amplitude: float = 2.0,
        motion_px: float = 1.0,
        motion_hz: float = 0.3,
        noise_std: float = 1.0,
        scale: float = 1.0,
        flicker_bpm: Optional[float] = None,
        flicker_amp: float = 0.0,
        occlude_frac: float = 0.0,
        occlude_span: Tuple[float, float] = (0.4, 0.7),
        seed: int = 0) -> RealFaceClip:
    """Animate the real portrait with a known cardiac pulse.

    The pulse is a sinusoidal green-channel modulation applied through a
    soft elliptical mask inscribed in the (production-weight) face box —
    the same skin-pulse model the synthetic generator uses
    (``utils/synth.py``), so the cheek-ROI green mean carries the signal
    exactly as the reference pipeline expects
    (``/root/reference/analysis/measurement/green_avg.py:26-44``).
    Rigid sinusoidal translation (``motion_px``) emulates head
    micro-motion; ``face_boxes`` tracks it per frame.

    Real-pixel stressors (r4, VERDICT #5):

    - ``flicker_bpm``/``flicker_amp``: multiplicative common-mode
      illumination flicker over the WHOLE image,
      ``1 + amp*sin(2*pi*(flicker_bpm/60)*t)`` — the same model as
      ``utils/synth.py`` so the adaptive-method tests transfer.
    - ``occlude_frac``: during the ``occlude_span`` fraction of the clip,
      a gray patch covers that fraction of the face box's height from the
      top (hand/hair-over-forehead style) — exercises detector holdover
      and recovery on real pixels.

    With ``motion_px=0`` and ``scale=1`` the clip is built with numpy
    alone; motion and rescaling use cv2.

    Raises ``RuntimeError`` when no real-photo asset is available.
    """
    img = real_face_image()
    if img is None:
        raise RuntimeError("no bundled real-face asset in this environment")
    box = np.asarray(REAL_FACE_BOX, np.float64)
    if scale != 1.0:
        import cv2
        img = cv2.resize(img, (int(round(img.shape[1] * scale)),
                               int(round(img.shape[0] * scale))),
                         interpolation=cv2.INTER_AREA)
        box = box * scale
    H, W = img.shape[:2]

    # Soft elliptical pulse mask inscribed in the face box.
    cx, cy = (box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0
    rx, ry = (box[2] - box[0]) / 2.0, (box[3] - box[1]) / 2.0
    yy, xx = np.mgrid[0:H, 0:W]
    r2 = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    mask = np.clip(1.25 - r2, 0.0, 1.0).astype(np.float32)   # soft edge

    T = int(round(duration_s * fps))
    t = np.arange(T, dtype=np.float64) / fps
    pulse = pulse_amplitude * np.sin(2.0 * np.pi * (bpm / 60.0) * t)
    dx = motion_px * np.sin(2.0 * np.pi * motion_hz * t)
    dy = 0.5 * motion_px * np.sin(2.0 * np.pi * motion_hz * t + 1.1)

    flick = np.ones(T, np.float64)
    if flicker_bpm is not None:
        flick += flicker_amp * np.sin(2.0 * np.pi * (flicker_bpm / 60.0) * t)
    occ0, occ1 = (int(round(occlude_span[0] * T)),
                  int(round(occlude_span[1] * T)))

    rng = np.random.default_rng(seed)
    base = img.astype(np.float32)
    frames = np.empty((T, H, W, 3), np.uint8)
    boxes = np.empty((T, 4), np.int32)
    for i in range(T):
        f = base.copy()
        f[..., 1] += pulse[i] * mask
        f *= flick[i]
        if motion_px != 0.0:
            import cv2
            m = np.float32([[1, 0, dx[i]], [0, 1, dy[i]]])
            f = cv2.warpAffine(f, m, (W, H), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REPLICATE)
        if occlude_frac > 0.0 and occ0 <= i < occ1:
            # Flat gray patch over the top `occlude_frac` of the face box
            # (post-warp, as a real occluder sits between camera and face).
            x1, y1 = int(box[0] + dx[i]), int(box[1] + dy[i])
            x2 = int(box[2] + dx[i])
            y2 = y1 + int(round(occlude_frac * (box[3] - box[1])))
            f[max(0, y1):max(0, y2), max(0, x1):max(0, x2)] = 96.0
        if noise_std > 0.0:
            f += rng.normal(0.0, noise_std, f.shape).astype(np.float32)
        frames[i] = np.clip(f, 0.0, 255.0).astype(np.uint8)
        boxes[i] = np.round([box[0] + dx[i], box[1] + dy[i],
                             box[2] + dx[i], box[3] + dy[i]]).astype(np.int32)
    return RealFaceClip(frames=frames, fps=fps, bpm_truth=bpm,
                        face_boxes=boxes, pulse=pulse.astype(np.float32))
