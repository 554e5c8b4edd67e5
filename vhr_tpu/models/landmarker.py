"""Flax face-landmark model: a first-party FaceLandmarker equivalent.

The reference delegates face analysis to MediaPipe's C++ FaceLandmarker
(TFLite graphs in ``face_landmarker.task``; set up at ``rppg_VIDEO.py:39-46``
and used per frame at ``rppg_VIDEO.py:380``).  The rPPG pipeline only ever
consumes the landmark cloud's min/max bounding box (``rppg_VIDEO.py:93-98``),
so this model regresses a landmark set + face-presence score from a
downsampled frame, batched over ``(streams, T)`` under ``jit``/``pjit``.

Architecture: a BlazeFace-flavored depthwise-separable conv backbone sized
for matrix units (bfloat16 matmuls, channel counts multiples of 128 at the
deep end), with two dense heads (landmarks, presence).  Weights train on the
synthetic face generator (``vhr_tpu.models.train``) and checkpoint via
orbax; converted external checkpoints can be loaded into the same tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["LandmarkerConfig", "FaceLandmarker", "preprocess_frames",
           "landmarks_to_bbox_valid", "make_detector", "make_roi_detector",
           "load_default_detector", "load_real_distilled_detector"]


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class LandmarkerConfig:
    input_size: int = 96
    num_landmarks: int = 68
    # Capacity chosen empirically (r2): (64,128,128,256)/stem 32 plateaued
    # at held-out IoU 0.859-0.860 (fine-tuning gained nothing); this wider
    # config reaches 0.884 at 8000 steps (train-family 0.903 — small gap,
    # generalizing not memorizing).
    stem_features: int = 48
    block_features: Tuple[int, ...] = (64, 128, 256, 384)
    # "flatten" keeps the deep 3x3 spatial map (localization needs WHERE;
    # global average pooling erases it — held-out IoU 0.744 with GAP vs the
    # 0.8 bar); "gap" is the cheaper classification-style head.
    pool: str = "flatten"
    compute_dtype: Any = jnp.bfloat16


class _SeparableBlock(nn.Module):
    """Depthwise 3x3 (stride 2) + pointwise 1x1, BN-free (GroupNorm)."""

    features: int
    dtype: Any

    @nn.compact
    def __call__(self, x):
        c_in = x.shape[-1]
        x = nn.Conv(features=c_in, kernel_size=(3, 3), strides=(2, 2),
                    feature_group_count=c_in, dtype=self.dtype, name="dw")(x)
        x = nn.Conv(features=self.features, kernel_size=(1, 1),
                    dtype=self.dtype, name="pw")(x)
        x = nn.GroupNorm(num_groups=8, dtype=self.dtype)(x)
        return nn.relu(x)


class FaceLandmarker(nn.Module):
    """``(B, S, S, 3)`` float in [0,1] -> (landmarks (B, L, 2), presence (B,))."""

    cfg: LandmarkerConfig = LandmarkerConfig()

    @nn.compact
    def __call__(self, x):
        c = self.cfg
        x = x.astype(c.compute_dtype)
        x = nn.Conv(features=c.stem_features, kernel_size=(3, 3),
                    strides=(2, 2), dtype=c.compute_dtype, name="stem")(x)
        x = nn.relu(x)
        for i, f in enumerate(c.block_features):
            x = _SeparableBlock(features=f, dtype=c.compute_dtype,
                                name=f"block{i}")(x)
        if c.pool == "gap":
            x = jnp.mean(x, axis=(1, 2))
        else:                                   # keep the spatial map
            x = x.reshape(x.shape[0], -1)
        x = x.astype(jnp.float32)
        feat = nn.Dense(256, name="trunk")(x)
        feat = nn.relu(feat)
        lm = nn.Dense(c.num_landmarks * 2, name="landmark_head")(feat)
        lm = nn.sigmoid(lm).reshape(x.shape[0], c.num_landmarks, 2)
        presence = nn.Dense(1, name="presence_head")(feat)[:, 0]
        return lm, presence


def preprocess_frames(frames: jnp.ndarray, input_size: int) -> jnp.ndarray:
    """``(B, H, W, 3)`` uint8 BGR -> ``(B, S, S, 3)`` float RGB in [0, 1].

    Mirrors the reference's BGR->RGB conversion before detection
    (``rppg_VIDEO.py:376``); resize is a single fused XLA gather/conv.
    """
    rgb = frames[..., ::-1].astype(jnp.float32) / 255.0
    B = frames.shape[0]
    return jax.image.resize(rgb, (B, input_size, input_size, 3), "linear")


def landmarks_to_bbox_valid(landmarks: jnp.ndarray, presence: jnp.ndarray,
                            width: int, height: int,
                            threshold: float = 0.0
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Landmark cloud -> (boxes, valid), the detector interface.

    The bbox is the landmark min/max scaled to pixels (``rppg_VIDEO.py:93-98``
    via ``vhr_tpu.ops.roi.bbox_from_landmarks``); validity is the presence
    logit against ``threshold``.
    """
    from ..ops.roi import bbox_from_landmarks
    boxes = bbox_from_landmarks(landmarks, width, height)
    return boxes, presence > threshold


def make_detector(params, cfg: LandmarkerConfig = LandmarkerConfig(),
                  threshold: float = 0.0):
    """Wrap trained weights as a pipeline detector.

    Returns a ``frames (T, H, W, 3) u8 -> (boxes, valid)`` callable with the
    same interface as ``skin_detector.detect_faces``, so the learned model
    drops into ``pipeline.offline.extract_signals(detector=...)`` — the
    MediaPipe-equivalent path of the reference (``rppg_VIDEO.py:351,380``).

    The weights ride along as a ``jax.tree_util.Partial`` argument (a traced
    pytree), NOT a Python closure: a closed-over param tree would be baked
    into every jitted caller as XLA literal constants (slow compiles,
    re-embedded per program).
    """
    model = FaceLandmarker(cfg)

    def _detect(p, frames: jnp.ndarray):
        T, H, W, _ = frames.shape
        x = preprocess_frames(frames, cfg.input_size)
        lm, presence = model.apply({"params": p}, x)
        return landmarks_to_bbox_valid(lm, presence, W, H, threshold)

    return jax.tree_util.Partial(_detect, params)


def make_roi_detector(params, cfg: LandmarkerConfig = LandmarkerConfig(),
                      roi_cfg=None, threshold: float = 0.0):
    """Wrap trained weights as a *pose-robust ROI* detector.

    Unlike :func:`make_detector` (which collapses the cloud to a min/max box
    exactly as the reference does, ``rppg_VIDEO.py:93-98``), this variant
    also returns the cheek ROI carved out of the landmark cloud's own frame
    (``ops.roi.cheek_roi_from_landmarks``) — under head roll the ROI follows
    the rotated cheek band instead of drifting off it.  Interface:
    ``frames (T, H, W, 3) u8 -> (boxes (T, 4), rois (T, 4), valid (T,))``,
    consumed by ``pipeline.offline.extract_signals_landmark_roi``.
    """
    from ..config import ROIConfig
    from ..ops.roi import cheek_roi_from_landmarks

    roi_cfg = roi_cfg or ROIConfig()
    model = FaceLandmarker(cfg)

    def _detect(p, frames: jnp.ndarray):
        T, H, W, _ = frames.shape
        x = preprocess_frames(frames, cfg.input_size)
        lm, presence = model.apply({"params": p}, x)
        boxes, valid = landmarks_to_bbox_valid(lm, presence, W, H, threshold)
        rois = cheek_roi_from_landmarks(lm, roi_cfg, W, H)
        return boxes, rois, valid

    return jax.tree_util.Partial(_detect, params)


def load_default_detector(path: str = None, threshold: float = 0.0):
    """Load the repo's trained synthetic-face checkpoint as a detector."""
    import os
    from . import checkpoint as ckpt
    from .train import TrainConfig
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "checkpoints", "landmarker")
    cfg = TrainConfig().model
    import jax
    model = FaceLandmarker(cfg)
    like = model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, cfg.input_size, cfg.input_size, 3))
                      )["params"]
    params = ckpt.load_params(path, like=like)
    return make_detector(params, cfg, threshold)


def load_real_distilled_detector(threshold: float = 0.0):
    """The real-photo-distilled variant of the learned landmarker.

    Fine-tuned from the default checkpoint on a teacher-labeled augmented
    stream of the bundled real portrait (``models/realgen.py``; teacher =
    the ported production MediaPipe model).  Measured tradeoff
    (``docs/DETECTION.md``): real-photo IoU 0.83 (default weights: 0.20)
    at the cost of the flat-tone duo fixture (0.80/0.77 vs 0.87/0.90) —
    pick this variant for real imagery, the default for the synthetic
    fixture domain.
    """
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "checkpoints", "landmarker_distill")
    return load_default_detector(path, threshold)
