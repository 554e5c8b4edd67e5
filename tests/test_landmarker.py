"""Learned landmark model: forward, adapter interface, checkpoint detector."""

import os
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vhr_tpu.models import landmarker as lmk
from vhr_tpu.models import train as vtrain
from vhr_tpu.utils.synth import SynthSpec, synthesize

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "landmarker"


def test_forward_shapes():
    cfg = lmk.LandmarkerConfig()
    model = lmk.FaceLandmarker(cfg)
    x = jnp.zeros((3, cfg.input_size, cfg.input_size, 3))
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    lm, presence = model.apply({"params": params}, x)
    assert lm.shape == (3, cfg.num_landmarks, 2)
    assert presence.shape == (3,)
    assert float(jnp.min(lm)) >= 0.0 and float(jnp.max(lm)) <= 1.0


def test_detector_adapter_interface():
    cfg = vtrain.TrainConfig(batch_size=8)
    model, params, _, _ = vtrain.init_state(cfg, jax.random.PRNGKey(0))
    det = lmk.make_detector(params, cfg.model)
    clip = synthesize(SynthSpec(duration_s=1.0, height=60, width=80))
    boxes, valid = det(jnp.asarray(clip.frames))
    assert boxes.shape == (30, 4) and valid.shape == (30,)
    # Drops into the pipeline.
    from vhr_tpu.pipeline import offline
    trace = offline.extract_signals(jnp.asarray(clip.frames), detector=det)
    assert trace.bgr.shape == (30, 3)


def _iou(a, c):
    ix = max(0, min(a[2], c[2]) - max(a[0], c[0]))
    iy = max(0, min(a[3], c[3]) - max(a[1], c[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (c[2] - c[0]) * (c[3] - c[1]) - inter)
    return inter / max(union, 1)


def _clip_ious(det, gen_cfg, n_clips=4, frames=4, seed=7):
    """Mean-IoU samples of a detector over held-out facegen clips."""
    from vhr_tpu.models import facegen
    rng = np.random.default_rng(seed)
    ious = []
    for c in range(n_clips):
        fr, truth = facegen.render_clip(gen_cfg, rng, frames, 96, 120)
        boxes, valid = det(jnp.asarray(fr))
        b, v = np.asarray(boxes), np.asarray(valid)
        ious += [_iou(b[i], truth[i]) if v[i] else 0.0 for i in range(frames)]
    return float(np.mean(ious))


@pytest.mark.skipif(not CKPT.exists(), reason="no trained checkpoint in repo")
def test_trained_checkpoint_localizes_faces():
    """IoU >= 0.8 on the HELD-OUT generator family (VERDICT r1 item 4) —
    interpolated tones, shifted pose ranges, elliptical occluders; never the
    training family.  Round 1's bar was 0.5 on the training distribution."""
    from vhr_tpu.models import facegen
    det = lmk.load_default_detector()
    gen = facegen.FaceGenConfig(held_out=True, face_prob=1.0)
    assert _clip_ious(det, gen, n_clips=5) >= 0.8
    # And the easy single-face synth clips it must not have regressed on.
    clip = synthesize(SynthSpec(duration_s=2.0, height=96, width=120))
    boxes, valid = det(jnp.asarray(clip.frames))
    assert bool(np.asarray(valid).all())
    b = np.asarray(boxes)
    ious = [_iou(b[i], clip.face_boxes[i]) for i in range(0, len(b), 10)]
    assert float(np.mean(ious)) > 0.8, ious


@pytest.mark.skipif(not CKPT.exists(), reason="no trained checkpoint in repo")
def test_adversarial_skin_detector_fails_landmarker_passes():
    """The failure-matrix contrast (docs/DETECTION.md): on skin-colored
    backgrounds the fixed chroma box balloons to the frame (IoU collapses)
    while the learned landmarker keeps localizing."""
    import dataclasses
    from vhr_tpu.models import facegen
    from vhr_tpu.models.skin_detector import detect_faces

    gen = dataclasses.replace(
        facegen.FaceGenConfig(held_out=True, face_prob=1.0),
        skin_background_prob=1.0, light_gain=(1.0, 1.0), occlusion_prob=0.0)
    skin_iou = _clip_ious(lambda fr: detect_faces(fr), gen)
    lmk_iou = _clip_ious(lmk.load_default_detector(), gen)
    assert skin_iou < 0.5, skin_iou          # chroma box defeated
    assert lmk_iou >= 0.8, lmk_iou           # learned model robust


@pytest.mark.skipif(not CKPT.exists(), reason="no trained checkpoint in repo")
def test_refined_detector_improves_iou():
    """Crop self-refinement (models/cascade.py) sharpens the full-frame
    landmarker's box on held-out hard clips (measured 0.890 -> 0.924)."""
    from vhr_tpu.models import cascade, facegen

    gen = facegen.FaceGenConfig(held_out=True, face_prob=1.0)
    one = _clip_ious(lmk.load_default_detector(), gen, n_clips=5)
    two = _clip_ious(cascade.load_default_refined_detector(), gen, n_clips=5)
    assert two > one, (one, two)
    assert two >= 0.9, two


@pytest.mark.skipif(not CKPT.exists(), reason="no trained checkpoint in repo")
def test_cascade_multi_detector_in_pipeline():
    """Skin proposals + landmarker refinement through the multi-face
    pipeline: identities hold and both subjects' BPMs recover."""
    from vhr_tpu.models import cascade
    from vhr_tpu.models.landmarker import load_default_detector
    from vhr_tpu.models.train import TrainConfig
    from vhr_tpu.pipeline import offline
    from vhr_tpu.utils.synth import FaceSpec, synthesize_multi
    from vhr_tpu.config import PipelineConfig

    params = load_default_detector().args[0]
    det = cascade.make_cascade_detector_multi(params, TrainConfig().model,
                                              k_faces=2)
    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=60.0),
         FaceSpec(center=(0.72, 0.5), bpm=96.0)),
        height=144, width=256, duration_s=12.0, noise_std=1.0)
    cfg = PipelineConfig(window_seconds=6.0, acquisition_seconds=3.0)
    ts, bpm, ok = offline.measure_green_avg_multi(
        jnp.asarray(duo.frames), duo.fps, 2, cfg, detector=det)
    steady = slice(cfg.window_len(duo.fps), None)
    assert ok[steady].all()
    err = np.abs(bpm[steady] - duo.bpm_truth[None, :])
    assert float(err.mean()) <= 5.0, bpm[-1]


@pytest.mark.skipif(not CKPT.exists(), reason="no trained checkpoint in repo")
def test_roi_detector_pose_robust_pipeline():
    """make_roi_detector + extract_signals_landmark_roi: the checkpoint's
    landmark cloud yields a cheek ROI inside the true face box, and the
    trace's means come from it."""
    from vhr_tpu.models.train import TrainConfig
    from vhr_tpu.pipeline import offline

    params = lmk.load_default_detector().args[0]
    det = lmk.make_roi_detector(params, TrainConfig().model)
    clip = synthesize(SynthSpec(duration_s=2.0, height=96, width=120))
    trace = offline.extract_signals_landmark_roi(jnp.asarray(clip.frames),
                                                 det)
    assert bool(np.asarray(trace.valid).all())
    rois = np.asarray(trace.rois)
    truth = clip.face_boxes
    # Every ROI sits inside a slightly padded true face box.
    pad = 6
    assert (rois[:, 0] >= truth[:, 0] - pad).all()
    assert (rois[:, 1] >= truth[:, 1] - pad).all()
    assert (rois[:, 2] <= truth[:, 2] + pad).all()
    assert (rois[:, 3] <= truth[:, 3] + pad).all()
    assert (rois[:, 2] > rois[:, 0]).all() and (rois[:, 3] > rois[:, 1]).all()


def test_crop_boxes_bilinear_matches_gather_reference():
    """The separable-matmul crop (models/cascade.py crop_boxes_bilinear) must
    reproduce the bilinear-gather semantics it replaced: coords clamped to
    the frame, floor tap clipped to n-2 (edge rows/columns repeat), for
    interior, edge-spilling, and degenerate boxes."""
    from vhr_tpu.models.cascade import crop_boxes_bilinear

    rng = np.random.default_rng(3)
    H, W, S = 71, 103, 24
    frames = rng.integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    boxes = np.array([
        [20, 15, 60, 55],        # interior
        [-10, -8, 30, 25],       # spills top-left
        [80, 50, 140, 100],      # spills bottom-right
        [40, 30, 42, 31],        # degenerate (min side clamp)
        [0, 0, W, H],            # whole frame
    ], np.int32)
    crops, origins = crop_boxes_bilinear(
        jnp.asarray(frames), jnp.asarray(boxes), S, pad=0.3)

    # numpy oracle of the original gather form
    b = boxes.astype(np.float64)
    cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
    half = np.maximum(np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]),
                      2.0) * 0.5 * 1.6
    u = np.arange(S) / (S - 1)
    for t in range(5):
        xs = np.clip(cx[t] - half[t] + u * 2 * half[t], 0, W - 1)
        ys = np.clip(cy[t] - half[t] + u * 2 * half[t], 0, H - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, W - 2)
        y0 = np.clip(np.floor(ys).astype(int), 0, H - 2)
        fx, fy = xs - x0, ys - y0
        img = frames[t].astype(np.float64)
        g = (img[y0][:, x0] * (1 - fx)[None, :, None] * (1 - fy)[:, None, None]
             + img[y0][:, x0 + 1] * fx[None, :, None] * (1 - fy)[:, None, None]
             + img[y0 + 1][:, x0] * (1 - fx)[None, :, None] * fy[:, None, None]
             + img[y0 + 1][:, x0 + 1] * fx[None, :, None] * fy[:, None, None])
        want = g[..., ::-1] / 255.0
        np.testing.assert_allclose(np.asarray(crops)[t], want,
                                   atol=2.0 / 255.0, rtol=0, err_msg=str(t))
        np.testing.assert_allclose(
            np.asarray(origins)[t],
            [cx[t] - half[t], cy[t] - half[t], 2 * half[t], 2 * half[t]],
            atol=1e-3)
