"""Synthetic rPPG video generation (host-side numpy).

The reference has no test fixtures beyond a dummy plugin pair
(``analysis/measurement/dummy.py``, ``analysis/degradation/dummy.py``); real
validation required private videos with ground-truth CSVs.  This module
synthesizes face videos with *known* physiology: an elliptical skin-tone
"face" whose green channel pulses at a prescribed BPM (plus optional motion,
drift and sensor noise), with the ground-truth face box and pulse waveform
returned alongside the pixels.  Used by the test-suite, the benchmark
harness, and the landmark-model trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["SynthSpec", "SynthVideo", "synthesize", "synthesize_on_device",
           "FaceSpec", "MultiSynthVideo", "synthesize_multi"]


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    height: int = 144
    width: int = 176
    fps: float = 30.0
    duration_s: float = 40.0
    bpm: float = 72.0
    pulse_amplitude: float = 2.0        # green-channel peak amplitude (u8 units)
    skin_bgr: Tuple[float, float, float] = (105.0, 135.0, 180.0)
    background_bgr: Tuple[float, float, float] = (60.0, 60.0, 60.0)
    face_center: Tuple[float, float] = (0.5, 0.45)   # (x, y) fractions
    face_radii: Tuple[float, float] = (0.18, 0.28)   # (rx, ry) fractions
    motion_amplitude: float = 0.0       # horizontal sway in pixels
    motion_hz: float = 0.1
    drift_amplitude: float = 0.0        # slow global brightness drift
    drift_hz: float = 0.05
    noise_std: float = 0.0
    hr_drift_bpm: float = 0.0           # linear BPM ramp over the clip
    seed: int = 0
    dropout_frames: Tuple[int, ...] = ()  # frames where the face disappears
    # Multiplicative common-mode illumination flicker (whole image), an
    # in-band confound for the raw green mean: brightness scales by
    # 1 + amp*sin(2*pi*(flicker_bpm/60)*t).  The chrominance projections
    # (dsp.projections) reject it by construction.
    flicker_bpm: Optional[float] = None
    flicker_amp: float = 0.0


@dataclasses.dataclass(frozen=True)
class SynthVideo:
    frames: np.ndarray        # (T, H, W, 3) uint8 BGR
    fps: float
    bpm_truth: np.ndarray     # (T,) instantaneous BPM
    face_boxes: np.ndarray    # (T, 4) int32 [x1, y1, x2, y2] ground truth
    pulse: np.ndarray         # (T,) the injected pulse waveform


def _pulse(spec: SynthSpec, t: np.ndarray):
    """Instantaneous BPM and the injected unit pulse at times ``t``."""
    bpm_t = spec.bpm + spec.hr_drift_bpm * (t / max(t[-1], 1e-9))
    phase = 2.0 * np.pi * np.cumsum(bpm_t / 60.0) / spec.fps
    return bpm_t, np.sin(phase)


def _skin_colors(spec: SynthSpec, pulse: np.ndarray) -> np.ndarray:
    """Per-frame float32 BGR skin colour: the green channel pulsates."""
    skin = np.tile(np.asarray(spec.skin_bgr, np.float32), (len(pulse), 1))
    skin[:, 1] += spec.pulse_amplitude * pulse
    return skin


def _face_mask(spec: SynthSpec, xx, yy, cx: float, cy: float):
    """The elliptical face centred at ``(cx, cy)`` -> ``(mask, box)``."""
    H, W = xx.shape
    rx, ry = spec.face_radii[0] * W, spec.face_radii[1] * H
    mask = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1.0
    ys, xs = np.nonzero(mask)
    return mask, np.asarray([xs.min(), ys.min(), xs.max(), ys.max()],
                            np.int32)


def synthesize(spec: SynthSpec) -> SynthVideo:
    rng = np.random.default_rng(spec.seed)
    T = int(round(spec.duration_s * spec.fps))
    H, W = spec.height, spec.width
    t = np.arange(T) / spec.fps

    bpm_t, pulse = _pulse(spec, t)
    skin = _skin_colors(spec, pulse)
    cx = spec.face_center[0] * W + spec.motion_amplitude * np.sin(
        2.0 * np.pi * spec.motion_hz * t)
    cy = spec.face_center[1] * H

    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.empty((T, H, W, 3), dtype=np.uint8)
    boxes = np.zeros((T, 4), dtype=np.int32)
    drift = spec.drift_amplitude * np.sin(2.0 * np.pi * spec.drift_hz * t)

    bg = np.array(spec.background_bgr, dtype=np.float32)
    dropout = set(spec.dropout_frames)
    flick = np.ones(T)
    if spec.flicker_bpm is not None:
        flick += spec.flicker_amp * np.sin(
            2.0 * np.pi * (spec.flicker_bpm / 60.0) * t)

    for i in range(T):
        img = np.broadcast_to(bg, (H, W, 3)).astype(np.float32).copy()
        if i not in dropout:
            mask, boxes[i] = _face_mask(spec, xx, yy, cx[i], cy)
            img[mask] = skin[i]
        img *= flick[i]
        img += drift[i]
        if spec.noise_std > 0:
            img += rng.normal(0.0, spec.noise_std, size=img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)

    return SynthVideo(frames=frames, fps=spec.fps, bpm_truth=bpm_t,
                      face_boxes=boxes, pulse=pulse)


def synthesize_on_device(spec: SynthSpec):
    """:func:`synthesize`'s clip model built on the default device, for
    clips too large to build and upload from the host (minutes of 1080p).

    Supports the static-face subset of :class:`SynthSpec`: no motion,
    brightness drift, HR drift, flicker or dropouts.  The face mask, its
    box, the per-frame skin colour and the pulse come from the same host
    helpers as :func:`synthesize`; sensor noise comes from ``jax.random``
    seeded by ``spec.seed`` (so with ``noise_std > 0`` the pixels differ
    from the host generator's, while the pulse and face are the same; with
    ``noise_std == 0`` the frames are identical).

    Returns ``(frames, face_box, bpm_truth)``: a ``(T, H, W, 3)`` uint8 BGR
    device array, the ``(4,)`` int32 ground-truth box and the ``(T,)``
    instantaneous BPM.
    """
    import jax
    import jax.numpy as jnp

    if (spec.motion_amplitude or spec.drift_amplitude or spec.hr_drift_bpm
            or spec.dropout_frames or spec.flicker_bpm is not None):
        raise ValueError("synthesize_on_device builds static-face clips only")
    T = int(round(spec.duration_s * spec.fps))
    H, W = spec.height, spec.width
    bpm_t, pulse = _pulse(spec, np.arange(T) / spec.fps)
    skin = _skin_colors(spec, pulse)
    yy, xx = np.mgrid[0:H, 0:W]
    mask, box = _face_mask(spec, xx, yy, spec.face_center[0] * W,
                           spec.face_center[1] * H)
    bg = np.asarray(spec.background_bgr, np.float32)
    block = max(d for d in range(1, min(T, 32) + 1) if T % d == 0)

    @jax.jit
    def build(mask_d, skin_d, key):
        def one_block(args):
            colors, k = args                               # (block, 3)
            img = jnp.where(mask_d[None, :, :, None],
                            colors[:, None, None, :], jnp.asarray(bg))
            if spec.noise_std > 0:
                img = img + spec.noise_std * jax.random.normal(
                    k, img.shape, jnp.float32)
            return jnp.clip(img, 0.0, 255.0).astype(jnp.uint8)

        keys = jax.random.split(key, T // block)
        out = jax.lax.map(one_block, (skin_d.reshape(T // block, block, 3),
                                      keys))
        return out.reshape(T, H, W, 3)

    frames = build(jnp.asarray(mask), jnp.asarray(skin),
                   jax.random.PRNGKey(spec.seed))
    return frames, box, bpm_t


@dataclasses.dataclass(frozen=True)
class FaceSpec:
    """One subject in a multi-face clip."""

    center: Tuple[float, float]                       # (x, y) fractions
    bpm: float = 72.0
    radii: Tuple[float, float] = (0.12, 0.18)
    skin_bgr: Tuple[float, float, float] = (105.0, 135.0, 180.0)
    pulse_amplitude: float = 2.0
    dropout_frames: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class MultiSynthVideo:
    frames: np.ndarray        # (T, H, W, 3) uint8 BGR
    fps: float
    bpm_truth: np.ndarray     # (K,) per-face BPM
    face_boxes: np.ndarray    # (T, K, 4) int32 ground truth (x-sorted)


def synthesize_multi(faces: Tuple[FaceSpec, ...],
                     height: int = 144, width: int = 256,
                     fps: float = 30.0, duration_s: float = 40.0,
                     background_bgr: Tuple[float, float, float] = (60.0,) * 3,
                     noise_std: float = 0.0, seed: int = 0
                     ) -> MultiSynthVideo:
    """Several pulsing faces in one clip (multi-subject monitoring fixture;
    the reference configures ``num_faces=2`` at ``rppg_LIVESTREAM.py:308``
    but only ever processes ``face_landmarks[0]``)."""
    rng = np.random.default_rng(seed)
    T = int(round(duration_s * fps))
    H, W = height, width
    t = np.arange(T) / fps
    yy, xx = np.mgrid[0:H, 0:W]
    order = np.argsort([f.center[0] for f in faces])
    faces = tuple(faces[i] for i in order)
    K = len(faces)

    frames = np.empty((T, H, W, 3), dtype=np.uint8)
    boxes = np.zeros((T, K, 4), dtype=np.int32)
    bg = np.array(background_bgr, dtype=np.float32)
    pulses = [np.sin(2.0 * np.pi * (f.bpm / 60.0) * t) for f in faces]

    for i in range(T):
        img = np.broadcast_to(bg, (H, W, 3)).astype(np.float32).copy()
        for k, f in enumerate(faces):
            if i in f.dropout_frames:
                continue
            cx, cy = f.center[0] * W, f.center[1] * H
            rx, ry = f.radii[0] * W, f.radii[1] * H
            mask = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1.0
            color = np.array(f.skin_bgr, np.float32).copy()
            color[1] += f.pulse_amplitude * pulses[k][i]
            img[mask] = color
            ys, xs = np.nonzero(mask)
            boxes[i, k] = [xs.min(), ys.min(), xs.max(), ys.max()]
        if noise_std > 0:
            img += rng.normal(0.0, noise_std, size=img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)

    return MultiSynthVideo(frames=frames, fps=fps,
                           bpm_truth=np.array([f.bpm for f in faces]),
                           face_boxes=boxes)
