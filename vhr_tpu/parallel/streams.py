"""Stream-parallel batched monitoring: N subjects across a device mesh.

The BASELINE 64-concurrent-720p-streams configuration: frames arrive as
``(streams, T, H, W, 3)``; each stream runs the full rPPG pipeline
independently, so the natural layout shards the ``streams`` axis across
devices via ``shard_map`` — zero collectives in steady state, device links
used only at input distribution.  Contrast with the reference, which can only process one
video per Python process (``analysis/main.py`` loops serially).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import PipelineConfig
from ..models import skin_detector
from ..ops import reduce as vreduce
from ..ops import roi as vroi
from ..ops import windows as vwin

__all__ = ["multistream_green_bpm", "MultiStreamResult"]


class MultiStreamResult(NamedTuple):
    bpm: jnp.ndarray      # (streams, T)
    valid: jnp.ndarray    # (streams, T)
    green: jnp.ndarray    # (streams, T)


def _single_stream(frames, detector, fps: float, cfg: PipelineConfig,
                   det: skin_detector.SkinDetectorConfig):
    """Per-shard pipeline body: (S_local, T, H, W, 3) -> per-frame BPM.

    ``detector`` is an optional pipeline detector callable (``frames ->
    (boxes, valid)``, e.g. the production MediaPipe port) whose weights ride
    the shard_map as replicated inputs; ``None`` selects skin chroma.

    Detection is frame-local, so a pluggable detector runs once over the
    FLATTENED (S_local*T) frame batch rather than vmapped per stream:
    the flat batch keeps the conv/resize ops in their natural layout.
    Tracking/DSP stay per-stream (the holdover scan is the only
    cross-frame state and never crosses a stream boundary)."""
    if detector is not None:
        S, T, H, W, _ = frames.shape
        boxes_f, valid_f = detector(frames.reshape(S * T, H, W, 3))
        boxes_sk = boxes_f.reshape(S, T, 4)
        valid_sk = valid_f.reshape(S, T)
    else:
        boxes_sk = valid_sk = None

    def one(fr, bx, vl):
        T, H, W, _ = fr.shape
        if detector is not None:
            boxes, valid = bx, vl
        else:
            boxes, valid = skin_detector.detect_faces(fr, det)
        track = vroi.holdover(boxes, valid, cfg.roi.landmark_hold_frames)
        rois = vroi.cheek_roi(track.box, cfg.roi, W, H)
        rois = jnp.where(track.valid[:, None], rois, 0)
        means, _ = vreduce.roi_channel_means(fr, rois)
        # Forward-fill over dropout frames before windowing (the offline
        # measure_green_avg convention) — raw zeros on invalid frames would
        # otherwise leak into the FFT windows.
        green = _ffill(means[:, cfg.channel], track.valid)
        rolling = vwin.rolling_bpm_fft(
            green, fps, cfg.band, cfg.window_len(fps),
            cfg.acquisition_len(fps))
        ok = jnp.logical_and(rolling.valid, track.valid)
        return rolling.bpm, ok, green

    if detector is not None:
        return jax.vmap(one)(frames, boxes_sk, valid_sk)
    return jax.vmap(lambda fr: one(fr, None, None))(frames)


def _ffill(x, ok):
    """Carry the last valid sample forward over dropouts (per stream) —
    the shared primitive, zero init (masked out downstream)."""
    from ..dsp.filters import forward_fill
    return forward_fill(x, ok, init="zeros")


def multistream_green_bpm(frames: jnp.ndarray, fps: float,
                          mesh: Mesh,
                          cfg: PipelineConfig = PipelineConfig(),
                          det: skin_detector.SkinDetectorConfig = None,
                          detector=None) -> MultiStreamResult:
    """Run the green-channel pipeline for ``(streams, T, H, W, 3)`` frames
    sharded over the mesh's ``stream`` axis.

    Each device independently processes ``streams / n_devices`` subjects —
    the embarrassingly-parallel layout; ``shard_map`` keeps XLA from
    gathering the video tensor anywhere.  ``det`` tunes detection (e.g.
    ``downsample=4`` strided sampling for many-stream 720p monitoring).

    ``detector`` swaps the per-stream face stage for any pipeline detector
    callable (e.g. :func:`vhr_tpu.models.mediapipe_face
    .make_mediapipe_detector` — the production weights then run
    data-parallel across the mesh, weights replicated per device).

    The farm is one jitted program per ``(mesh, cfg, det, fps)``; the
    detector's weights (a ``jax.tree_util.Partial``) are traced arguments.
    """
    det = det or skin_detector.SkinDetectorConfig()
    return _multistream_jit(frames, detector, fps=float(fps), mesh=mesh,
                            cfg=cfg, det=det)


@functools.partial(jax.jit, static_argnames=("fps", "mesh", "cfg", "det"))
def _multistream_jit(frames, detector, fps, mesh, cfg, det):
    spec = P("stream")
    fn = functools.partial(_single_stream, fps=fps, cfg=cfg, det=det)
    # detector weights (a Partial pytree, e.g. the MediaPipe port) enter as
    # replicated shard_map inputs — traced arguments, never baked XLA
    # literals.
    mapped = shard_map(
        fn, mesh=mesh,
        in_specs=(spec, P()),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )
    bpm, valid, green = mapped(frames, detector)
    return MultiStreamResult(bpm=bpm, valid=valid, green=green)
