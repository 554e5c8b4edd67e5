"""Offline rPPG pipelines: whole-video batched array programs.

One engine replaces the reference's three divergent copies of the pipeline
(``rppg_VIDEO.py`` main loop, ``analysis/measurement/green_avg.py``,
``analysis/measurement/ica.py``): frames flow as a ``(T, H, W, 3)`` tensor
through batched detection, ROI reduction and windowed spectral estimation —
every stage jitted, no per-frame Python.

Public measures return the reference's contract: ``(N, 2)`` float arrays of
``[timestamp_s, bpm]`` rows (``analysis/README.md`` measurement contract),
so the analysis harness and metrics are drop-in compatible.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BAND_ANALYSIS, ICAConfig, PipelineConfig
from ..dsp import filters, ica as ica_mod, spectral
from ..models import skin_detector
from ..ops import reduce as vreduce
from ..ops import roi as vroi
from ..ops import windows as vwin

__all__ = [
    "SignalTrace",
    "extract_signals",
    "extract_signals_landmark_roi",
    "extract_signals_polygon",
    "extract_signals_multi",
    "measure_green_avg",
    "measure_green_avg_multi",
    "measure_ica",
    "measure_projection",
    "measure_adaptive",
    "AdaptiveResult",
    "adaptive_pulse_select",
    "measure_app_welch",
    "to_measurement_array",
]

# A detector maps (T, H, W, 3) u8 -> ((T, 4) int32 boxes, (T,) bool valid).
DetectorFn = Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]


class SignalTrace(NamedTuple):
    """Per-frame ROI channel means with tracking metadata."""

    bgr: jnp.ndarray       # (T, 3) float32 ROI channel means (BGR)
    valid: jnp.ndarray     # (T,) bool — detector+holdover validity
    rois: jnp.ndarray      # (T, 4) int32 cheek ROI boxes
    boxes: jnp.ndarray     # (T, 4) int32 face boxes after holdover


def _split_detector(detector: Optional[DetectorFn]):
    """Split a detector into (static fn, traced arg pytree).

    A ``jax.tree_util.Partial`` (e.g. from ``landmarker.make_detector``)
    carries its weights as pytree leaves, so they enter jitted programs as
    *traced arguments* — a plain closure would bake the param tree into the
    compiled program as XLA literal constants (~600 KB of literals and
    slow compiles).
    """
    det = detector or skin_detector.detect_faces
    if isinstance(det, jax.tree_util.Partial):
        if det.keywords:
            # Callers invoke det_fn(*det_args, frames); silently dropping
            # keyword-bound leaves would run with missing/default weights.
            raise ValueError(
                "detector Partial binds keyword args; bind weights "
                "positionally (jax.tree_util.Partial(fn, params))")
        return det.func, tuple(det.args)
    return det, ()


@functools.partial(jax.jit,
                   static_argnames=("cfg", "det_fn", "detect_every"))
def _extract_signals_jit(frames, det_args, cfg, det_fn, detect_every=1):
    T, H, W, _ = frames.shape
    if detect_every > 1:
        # Detection cadence: run the detector on every N-th frame only
        # (static stride, so the conv batch stays a fixed shape) and let
        # the holdover scan track through the not-attempted frames without
        # draining the failure budget (a ported-weights detector's cost
        # divides by N).
        sub = frames[::detect_every]
        b_sub, v_sub = det_fn(*det_args, sub)
        idx = jnp.arange(0, T, detect_every)
        raw_boxes = jnp.zeros((T, 4), b_sub.dtype).at[idx].set(b_sub)
        raw_valid = jnp.zeros((T,), bool).at[idx].set(v_sub)
        attempted = jnp.zeros((T,), bool).at[idx].set(True)
    else:
        raw_boxes, raw_valid = det_fn(*det_args, frames)
        attempted = None
    track = vroi.holdover(raw_boxes, raw_valid, cfg.roi.landmark_hold_frames,
                          attempted=attempted)
    rois = vroi.measurement_roi(track.box, cfg.roi, W, H, cfg.roi_site)
    rois = jnp.where(track.valid[:, None], rois, 0)
    means, _ = vreduce.roi_channel_means(frames, rois)
    return SignalTrace(bgr=means, valid=track.valid, rois=rois,
                       boxes=track.box)


def extract_signals(frames: jnp.ndarray,
                    cfg: PipelineConfig = PipelineConfig(),
                    detector: Optional[DetectorFn] = None,
                    detect_every: int = 1) -> SignalTrace:
    """Frames -> per-frame cheek-ROI channel means (the L2+L3 layers).

    Mirrors ``analysis/utils/roi.py:get_roi`` + the per-frame channel mean
    (``green_avg.py:34``, ``ica.py:48``), including the <=15-frame landmark
    holdover, as one batched program: the detector pass, the holdover scan,
    then the masked ROI reduction.

    ``detect_every`` runs the (possibly pluggable) detector on every N-th
    frame only — tracked frames reuse the box without draining the
    holdover failure budget (``ops.roi.holdover`` ``attempted``
    semantics), so a ported-weights detector's cost divides by N exactly
    like the reference's own detection cadence would.
    """
    det_fn, det_args = _split_detector(detector)
    return _extract_signals_jit(frames, det_args, cfg=cfg, det_fn=det_fn,
                                detect_every=detect_every)


@functools.partial(jax.jit, static_argnames=("cfg", "det_fn",
                                             "detect_every"))
def _extract_signals_lmroi_jit(frames, det_args, cfg, det_fn,
                               detect_every=1):
    T = frames.shape[0]
    if detect_every > 1:
        sub = frames[::detect_every]
        b_sub, r_sub, v_sub = det_fn(*det_args, sub)
        idx = jnp.arange(0, T, detect_every)
        boxes = jnp.zeros((T, 4), b_sub.dtype).at[idx].set(b_sub)
        rois_raw = jnp.zeros((T, 4), r_sub.dtype).at[idx].set(r_sub)
        valid = jnp.zeros((T,), bool).at[idx].set(v_sub)
        attempted = jnp.zeros((T,), bool).at[idx].set(True)
    else:
        boxes, rois_raw, valid = det_fn(*det_args, frames)
        attempted = None
    track_box = vroi.holdover(boxes, valid, cfg.roi.landmark_hold_frames,
                              attempted=attempted)
    # The pose-robust ROI rect rides the SAME holdover scan as the box (a
    # stale cloud's ROI is reused for <=15 frames, roi.py:91-95 rule).
    track_roi = vroi.holdover(rois_raw, valid, cfg.roi.landmark_hold_frames,
                              attempted=attempted)
    rois = jnp.where(track_roi.valid[:, None], track_roi.box, 0)
    means, _ = vreduce.roi_channel_means(frames, rois)
    return SignalTrace(bgr=means, valid=track_roi.valid, rois=rois,
                       boxes=track_box.box)


def extract_signals_landmark_roi(frames: jnp.ndarray, detector,
                                 cfg: PipelineConfig = PipelineConfig(),
                                 detect_every: int = 1
                                 ) -> SignalTrace:
    """Pose-robust :func:`extract_signals`: cheek ROIs carved out of the
    landmark cloud's own (rotated) frame instead of bbox interior ratios.

    ``detector`` maps ``frames -> (boxes, rois, valid)`` — build one with
    ``models.landmarker.make_roi_detector`` or
    ``models.mediapipe_face.make_mediapipe_roi_detector`` (weights arrive
    as a traced ``jax.tree_util.Partial``).  Exceeds the reference, which
    only ever uses the landmark min/max box (``rppg_VIDEO.py:93-103``).
    ``detect_every`` is the same detection cadence as
    :func:`extract_signals` (both the box and ROI tracks hold through
    not-attempted frames without draining the failure budget).
    """
    if isinstance(detector, jax.tree_util.Partial):
        det_fn, det_args = detector.func, tuple(detector.args)
    else:
        det_fn, det_args = detector, ()
    return _extract_signals_lmroi_jit(frames, det_args, cfg=cfg,
                                      det_fn=det_fn,
                                      detect_every=detect_every)


@functools.partial(jax.jit, static_argnames=("cfg", "det_fn",
                                             "detect_every", "grid"))
def _extract_signals_poly_jit(frames, det_args, cfg, det_fn,
                              detect_every=1, grid=32):
    from ..ops import polyroi

    T, H, W, _ = frames.shape
    if detect_every > 1:
        sub = frames[::detect_every]
        b_sub, v_sub, ok_sub = det_fn(*det_args, sub)
        idx = jnp.arange(0, T, detect_every)
        boxes = jnp.zeros((T, 4), b_sub.dtype).at[idx].set(b_sub)
        verts_raw = jnp.zeros((T,) + v_sub.shape[1:],
                              v_sub.dtype).at[idx].set(v_sub)
        valid = jnp.zeros((T,), bool).at[idx].set(ok_sub)
        attempted = jnp.zeros((T,), bool).at[idx].set(True)
    else:
        boxes, verts_raw, valid = det_fn(*det_args, frames)
        attempted = None
    E = verts_raw.shape[1]
    track_box = vroi.holdover(boxes, valid, cfg.roi.landmark_hold_frames,
                              attempted=attempted)
    # The polygon rides the SAME holdover scan as the box: a stale vertex
    # ring is reused for <= hold_frames frames (the lmroi convention, with
    # the ring's 2E floats as the held state instead of a 4-int rect).
    vcarry = (jnp.zeros((2 * E,), verts_raw.dtype), jnp.int32(0),
              jnp.asarray(False))
    track_v, _ = vroi.holdover_with_carry(
        verts_raw.reshape(T, 2 * E), valid, cfg.roi.landmark_hold_frames,
        carry=vcarry, attempted=attempted)
    verts = jnp.where(track_v.valid[:, None, None],
                      track_v.box.reshape(T, E, 2), 0.0)
    means, _ = polyroi.polygon_channel_means(frames, verts, grid=grid)
    rois = jnp.where(track_v.valid[:, None],
                     polyroi.polygon_bbox(verts, W, H), 0)
    return SignalTrace(bgr=means, valid=track_v.valid, rois=rois,
                       boxes=track_box.box)


def extract_signals_polygon(frames: jnp.ndarray, detector,
                            cfg: PipelineConfig = PipelineConfig(),
                            detect_every: int = 1,
                            grid: int = 32) -> SignalTrace:
    """Mesh-polygon skin-mask :func:`extract_signals`: the measured region
    is a convex polygon of face-mesh vertices (default: the cheek-band
    silhouette hull, :data:`vhr_tpu.ops.polyroi.CHEEK_POLY_IDX`) instead
    of a rectangle, so background/hair at the face's sides never enters
    the channel means.  Exceeds the reference, which measures the bbox
    interior rectangle (``analysis/utils/roi.py:53-59``).

    ``detector`` maps ``frames -> (boxes (T, 4), verts (T, E, 2), valid)``
    — build one with ``models.mediapipe_face.make_mediapipe_poly_detector``.
    ``detect_every``/holdover semantics match
    :func:`extract_signals_landmark_roi`; ``grid`` is the mask/resample
    resolution (:func:`vhr_tpu.ops.polyroi.polygon_channel_means`).
    """
    if isinstance(detector, jax.tree_util.Partial):
        det_fn, det_args = detector.func, tuple(detector.args)
    else:
        det_fn, det_args = detector, ()
    return _extract_signals_poly_jit(frames, det_args, cfg=cfg,
                                     det_fn=det_fn,
                                     detect_every=detect_every, grid=grid)


@functools.partial(jax.jit,
                   static_argnames=("k_faces", "cfg", "det", "det_fn",
                                    "detect_every"))
def _extract_signals_multi_jit(frames, det_args, k_faces, cfg, det, det_fn,
                               detect_every=1):
    from ..models import multiface

    T, H, W, _ = frames.shape

    def detect(fr):
        if det_fn is None:
            return multiface.detect_faces_multi(fr, k_faces, det)
        return det_fn(*det_args, fr)

    if detect_every > 1:
        # Detection cadence, multi-face: every N-th frame detects, the
        # K-track holdover holds identity through the rest without
        # draining budgets (ops.roi.holdover_multi attempted semantics).
        sub = frames[::detect_every]
        b_sub, v_sub = detect(sub)
        idx = jnp.arange(0, T, detect_every)
        raw_boxes = jnp.zeros((T, k_faces, 4), b_sub.dtype).at[idx].set(b_sub)
        raw_valid = jnp.zeros((T, k_faces), bool).at[idx].set(v_sub)
        attempted = jnp.zeros((T,), bool).at[idx].set(True)
    else:
        raw_boxes, raw_valid = detect(frames)
        attempted = None

    track = vroi.holdover_multi(raw_boxes, raw_valid,
                                cfg.roi.landmark_hold_frames,
                                attempted=attempted)  # (T, K, ...)

    rois = vroi.measurement_roi(track.box, cfg.roi, W, H,
                                cfg.roi_site)                # (T, K, 4)
    rois = jnp.where(track.valid[..., None], rois, 0)

    means, _ = vreduce.roi_channel_means_multi(frames, rois)  # (T, K, 3)
    return SignalTrace(bgr=means, valid=track.valid, rois=rois,
                       boxes=track.box)


def extract_signals_multi(frames: jnp.ndarray, k_faces: int = 2,
                          cfg: PipelineConfig = PipelineConfig(),
                          det=None, detector=None,
                          detect_every: int = 1) -> SignalTrace:
    """Multi-subject :func:`extract_signals`: per-face cheek-ROI means.

    Top-``k_faces`` skin regions per frame (``models.multiface``), identity-
    matched per-face <=15-frame holdover, per-face masked ROI reduction.
    Exceeds the reference, which requests ``num_faces=2`` but processes only
    ``face_landmarks[0]`` (``rppg_LIVESTREAM.py:308,339``).

    ``detector`` overrides the detection stage with any callable of the
    multi-face interface ``frames -> (boxes (T, K, 4), valid (T, K))`` —
    e.g. ``models.cascade.make_cascade_detector_multi`` (skin proposals
    refined by the learned landmarker; weights arrive as a traced
    ``jax.tree_util.Partial``).  ``det`` tunes the default skin detector.

    Returns a :class:`SignalTrace` with a face axis on every field:
    ``bgr (T, K, 3)``, ``valid (T, K)``, ``rois/boxes (T, K, 4)``.
    """
    det = det or skin_detector.SkinDetectorConfig()
    if detector is None:
        det_fn, det_args = None, ()
    elif isinstance(detector, jax.tree_util.Partial):
        det_fn, det_args = detector.func, tuple(detector.args)
    else:
        det_fn, det_args = detector, ()
    return _extract_signals_multi_jit(frames, det_args, k_faces=k_faces,
                                      cfg=cfg, det=det, det_fn=det_fn,
                                      detect_every=detect_every)


def measure_green_avg_multi(frames: jnp.ndarray, fps: float,
                            k_faces: int = 2,
                            cfg: PipelineConfig = PipelineConfig(),
                            det=None, detector=None, trace=None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-face green-channel BPM traces: ``(ts (T,), bpm (T, K), valid
    (T, K))`` — K independent subjects monitored from one clip.

    Pass ``trace`` (a multi-face :class:`SignalTrace` from
    :func:`extract_signals_multi`) to reuse an extraction you already have
    — callers that also want the boxes/ROIs (e.g. the annotating video app)
    would otherwise run detection twice.
    """
    if trace is None:
        trace = extract_signals_multi(frames, k_faces, cfg, det, detector)
    elif trace.bgr.shape[1] != k_faces:
        # jnp index clamping would silently duplicate a face otherwise.
        raise ValueError(f"trace has {trace.bgr.shape[1]} face slots, "
                         f"k_faces={k_faces}")
    T = frames.shape[0]
    ts = np.arange(T) / fps
    # One vmapped dispatch over the face axis (not K separate rolling_bpm
    # programs): forward-fill and the rolling estimator are pure static-
    # shape jnp, so the K traces batch into a single XLA call.
    green = jax.vmap(_fill_invalid, in_axes=1)(
        trace.bgr[:, :, cfg.channel], trace.valid)         # (K, T)
    rolling = jax.vmap(lambda g: vwin.rolling_bpm(
        g, fps, cfg.band, cfg.window_len(fps), cfg.acquisition_len(fps),
        estimator=cfg.estimator,
        segment_seconds=cfg.welch.segment_seconds))(green)
    bpm = np.asarray(rolling.bpm).T.astype(np.float32)     # (T, K)
    ok = np.asarray(jnp.logical_and(rolling.valid.T, trace.valid))
    return ts, bpm, ok


def _fill_invalid(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Carry the last valid sample forward over dropouts (scan).

    Delegates to the shared primitive (``dsp.filters.forward_fill``) with
    zero init — leading-invalid frames stay 0 (reference parity; they are
    masked out downstream regardless).
    """
    from ..dsp.filters import forward_fill
    return forward_fill(x, valid, init="zeros")


def measure_green_avg(frames: jnp.ndarray, fps: float,
                      cfg: PipelineConfig = PipelineConfig(),
                      detector: Optional[DetectorFn] = None,
                      detect_every: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The canonical green-channel measure (``green_avg.py:11-52``).

    Returns per-frame ``(timestamps, bpm, valid)`` arrays; see
    :func:`to_measurement_array` for the reference's (N, 2) contract.
    """
    trace = extract_signals(frames, cfg, detector,
                            detect_every=detect_every)
    green = _fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
    rolling = vwin.rolling_bpm(
        green, fps, cfg.band,
        window_len=cfg.window_len(fps),
        acquisition_len=cfg.acquisition_len(fps),
        estimator=cfg.estimator,
        segment_seconds=cfg.welch.segment_seconds)
    T = frames.shape[0]
    ts = np.arange(T) / fps
    valid = jnp.logical_and(rolling.valid, trace.valid)
    return ts, np.asarray(rolling.bpm), np.asarray(valid)


def measure_projection(frames: jnp.ndarray, fps: float,
                       method: str = "pos",
                       cfg: PipelineConfig = PipelineConfig(),
                       detector: Optional[DetectorFn] = None,
                        detect_every: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chrominance-projection measures: ``method`` in {"chrom", "pos",
    "omit"}.

    Same contract as :func:`measure_green_avg` but the scalar pulse comes
    from a motion-robust RGB projection (``dsp.projections``) instead of
    the raw green mean — beyond the reference's method set
    (``analysis/measurement/``), these reject common-mode intensity
    changes (lighting flicker, small motion) by construction.
    """
    from ..dsp.projections import chrom_pulse, omit_pulse, pos_pulse

    trace = extract_signals(frames, cfg, detector,
                            detect_every=detect_every)
    fn = {"chrom": chrom_pulse, "pos": pos_pulse,
          "omit": omit_pulse}[method]
    pulse = fn(trace.bgr, trace.valid, fps)
    rolling = vwin.rolling_bpm(
        pulse, fps, cfg.band,
        window_len=cfg.window_len(fps),
        acquisition_len=cfg.acquisition_len(fps),
        estimator=cfg.estimator,
        segment_seconds=cfg.welch.segment_seconds)
    T = frames.shape[0]
    ts = np.arange(T) / fps
    valid = jnp.logical_and(rolling.valid, trace.valid)
    return ts, np.asarray(rolling.bpm), np.asarray(valid)


class AdaptiveResult(NamedTuple):
    ts: np.ndarray        # (T,) seconds
    bpm: np.ndarray       # (T,) selected-method estimate
    valid: np.ndarray     # (T,) bool
    choice: np.ndarray    # (T,) int index into `methods` (0 during ramp)
    snr: np.ndarray       # (M, T) per-method in-band SNR (-inf during ramp)


def adaptive_pulse_select(bgr: jnp.ndarray, valid: jnp.ndarray, fps: float,
                          cfg: PipelineConfig = PipelineConfig(),
                          methods: Tuple[str, ...] = ("green", "chrom",
                                                      "pos", "omit")):
    """Per-window best-of-breed pulse selection from (T, 3) BGR ROI means.

    Builds every candidate pulse construction (raw green mean plus the
    CHROM/POS/OMIT chrominance projections, ``dsp.projections``) and takes
    each frame's BPM from the best-scoring method.  Scoring is
    consensus-anchored SNR: each window is scored by its spectral power
    near the *cross-method median* BPM (``dsp.spectral.band_snr`` with
    ``target_bpm``), not near its own peak — a method captured by a strong
    off-consensus periodicity (the green mean under in-band intensity
    flicker) concentrates its energy away from the consensus and scores
    near zero, while self-peak SNR would reward exactly that failure.
    Rationale: the projections dominate under common-mode artifacts but
    the raw green mean is the lower-noise choice on clean, still footage —
    the best method is a property of the *window*, not the recording.  No
    reference counterpart (the reference fixes one method per run,
    ``analysis/main.py:79-81``); ``methods[0]`` serves ramp frames, where
    no full window exists to score.

    Returns ``(bpm (T,), valid (T,), choice (T,), snr (M, T))`` as jnp
    arrays.
    """
    from ..dsp.projections import chrom_pulse, omit_pulse, pos_pulse

    builders = {
        "green": lambda: _fill_invalid(bgr[:, cfg.channel], valid),
        "chrom": lambda: chrom_pulse(bgr, valid, fps),
        "pos": lambda: pos_pulse(bgr, valid, fps),
        "omit": lambda: omit_pulse(bgr, valid, fps),
    }
    W = cfg.window_len(fps)
    A = cfg.acquisition_len(fps)
    pulses, bpms, oks = [], [], []
    for m in methods:
        pulse = builders[m]()
        rolling = vwin.rolling_bpm(
            pulse, fps, cfg.band, window_len=W, acquisition_len=A,
            estimator=cfg.estimator,
            segment_seconds=cfg.welch.segment_seconds)
        pulses.append(pulse)
        bpms.append(rolling.bpm)
        oks.append(rolling.valid)
    bpm_m = jnp.stack(bpms)                              # (M, T)
    ok_m = jnp.stack(oks)
    # Cross-method consensus frequency per frame (median over valid
    # methods; frames with no valid method keep a harmless 0 target).
    consensus = jnp.nanmedian(
        jnp.where(ok_m, bpm_m, jnp.nan), axis=0)         # (T,)
    consensus = jnp.nan_to_num(consensus)
    snr_m = jnp.stack([
        vwin.rolling_band_snr(p, fps, cfg.band, W, target_bpm=consensus)
        for p in pulses])                                # (M, T)
    # Invalid methods never win; all -inf (ramp) -> argmax picks index 0.
    ranked = jnp.where(ok_m, snr_m, -jnp.inf)
    choice = jnp.argmax(ranked, axis=0)                  # (T,)
    take = lambda a: jnp.take_along_axis(a, choice[None, :], axis=0)[0]
    return take(bpm_m), take(ok_m), choice, snr_m


def measure_adaptive(frames: jnp.ndarray, fps: float,
                     cfg: PipelineConfig = PipelineConfig(),
                     detector: Optional[DetectorFn] = None,
                     methods: Tuple[str, ...] = ("green", "chrom",
                                                 "pos", "omit"),
                     detect_every: int = 1
                     ) -> AdaptiveResult:
    """Adaptive measurement: per-window SNR-ranked method selection.

    Same front end as :func:`measure_green_avg` (detector -> ROI -> BGR
    means) but the estimate behind each frame comes from whichever pulse
    construction scores the highest in-band SNR on that frame's window —
    see :func:`adaptive_pulse_select`.  ``AdaptiveResult.choice``/``snr``
    expose the selection for observability.
    """
    trace = extract_signals(frames, cfg, detector,
                            detect_every=detect_every)
    bpm, ok, choice, snr = adaptive_pulse_select(
        trace.bgr, trace.valid, fps, cfg, methods)
    T = frames.shape[0]
    ts = np.arange(T) / fps
    valid = jnp.logical_and(ok, trace.valid)
    return AdaptiveResult(ts=ts, bpm=np.asarray(bpm),
                          valid=np.asarray(valid),
                          choice=np.asarray(choice), snr=np.asarray(snr))


def measure_ica(frames: jnp.ndarray, fps: float,
                cfg: PipelineConfig = PipelineConfig(),
                icacfg: ICAConfig = ICAConfig(),
                detector: Optional[DetectorFn] = None,
                detect_every: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ICA measure (``analysis/measurement/ica.py:14-78``).

    Per frame after acquisition: std-normalize the (window, 3) BGR means
    (ddof=1, ``ica.py:59-61``), FastICA, skip non-converged windows, pick the
    best independent component's in-band FFT peak.  All windows solve as one
    vmapped batch instead of one sklearn fit per frame.
    """
    trace = extract_signals(frames, cfg, detector,
                            detect_every=detect_every)
    bgr = _fill_invalid(trace.bgr, trace.valid)             # (T, 3)
    T = frames.shape[0]
    window_len = int(icacfg.window_seconds * fps)
    acq_len = int(icacfg.acquisition_seconds * fps)
    ts = np.arange(T) / fps
    bpm = np.zeros(T, np.float32)
    valid = np.zeros(T, bool)
    first = acq_len - 1
    if first >= T:
        return ts, bpm, valid

    w_init = ica_mod.default_w_init(icacfg.n_components, icacfg.seed)

    def _masked_norm(wins, n_valid):
        """Per-window std-normalize (ddof=1) over valid rows (ica.py:59-61)."""
        keep = (jnp.arange(wins.shape[1]) < n_valid[:, None])[..., None]
        n = n_valid.astype(wins.dtype)[:, None, None]
        mean = jnp.sum(jnp.where(keep, wins, 0.0), axis=1, keepdims=True) / n
        var = jnp.sum(jnp.where(keep, (wins - mean) ** 2, 0.0),
                      axis=1, keepdims=True) / (n - 1.0)
        std = jnp.sqrt(var)
        std = jnp.where(std == 0, 1.0, std)
        return jnp.where(keep, wins / std, 0.0)

    @jax.jit
    def run_ramp(prefix, n_valids):
        """All growing windows bgr[:N] for N in n_valids, one compile."""
        wins = jnp.broadcast_to(prefix[None], (n_valids.shape[0],) + prefix.shape)
        norm = _masked_norm(wins, n_valids)
        res = ica_mod.ica_sources(norm, w_init, icacfg.max_iter, icacfg.tol,
                                  n_valid=n_valids)
        est = jax.vmap(lambda s, nv: spectral.estimate_bpm_multichannel_exact(
            s, nv, fps, cfg.band))(res.sources, n_valids)
        return est.bpm, jnp.logical_and(est.valid, res.converged)

    @jax.jit
    def run_steady(wins):
        n = wins.shape[1]
        std = jnp.std(wins, axis=1, keepdims=True) * jnp.sqrt(n / (n - 1.0))
        std = jnp.where(std == 0, 1.0, std)
        res = ica_mod.ica_sources(wins / std, w_init, icacfg.max_iter,
                                  icacfg.tol)
        est = spectral.estimate_bpm_multichannel(res.sources, fps, cfg.band)
        return est.bpm, jnp.logical_and(est.valid, res.converged)

    # Ramp: frame i sees bgr[:i+1] (deque still filling, ica.py:31-38).
    ramp_end = min(window_len - 1, T - 1)
    if ramp_end >= first:
        lengths = jnp.arange(first + 1, ramp_end + 2)
        b, v = run_ramp(bgr[: ramp_end + 1], lengths)
        bpm[first:ramp_end + 1] = np.asarray(b)
        valid[first:ramp_end + 1] = np.asarray(v)
    # Steady: full-length sliding windows as one batch.
    if T >= window_len:
        wins = vwin.sliding_windows(bgr, window_len)        # (T-W+1, W, 3)
        b, v = run_steady(wins)
        bpm[window_len - 1:] = np.asarray(b)
        valid[window_len - 1:] = np.asarray(v)

    valid &= np.asarray(trace.valid)
    return ts, bpm, valid


def measure_app_welch(frames: jnp.ndarray, fps: float,
                      cfg: PipelineConfig = PipelineConfig(),
                      detector: Optional[DetectorFn] = None,
                      detect_every: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The interactive app's analysis loop (``rppg_VIDEO.py:392-415``):
    10 s sliding window, demean, zero-phase bandpass (per ``cfg.filter``),
    Welch PSD peak.  Runs every window as one batched program."""
    from ..dsp import design

    trace = extract_signals(frames, cfg, detector,
                            detect_every=detect_every)
    green = _fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
    T = frames.shape[0]
    window_len = cfg.window_len(fps)
    ts = np.arange(T) / fps
    bpm = jnp.zeros(T, jnp.float32)
    valid = jnp.zeros(T, bool)
    # Reference condition: len(deque) > window_len  (rppg_VIDEO.py:396).
    if T <= window_len:
        return ts, np.asarray(bpm), np.asarray(valid)

    wins = vwin.sliding_windows(green, window_len)[1:]      # frames W..T-1
    wins = wins - jnp.mean(wins, axis=-1, keepdims=True)

    fc = cfg.filter
    if fc.kind == "fir":
        b = design.firwin_bandpass(fc.fir_numtaps,
                                   cfg.band.low_hz / (0.5 * fps),
                                   cfg.band.high_hz / (0.5 * fps))
        filt = filters.filtfilt_fir(b, wins.T).T
    else:
        sos = design.sos_design(fc.kind, fps, cfg.band.low_hz,
                                cfg.band.high_hz, fc.order,
                                fc.cheby2_stop_atten_db)
        filt = filters.sosfiltfilt(sos, wins.T).T

    est = spectral.estimate_bpm_welch(filt, fps, cfg.band,
                                      cfg.welch.segment_seconds)
    bpm = bpm.at[window_len:].set(est.bpm)
    valid = valid.at[window_len:].set(est.valid)
    valid = jnp.logical_and(valid, trace.valid)
    return ts, np.asarray(bpm), np.asarray(valid)


def extract_signals_streaming(video_path: str,
                              cfg: PipelineConfig = PipelineConfig(),
                              detector: Optional[DetectorFn] = None,
                              chunk_frames: int = 256,
                              prefer_native: bool = True,
                              ring_stats: Optional[dict] = None,
                              n_decoders: int = 1,
                              detect_every: int = 1,
                              transfer: str = "bgr"):
    """Chunked-decode signal extraction for long recordings.

    The reference eagerly reads whole videos into RAM
    (``analysis/utils/video_io.py:26-31`` — its long-context limiter).  Here
    frames stream in fixed-size chunks (the threaded C++ framestore when
    available, cv2 otherwise); the detector + ROI reduction run per chunk
    with the landmark-holdover scan state carried across chunk boundaries,
    so results are identical to a whole-video pass.

    Returns ``(bgr (T, 3), valid (T,), fps)`` host arrays.  If
    ``ring_stats`` is a dict it is filled with the native staging-ring
    occupancy counters (who stalled on whom — see
    ``io.native.NativeVideoReader.stats``).  ``n_decoders > 1`` decodes
    disjoint segments in parallel on the native reader (SURVEY §7 risk (b));
    output order and values are unchanged.

    ``detect_every`` (must divide ``chunk_frames``) applies the detection
    cadence of :func:`extract_signals` across chunk boundaries: every
    chunk starts on a detection frame, holdover tracks through the rest
    without draining the failure budget.

    ``transfer="i420"`` stages planar YUV 4:2:0 from the native decoder
    (1.5 B/px) and reconstructs BGR on device (bit-exact vs OpenCV,
    ``ops.color.i420_to_bgr_flat``) — half the host->device bytes of BGR
    staging.  Requires the native reader and even frame dimensions; falls
    back to BGR staging otherwise.
    """
    import jax

    from ..io import video as vio
    from ..models import skin_detector as sd
    from ..ops import roi as vroi_mod

    if detect_every > 1 and chunk_frames % detect_every != 0:
        # Chunk-aligned cadence keeps the per-chunk detection stride
        # static (every chunk starts on a detection frame), so the conv
        # batch shape never depends on the traced phase.
        raise ValueError("detect_every must divide chunk_frames")
    det_fn, det_args = _split_detector(detector)

    if transfer not in ("bgr", "i420"):
        raise ValueError(f"transfer must be 'bgr' or 'i420', got {transfer!r}")
    reader = None
    if prefer_native:
        try:
            from ..io import native
            if native.is_available():
                try:
                    reader = native.NativeVideoReader(
                        video_path, chunk_frames=chunk_frames,
                        n_decoders=n_decoders, fmt=transfer)
                except IOError:
                    if transfer != "i420":
                        raise
                    # odd dimensions: I420 refused — stage BGR instead
                    transfer = "bgr"
                    reader = native.NativeVideoReader(
                        video_path, chunk_frames=chunk_frames,
                        n_decoders=n_decoders)
        except Exception:
            reader = None
    if reader is None:
        transfer = "bgr"      # cv2 fallback reader yields BGR chunks

    if transfer == "i420":
        from ..ops import color as vcolor
        _h, _w = reader.height, reader.width
        _wpad = -(-_w // 128) * 128  # the BGR staging rows' padded width

        def _to_flat_bgr(raw):
            # Device-side planar->interleaved reconstruction; the padded
            # zero columns match the BGR staging path's row padding.
            return vcolor.i420_to_bgr_flat(raw, _h, _w, _wpad)
    else:
        _to_flat_bgr = None

    @jax.jit
    def chunk_step_i420(raw, det_args, carry):
        # Plane-domain path (ingest-native): only the detection-cadence
        # frames reconstruct to BGR (the detector needs pixels); the
        # ROI channel means come straight off the Y/U/V planes via the
        # affine map (ops/color.py::i420_roi_means) — RGB for the other
        # frames never materializes, cutting the per-chunk memory traffic
        # from ~(1.5 read + 3 write + 3 read) B/px to ~1.5 B/px + the
        # reconstructed detection subset.
        T = raw.shape[0]
        sub = _to_flat_bgr(raw[::detect_every])
        S, H, WC = sub.shape
        W = WC // 3
        frames_sub = sub.reshape(S, H, W, 3)
        b_sub, v_sub = det_fn(*det_args, frames_sub)
        if detect_every > 1:
            idx = jnp.arange(0, T, detect_every)
            boxes = jnp.zeros((T, 4), b_sub.dtype).at[idx].set(b_sub)
            valid = jnp.zeros((T,), bool).at[idx].set(v_sub)
            attempted = jnp.zeros((T,), bool).at[idx].set(True)
        else:
            boxes, valid, attempted = b_sub, v_sub, None
        track, carry = vroi_mod.holdover_with_carry(
            boxes, valid, cfg.roi.landmark_hold_frames, carry,
            attempted=attempted)
        rois = vroi_mod.measurement_roi(track.box, cfg.roi, W, H,
                                        cfg.roi_site)
        rois = jnp.where(track.valid[:, None], rois, 0)
        # clamp out of the zero pad columns: the plane tensors are
        # true-width
        rois = jnp.stack([rois[:, 0], rois[:, 1],
                          jnp.minimum(rois[:, 2], _w),
                          jnp.minimum(rois[:, 3], _h)], axis=1)
        means, _ = vcolor.i420_roi_means(raw, rois, _h, _w)
        return means, track.valid, carry

    @jax.jit
    def chunk_step(frames_flat, det_args, carry):
        T, H, WC = frames_flat.shape
        W = WC // 3
        frames = frames_flat.reshape(T, H, W, 3)
        if detect_every > 1:
            # Chunk starts are multiples of chunk_frames (hence of
            # detect_every), so frame 0 of every chunk detects — the
            # [0::N] stride is globally phase-correct.
            sub = frames[::detect_every]
            b_sub, v_sub = det_fn(*det_args, sub)
            idx = jnp.arange(0, T, detect_every)
            boxes = jnp.zeros((T, 4), b_sub.dtype).at[idx].set(b_sub)
            valid = jnp.zeros((T,), bool).at[idx].set(v_sub)
            attempted = jnp.zeros((T,), bool).at[idx].set(True)
        else:
            boxes, valid = det_fn(*det_args, frames)
            attempted = None
        track, carry = vroi_mod.holdover_with_carry(
            boxes, valid, cfg.roi.landmark_hold_frames, carry,
            attempted=attempted)
        rois = vroi_mod.measurement_roi(track.box, cfg.roi, W, H,
                                        cfg.roi_site)
        rois = jnp.where(track.valid[:, None], rois, 0)
        means, _ = vreduce.roi_channel_means(frames, rois)
        return means, track.valid, carry

    if _to_flat_bgr is not None:
        chunk_step = chunk_step_i420      # plane-domain means path
    carry = (jnp.zeros((4,), jnp.int32), jnp.int32(0),
             jnp.asarray(False))

    # Chunks cross to the device as (T, H, W*3): a free numpy view of the
    # reader's contiguous buffer; the in-jit 4D reshape is a bitcast.
    def prep(c):
        if c.ndim == 2:       # i420 staging buffer: ship bytes as-is
            return jnp.asarray(c)
        return jnp.asarray(c.reshape(c.shape[0], c.shape[1], -1))

    bgr_parts, valid_parts = [], []
    if reader is not None:
        fps = reader.fps
        with reader:
            t_wait = t_dev = 0.0
            it = iter(reader)
            while True:
                t0 = time.perf_counter()
                chunk = next(it, None)           # blocks on the decode ring
                t_wait += time.perf_counter() - t0
                if chunk is None:
                    break
                t0 = time.perf_counter()
                m, v, carry = chunk_step(prep(chunk), det_args, carry)
                bgr_parts.append(np.asarray(m))  # fetch = device sync
                valid_parts.append(np.asarray(v))
                t_dev += time.perf_counter() - t0
            if ring_stats is not None:
                ring_stats.update(reader.stats())
                # Sizing verdict (VERDICT r3 #7): which side is the
                # bottleneck on THIS host/chip pair.  wait = host blocked on
                # the decode ring; device = dispatch + fetch (includes the
                # host->device link).  The counter form (consumer_blocked vs
                # producer_blocked) tells the same story ring-side.
                ring_stats["host_wait_on_decode_s"] = round(t_wait, 3)
                ring_stats["device_dispatch_fetch_s"] = round(t_dev, 3)
                total = t_wait + t_dev
                ring_stats["verdict"] = (
                    "decode-bound" if t_wait > t_dev else "device-bound")
                ring_stats["decode_wait_fraction"] = (
                    round(t_wait / total, 3) if total > 0 else 0.0)
    else:
        fps = None
        for chunk, f, _ in vio.iter_video_chunks(video_path, chunk_frames):
            fps = f
            m, v, carry = chunk_step(prep(chunk), det_args, carry)
            bgr_parts.append(np.asarray(m))
            valid_parts.append(np.asarray(v))
    if not bgr_parts:
        return np.zeros((0, 3), np.float32), np.zeros(0, bool), fps or 0.0
    return (np.concatenate(bgr_parts), np.concatenate(valid_parts),
            float(fps))


def measure_green_avg_file(video_path: str,
                           cfg: PipelineConfig = PipelineConfig(),
                           detector: Optional[DetectorFn] = None,
                           chunk_frames: int = 256,
                           detect_every: int = 1
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Streaming-decode variant of :func:`measure_green_avg` (bounded RAM)."""
    import jax.numpy as jnp_

    from ..ops import windows as vwin_mod

    bgr, valid, fps = extract_signals_streaming(
        video_path, cfg, detector, chunk_frames,
        detect_every=detect_every)
    T = bgr.shape[0]
    ts = np.arange(T) / fps if T else np.zeros(0)
    if T == 0:
        return ts, np.zeros(0, np.float32), np.zeros(0, bool)
    green = _fill_invalid(jnp_.asarray(bgr[:, cfg.channel]),
                          jnp_.asarray(valid))
    rolling = vwin_mod.rolling_bpm(green, fps, cfg.band,
                                   cfg.window_len(fps),
                                   cfg.acquisition_len(fps),
                                   estimator=cfg.estimator,
                                   segment_seconds=cfg.welch.segment_seconds)
    ok = np.asarray(rolling.valid) & valid
    return ts, np.asarray(rolling.bpm), ok


def to_measurement_array(ts: np.ndarray, bpm: np.ndarray,
                         valid: np.ndarray) -> np.ndarray:
    """Collapse per-frame results to the reference's ``(N, 2)`` contract
    (rows only where an estimate exists, ``green_avg.py:47-52``)."""
    keep = np.asarray(valid, bool)
    return np.column_stack([np.asarray(ts)[keep],
                            np.asarray(bpm, np.float64)[keep]])
