"""Live streaming rPPG: a carried-state step function compiled once.

A pure-function re-design of ``rppg_LIVESTREAM.py``: the reference mutates global
deques and a module-level SOS state from an async MediaPipe callback
(``rppg_LIVESTREAM.py:39-41,224-251`` — a benign data race by design,
SURVEY.md §5).  Here the entire per-frame update is one pure function
``(state, frame) -> (state, output)``: detector, landmark holdover, ROI
mean, one causal SOS step (``live_sos_push`` semantics), ring-buffer write,
and a masked Welch BPM — jitted once, so the host loop is a single device
dispatch per frame (the 33 ms latency budget path, BASELINE config 4).
``vmap`` the step to monitor many webcams per device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BAND_LIVE, HRBand, PipelineConfig, ROIConfig
from ..dsp import design, filters
from ..models import skin_detector
from ..ops import reduce as vreduce
from ..ops import roi as vroi

__all__ = ["LiveConfig", "LiveState", "LiveOutput", "init_state", "step",
           "make_step", "MultiLiveState", "init_state_multi", "step_multi",
           "make_step_multi", "LivePipeline", "bgr_to_i420_host",
           "pack_output", "unpack_output"]


def pack_output(o: "LiveOutput") -> "jnp.ndarray":
    """LiveOutput -> one ``(..., 10)`` float32 tensor (in-jit), so the whole
    step result crosses to the host as ONE fetch — per-field fetches cost a
    device->host transfer each.  Inverse: :func:`unpack_output`.  Shared by
    the live pipeline and the serving pool (the 10-slot layout is
    load-bearing in both)."""
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return jnp.concatenate([
        jnp.stack([f32(o.bpm), f32(o.bpm_valid), f32(o.green_raw),
                   f32(o.green_filtered), f32(o.face_valid)], axis=-1),
        f32(o.box),
        f32(o.choice)[..., None]], axis=-1)


def unpack_output(a: "np.ndarray") -> "LiveOutput":
    """Inverse of :func:`pack_output` (host side)."""
    return LiveOutput(bpm=a[..., 0], bpm_valid=a[..., 1] > 0.5,
                      green_raw=a[..., 2], green_filtered=a[..., 3],
                      box=a[..., 5:9].astype(np.int32),
                      face_valid=a[..., 4] > 0.5,
                      choice=a[..., 9].astype(np.int32))


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    band: HRBand = BAND_LIVE                    # rppg_LIVESTREAM.py:34-35
    filter_order: int = 4                       # rppg_LIVESTREAM.py:299
    ring_len: int = 500                         # deque maxlen, :15-17
    welch_segment_seconds: float = 9.0          # :146
    roi: ROIConfig = ROIConfig()
    fps: float = 30.0
    # Detection cadence: run detection on every N-th wall frame only
    # (``frame_idx`` phase), tracking through the rest without draining
    # the holdover failure budget (``ops.roi.holdover`` attempted
    # semantics).  The detector is ``lax.cond``-gated, so skipped frames
    # pay no detector compute.
    detect_every: int = 1
    # Measurement site ("cheek" | "forehead"; PipelineConfig.roi_site
    # semantics).
    roi_site: str = "cheek"
    # Pulse construction on the live surface.  "green" is reference parity
    # (raw green mean -> causal SOS -> Welch, rppg_LIVESTREAM.py:245-251).
    # "chrom" | "pos" | "omit" recompute the motion-robust projection
    # (dsp.projections) over the BGR-means ring each tick: once the ring
    # is full this is EXACTLY the offline pulse over the trailing
    # ring_len frames (pinned in tests/test_live.py).  "adaptive" builds
    # all of ``adaptive_methods`` and takes each tick's BPM from the
    # method with the best consensus-anchored Welch SNR — the live
    # counterpart of pipeline.offline.adaptive_pulse_select (the
    # reference's streaming mode has only green).
    method: str = "green"
    proj_window_seconds: float = 1.6
    adaptive_methods: Tuple[str, ...] = ("green", "chrom", "pos", "omit")
    snr_guard_bins: int = 1


class LiveState(NamedTuple):
    ring_raw: jnp.ndarray     # (N,) raw green samples (circular)
    ring_filt: jnp.ndarray    # (N,) causally-filtered samples (circular)
    count: jnp.ndarray        # () total samples written
    zi: jnp.ndarray           # (S, 2) streaming SOS state
    last_box: jnp.ndarray     # (4,) last face box
    hold_budget: jnp.ndarray  # () remaining reuse frames
    has_last: jnp.ndarray     # () bool
    frame_idx: jnp.ndarray    # () wall-frame counter (advances every frame,
                              # valid or not — the detect_every cadence
                              # phase, so it tracks wall time even through
                              # track loss)
    ring_bgr: jnp.ndarray     # (N, 3) raw BGR ROI means (circular, same
                              # pointer as ring_raw) — the projection
                              # methods' input window


class LiveOutput(NamedTuple):
    bpm: jnp.ndarray
    bpm_valid: jnp.ndarray
    green_raw: jnp.ndarray
    green_filtered: jnp.ndarray
    box: jnp.ndarray
    face_valid: jnp.ndarray
    # Index into cfg.adaptive_methods behind this tick's BPM (0 for
    # non-adaptive methods) — selection observability, mirroring
    # offline.AdaptiveResult.choice.
    choice: jnp.ndarray


def _sos(cfg: LiveConfig) -> np.ndarray:
    return design.sos_design("butterworth", cfg.fps, cfg.band.low_hz,
                             cfg.band.high_hz, cfg.filter_order)


def init_state(cfg: LiveConfig = LiveConfig()) -> LiveState:
    """Zeroed state, mirroring ``live_sos_init`` (rppg_LIVESTREAM.py:230-234)."""
    n_sections = _sos(cfg).shape[0]
    return LiveState(
        ring_raw=jnp.zeros((cfg.ring_len,), jnp.float32),
        ring_filt=jnp.zeros((cfg.ring_len,), jnp.float32),
        count=jnp.int32(0),
        zi=jnp.zeros((n_sections, 2), jnp.float32),
        last_box=jnp.zeros((4,), jnp.int32),
        hold_budget=jnp.int32(0),
        has_last=jnp.asarray(False),
        frame_idx=jnp.int32(0),
        ring_bgr=jnp.zeros((cfg.ring_len, 3), jnp.float32),
    )


def _masked_welch_psd(ordered: jnp.ndarray, n_valid: jnp.ndarray,
                      fps: float, band: HRBand, segment_seconds: float):
    """Masked Welch core over the chronologically-ordered ring:
    -> ``(mean_psd (B,), band_freqs (B,) np.ndarray, valid ())`` or
    ``None`` for a degenerate band/fps config.  Shared by the BPM peak
    pick (:func:`_masked_welch_bpm`) and the adaptive selector's SNR
    scoring (:func:`_method_bpm`)."""
    N = ordered.shape[0]
    nperseg = int(min(N, fps * segment_seconds))
    noverlap = nperseg // 2
    step_len = nperseg - noverlap
    n_segments = (N - noverlap) // step_len

    # Segments anchor at the start of the *valid suffix* (scipy's welch
    # anchors at the deque's oldest sample), so during ring fill the newest
    # 9 s segment is used as soon as it exists.
    base = N - n_valid
    starts = jnp.asarray(np.arange(n_segments) * step_len)
    idx = (base + starts[:, None]
           + jnp.asarray(np.arange(nperseg))[None, :])       # (S, L)
    idx = jnp.minimum(idx, N - 1)
    segs = ordered[idx]                                      # (S, L)
    seg_ok = starts + nperseg <= n_valid                     # (S,)

    # Demean over valid data only (the reference demeans the whole deque).
    total = jnp.sum(ordered) / jnp.maximum(n_valid.astype(jnp.float32), 1.0)
    segs = segs - total
    segs = segs - jnp.mean(segs, axis=-1, keepdims=True)     # detrend const

    # Banded DFT as two dense matmuls instead of a full rfft: the peak
    # search only needs the in-band bins (~17 of 136 at 30 fps / 9 s
    # segments).  Same windowing, scaling, and bin grid as scipy's welch;
    # the argmax bin (hence the BPM) is unchanged (pinned vs scipy in
    # tests/test_live.py).  Exact f32: TF32 would round the pixel-scale
    # segment samples to ~11 significant bits.
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / fps)
    band_idx = np.where((freqs >= band.low_hz) & (freqs <= band.high_hz))[0]
    if band_idx.size == 0:               # degenerate band/fps config
        return None
    ang = (2.0 * np.pi / nperseg) * np.outer(np.arange(nperseg), band_idx)
    cos_m = jnp.asarray(np.cos(ang) * win[:, None], jnp.float32)  # (L, B)
    sin_m = jnp.asarray(np.sin(ang) * win[:, None], jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    re = jnp.matmul(segs, cos_m, precision=hi)               # (S, B)
    im = jnp.matmul(segs, sin_m, precision=hi)
    scale = 1.0 / (fps * float(np.sum(win * win)))
    doubling = np.full(freqs.shape, 2.0)
    doubling[0] = 1.0
    if nperseg % 2 == 0:
        doubling[-1] = 1.0
    psd = (re * re + im * im) * jnp.asarray(
        scale * doubling[band_idx], jnp.float32)

    w = seg_ok.astype(jnp.float32)[:, None]
    mean_psd = jnp.sum(psd * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    valid = jnp.logical_and(jnp.any(seg_ok), n_valid >= nperseg)
    return mean_psd, freqs[band_idx], valid


def _masked_welch_bpm(ordered: jnp.ndarray, n_valid: jnp.ndarray,
                      fps: float, band: HRBand, segment_seconds: float
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Welch PSD peak over the chronologically-ordered ring.

    ``ordered[-n_valid:]`` is real data (older slots zero).  Segments fully
    inside the valid suffix contribute to the mean PSD; with a full ring this
    is exactly the reference's ``estimate_bpm_welch`` on the 500-deque.
    """
    res = _masked_welch_psd(ordered, n_valid, fps, band, segment_seconds)
    if res is None:                      # degenerate band/fps config
        return jnp.float32(0.0), jnp.asarray(False)
    mean_psd, band_freqs, valid = res
    k = jnp.argmax(mean_psd)
    bpm = jnp.asarray(band_freqs, jnp.float32)[k] * 60.0
    return bpm, valid


def _ring_pulse(method: str, ordered_bgr: jnp.ndarray,
                ordered_green: jnp.ndarray, n_valid: jnp.ndarray,
                fps: float, window_seconds: float) -> jnp.ndarray:
    """Pulse construction over the ordered ring -> (N,).

    The valid suffix (``ordered[-n_valid:]``) is real data; the projection
    functions forward-fill the zero prefix from the first valid sample, so
    once the ring is FULL the result is exactly
    ``dsp.projections.<method>_pulse`` over the trailing ``N`` frames
    (steady-state offline == streaming, pinned in tests/test_live.py).
    """
    from ..dsp import projections as proj

    if method == "green":
        return ordered_green
    N = ordered_bgr.shape[0]
    suffix = jnp.arange(N) >= (N - n_valid)
    if method == "chrom":
        return proj.chrom_pulse(ordered_bgr, suffix, fps,
                                interval_seconds=window_seconds)
    if method == "pos":
        return proj.pos_pulse(ordered_bgr, suffix, fps,
                              window_seconds=window_seconds)
    if method == "omit":
        return proj.omit_pulse(ordered_bgr, suffix, fps,
                               window_seconds=window_seconds)
    raise ValueError(f"unknown live method {method!r}")


def _welch_snr(mean_psd: jnp.ndarray, band_freqs: np.ndarray,
               target_bpm: jnp.ndarray, guard_bins: int) -> jnp.ndarray:
    """In-band SNR of a Welch PSD around a target frequency: power within
    ±guard_bins bins of ``target_bpm`` over the remaining in-band power —
    ``dsp.spectral.band_snr``'s targeted form evaluated on the live
    Welch's banded grid (the adaptive selector's score)."""
    f = jnp.asarray(band_freqs, jnp.float32)
    df = float(band_freqs[1] - band_freqs[0]) if len(band_freqs) > 1 else 1.0
    near = jnp.abs(f - target_bpm / 60.0) <= (guard_bins + 0.5) * df
    peak = jnp.sum(jnp.where(near, mean_psd, 0.0))
    rest = jnp.sum(mean_psd) - peak
    return peak / jnp.maximum(rest, 1e-12)


def _method_bpm(cfg: LiveConfig, ring_raw: jnp.ndarray,
                ring_bgr: jnp.ndarray, ring_filt: jnp.ndarray,
                count: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One slot's per-tick BPM under ``cfg.method``: -> (bpm, valid,
    choice).  "green" is the reference streaming path (Welch over the
    causally-SOS-filtered ring) bit-identical to rounds <=3; projection
    methods Welch the recomputed pulse; "adaptive" scores every candidate
    by consensus-anchored Welch SNR (offline.adaptive_pulse_select's
    selection rule on the ring window)."""
    N = cfg.ring_len
    n_valid = jnp.minimum(count, N)
    r = jnp.mod(count, N)
    if cfg.method == "green":
        ordered = jnp.roll(ring_filt, -r)
        bpm, valid = _masked_welch_bpm(ordered, n_valid, cfg.fps, cfg.band,
                                       cfg.welch_segment_seconds)
        return bpm, valid, jnp.int32(0)

    ordered_bgr = jnp.roll(ring_bgr, -r, axis=0)
    ordered_green = jnp.roll(ring_raw, -r)
    if cfg.method != "adaptive":
        pulse = _ring_pulse(cfg.method, ordered_bgr, ordered_green, n_valid,
                            cfg.fps, cfg.proj_window_seconds)
        bpm, valid = _masked_welch_bpm(pulse, n_valid, cfg.fps, cfg.band,
                                       cfg.welch_segment_seconds)
        return bpm, valid, jnp.int32(0)

    bpms, oks, psds = [], [], []
    band_freqs = None
    for m in cfg.adaptive_methods:
        pulse = _ring_pulse(m, ordered_bgr, ordered_green, n_valid,
                            cfg.fps, cfg.proj_window_seconds)
        res = _masked_welch_psd(pulse, n_valid, cfg.fps, cfg.band,
                                cfg.welch_segment_seconds)
        if res is None:                  # degenerate band/fps config
            return jnp.float32(0.0), jnp.asarray(False), jnp.int32(0)
        mean_psd, band_freqs, ok = res
        k = jnp.argmax(mean_psd)
        bpms.append(jnp.asarray(band_freqs, jnp.float32)[k] * 60.0)
        oks.append(ok)
        psds.append(mean_psd)
    bpm_m = jnp.stack(bpms)                              # (M,)
    ok_m = jnp.stack(oks)
    consensus = jnp.nanmedian(jnp.where(ok_m, bpm_m, jnp.nan))
    consensus = jnp.nan_to_num(consensus)
    snr_m = jnp.stack([_welch_snr(p, band_freqs, consensus,
                                  cfg.snr_guard_bins) for p in psds])
    ranked = jnp.where(ok_m, snr_m, -jnp.inf)
    choice = jnp.argmax(ranked).astype(jnp.int32)
    return bpm_m[choice], ok_m[choice], choice


def step(state: LiveState, frame: jnp.ndarray, cfg: LiveConfig,
         detector=None) -> Tuple[LiveState, LiveOutput]:
    """One frame update (pure; jit via :func:`make_step`).

    ``detector`` overrides the skin-chroma stage with any single-face
    ``frames (1, H, W, 3) -> (boxes (1, 4), valid (1,))`` callable (e.g.
    the learned landmarker — the reference's live mode IS MediaPipe,
    ``rppg_LIVESTREAM.py:336``).
    """
    if detector is None:
        det_fn, det_args = None, ()
    else:
        from .offline import _split_detector as _split
        det_fn, det_args = _split(detector)
    return _step_impl(state, frame, det_args, cfg, det_fn)


def _step_impl(state: LiveState, frame: jnp.ndarray, det_args,
               cfg: LiveConfig, det_fn) -> Tuple[LiveState, LiveOutput]:
    H, W, _ = frame.shape
    sos = _sos(cfg)

    def run_detect(fr):
        if det_fn is None:
            boxes, det_valid = skin_detector.detect_faces(fr)
        else:
            boxes, det_valid = det_fn(*det_args, fr)
        return boxes[0].astype(jnp.int32), det_valid[0]

    if cfg.detect_every > 1:
        # Cadence on the wall-frame phase; skipped frames execute only
        # the trivial branch of the cond.
        attempt = jax.lax.rem(
            state.frame_idx, jnp.int32(cfg.detect_every)) == 0
        box, v = jax.lax.cond(
            attempt, run_detect,
            lambda fr: (jnp.zeros((4,), jnp.int32), jnp.asarray(False)),
            frame[None])
    else:
        attempt = jnp.asarray(True)
        box, v = run_detect(frame[None])

    # Landmark holdover, single-step (analysis/utils/roi.py:91-101
    # rule) with the cadence 'attempted' semantics: a skipped frame
    # tracks without draining the failure budget.
    new_last = jnp.where(v, box, state.last_box)
    new_has = jnp.logical_or(v, state.has_last)
    failed = jnp.logical_and(~v, attempt)
    reuse_ok = jnp.logical_and(failed,
                               jnp.logical_and(state.has_last,
                                               state.hold_budget > 0))
    tracked = jnp.logical_and(~attempt, state.has_last)
    new_budget = jnp.where(v, cfg.roi.landmark_hold_frames,
                           jnp.where(reuse_ok, state.hold_budget - 1,
                                     state.hold_budget))
    face_valid = jnp.logical_or(v, jnp.logical_or(reuse_ok, tracked))

    roi = vroi.measurement_roi(new_last[None], cfg.roi, W, H,
                               cfg.roi_site)[0]
    roi = jnp.where(face_valid, roi, 0)
    means, _ = vreduce.roi_channel_means(frame[None], roi[None])
    bgr_means = means[0]
    green = bgr_means[1]

    # Causal streaming SOS push (rppg_LIVESTREAM.py:245-251).
    filt, zi = filters.sos_stream_push(sos, state.zi, green)

    # Ring write; when the face is invalid the reference appends nothing —
    # here the write is masked so the buffer only advances on valid frames.
    ptr = jnp.mod(state.count, cfg.ring_len)
    ring_raw = jnp.where(face_valid,
                         state.ring_raw.at[ptr].set(green), state.ring_raw)
    ring_filt = jnp.where(face_valid,
                          state.ring_filt.at[ptr].set(filt), state.ring_filt)
    ring_bgr = jnp.where(face_valid,
                         state.ring_bgr.at[ptr].set(bgr_means),
                         state.ring_bgr)
    count = state.count + face_valid.astype(jnp.int32)
    zi = jnp.where(face_valid, zi, state.zi)

    bpm, bpm_valid, choice = _method_bpm(cfg, ring_raw, ring_bgr, ring_filt,
                                         count)

    new_state = LiveState(ring_raw=ring_raw, ring_filt=ring_filt,
                          count=count, zi=zi, last_box=new_last,
                          hold_budget=new_budget, has_last=new_has,
                          frame_idx=state.frame_idx + 1,
                          ring_bgr=ring_bgr)
    out = LiveOutput(bpm=bpm, bpm_valid=bpm_valid, green_raw=green,
                     green_filtered=filt, box=new_last,
                     face_valid=face_valid, choice=choice)
    return new_state, out


def _i420_frame_to_bgr(planar: jnp.ndarray) -> jnp.ndarray:
    """``(H*3//2, W)`` planar YUV 4:2:0 -> ``(H, W, 3)`` uint8 BGR, on
    device (bit-exact vs OpenCV; ``ops.color.i420_to_bgr_flat``)."""
    from ..ops import color as vcolor
    h = planar.shape[0] * 2 // 3
    w = planar.shape[1]
    flat = vcolor.i420_to_bgr_flat(planar.reshape(1, -1), h, w)
    return flat.reshape(h, w, 3)


# OpenCV's BT.601 studio-swing RGB -> YUV fixed-point constants (20-bit
# descale), so the host conversion is bit-exact vs cv2.COLOR_BGR2YUV_I420
# (pinned in tests/test_live.py) without needing OpenCV.
_YR, _YG, _YB = 269484, 528482, 102760
_UR, _UG, _UB = -155188, -305135, 460324
_VR, _VG, _VB = 460324, -385875, -74448


def bgr_to_i420_host(frame_bgr) -> "np.ndarray":
    """Host-side BGR ``(H, W, 3)`` uint8 -> planar I420 ``(H*3//2, W)``, for
    feeding ``transfer="i420"`` live steps: 1.5 B/px on the wire instead of
    3.  Chroma samples the top-left pixel of each 2x2 block, as OpenCV
    does; ``H`` and ``W`` must be even."""
    f = np.asarray(frame_bgr).astype(np.int32)
    H, W = f.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"I420 needs even frame dimensions, got {H}x{W}")
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    half, off = 1 << 19, 16 << 20
    y = (_YR * r + _YG * g + _YB * b + off + half) >> 20
    rs, gs, bs = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    u = (_UR * rs + _UG * gs + _UB * bs + (128 << 20) + half) >> 20
    v = (_VR * rs + _VG * gs + _VB * bs + (128 << 20) + half) >> 20
    planes = [np.clip(p, 0, 255).astype(np.uint8).ravel() for p in (y, u, v)]
    return np.concatenate(planes).reshape(H * 3 // 2, W)


def make_step(cfg: LiveConfig = LiveConfig(), donate: bool = True,
              detector=None, transfer: str = "bgr"):
    """The compiled per-frame step; state buffers donated to stay on device.

    A ``jax.tree_util.Partial`` detector's weights enter the jitted
    program as call-time arguments (never baked XLA literals).

    ``transfer="i420"``: the step takes a ``(H*3//2, W)`` uint8 planar
    YUV 4:2:0 frame (see :func:`bgr_to_i420_host`) and reconstructs BGR on
    device — 2x fewer host->device bytes per frame."""
    if detector is None:
        det_fn, det_args = None, ()
    else:
        from .offline import _split_detector as _split
        det_fn, det_args = _split(detector)
    if transfer not in ("bgr", "i420"):
        raise ValueError(f"transfer must be 'bgr' or 'i420', got {transfer!r}")

    def f(state, frame, det_args):
        if transfer == "i420":
            frame = _i420_frame_to_bgr(frame)
        return _step_impl(state, frame, det_args, cfg, det_fn)

    jitted = jax.jit(f, donate_argnums=(0,) if donate else ())
    return lambda state, frame: jitted(state, frame, det_args)


class LivePipeline:
    """One-frame-deep pipelined live loop: dispatch N+1 before reading N.

    Sequential ``step -> fetch`` pays dispatch and transfer latency *in
    series* with device compute every frame.  JAX dispatch is
    asynchronous, so :meth:`submit` enqueues the step for frame N and then
    materializes the *previous* frame's output — the round trip for frame
    N overlaps frame N-1's host work.  Answer lag is exactly one frame,
    which the reference already accepts for its async detector callback
    (``rppg_LIVESTREAM.py:335-341``); the queue stays 1 deep.

    >>> pipe = LivePipeline(cfg)
    >>> for frame in frames:
    ...     out = pipe.submit(frame)   # LiveOutput for the PREVIOUS frame
    ...     if out is not None: draw(out)
    >>> last = pipe.flush()
    """

    def __init__(self, cfg: LiveConfig = LiveConfig(), detector=None,
                 k_faces: int = 1, donate: bool = True,
                 transfer: str = "bgr", fetch_every: int = 1,
                 frames_per_call: int = 1):
        """``transfer="i420"``: :meth:`submit` takes a planar YUV 4:2:0
        frame of shape ``(H*3//2, W)`` uint8 (``bgr_to_i420_host`` converts
        a camera BGR frame) and the step reconstructs BGR on device —
        halving-and-halving the per-frame host->device bytes, which is the
        live loop's wire cost when frames originate on the host.

        ``fetch_every=N`` amortizes the blocking output fetch (one
        device->host round trip) over N frames: outputs accumulate on
        device and come back as ONE stacked fetch, so :meth:`submit`
        returns a *list* of LiveOutputs every Nth call (None otherwise) and
        the answer lag grows to ≤N+1 frames.

        ``frames_per_call=M`` micro-batches the live loop itself: M frames
        ship as ONE stacked transfer, the device runs M carried steps
        inside one jit (``lax.scan``), and the M outputs come back in one
        fetch — one round trip per M frames instead of per frame,
        the stronger lever when each *call* (not byte) costs a round trip.
        :meth:`submit` then returns a list of M LiveOutputs every Mth call
        (answer lag ≤ 2M frames).  BPM cadence is unchanged — every frame
        still gets its own estimate."""
        from .offline import _split_detector as _split
        if transfer not in ("bgr", "i420"):
            raise ValueError(f"transfer must be 'bgr' or 'i420', "
                             f"got {transfer!r}")
        if detector is None:
            det_fn, det_args = None, ()
        else:
            det_fn, det_args = _split(detector)
        self._multi = k_faces > 1
        self._i420 = transfer == "i420"
        if fetch_every < 1:
            raise ValueError("fetch_every must be >= 1")
        if frames_per_call < 1:
            raise ValueError("frames_per_call must be >= 1")
        if fetch_every > 1 and frames_per_call > 1:
            raise ValueError("fetch_every and frames_per_call are "
                             "alternative batching levers; use one")
        self._fetch_every = fetch_every
        self._frames_per_call = frames_per_call
        self._buf: list = []

        # The step's whole output is packed into ONE float32 tensor inside
        # the jitted program: the host then syncs with a single value fetch
        # instead of one device->host transfer per output field.
        def packed(state, frame, args):
            if self._i420:
                frame = _i420_frame_to_bgr(frame)
            if self._multi:
                s2, o = _step_multi_impl(state, frame, args, cfg, k_faces,
                                         det_fn)
            else:
                s2, o = _step_impl(state, frame, args, cfg, det_fn)
            return s2, pack_output(o)                 # one (..., 9) fetch

        jitted = jax.jit(packed, donate_argnums=(0,) if donate else ())
        self._step = lambda s, f: jitted(s, f, det_args)

        def packed_scan(state, frames, args):
            def body(s, f):
                return packed(s, f, args)
            return jax.lax.scan(body, state, frames)

        jitted_scan = jax.jit(packed_scan,
                              donate_argnums=(0,) if donate else ())
        self._step_scan = lambda s, fs: jitted_scan(s, fs, det_args)
        self._state = (init_state_multi(cfg, k_faces) if self._multi
                       else init_state(cfg))
        self._pending: list = []

    _unpack = staticmethod(unpack_output)

    def _materialize(self, vecs):
        if not vecs:
            return None
        if len(vecs) == 1:
            out = self._unpack(np.asarray(vecs[0]))   # 1 blocking fetch
            return out if self._fetch_every == 1 else [out]
        # One stack dispatch + ONE blocking fetch for the whole batch
        # (per-array fetches cost one round trip EACH).
        a = np.asarray(jnp.stack(vecs))
        return [self._unpack(a[i]) for i in range(a.shape[0])]

    def submit(self, frame):
        """Enqueue ``frame``.  With ``fetch_every=1`` (default): returns the
        previous frame's LiveOutput (host arrays), or None on the very first
        call.  With ``fetch_every=N`` or ``frames_per_call=M``: returns a
        list of the N (M) oldest pending LiveOutputs every Nth (Mth) call,
        None otherwise."""
        if self._frames_per_call > 1:
            self._buf.append(np.asarray(frame))
            if len(self._buf) < self._frames_per_call:
                return None
            frames = jnp.asarray(np.stack(self._buf))  # ONE stacked upload
            self._buf = []
            self._state, vecs = self._step_scan(self._state, frames)
            self._pending.append(vecs)
            if len(self._pending) > 1:                 # 1 batch stays queued
                a = np.asarray(self._pending.pop(0))   # ONE blocking fetch
                return [self._unpack(a[i]) for i in range(a.shape[0])]
            return None
        self._state, out = self._step(self._state, frame)
        self._pending.append(out)
        if len(self._pending) > self._fetch_every:
            batch, self._pending = (self._pending[:-1],
                                    self._pending[-1:])
            return self._materialize(batch)
        return None

    def flush(self):
        """Drain in-flight frames (call once after the last submit).
        Returns a LiveOutput (``fetch_every=1``) or a list."""
        if self._frames_per_call > 1:
            for f in self._buf:                # partial tail, one at a time
                self._state, v = self._step(self._state, jnp.asarray(f))
                self._pending.append(jnp.expand_dims(v, 0))
            self._buf = []
            outs: list = []
            for b in self._pending:
                a = np.asarray(b)
                outs.extend(self._unpack(a[i]) for i in range(a.shape[0]))
            self._pending = []
            return outs or None
        batch, self._pending = self._pending, []
        return self._materialize(batch)


class MultiLiveState(NamedTuple):
    """K independent subjects' live state (face axis leading everywhere)."""
    ring_raw: jnp.ndarray     # (K, N)
    ring_filt: jnp.ndarray    # (K, N)
    count: jnp.ndarray        # (K,) per-face valid-sample counters
    zi: jnp.ndarray           # (K, S, 2)
    last_box: jnp.ndarray     # (K, 4)
    hold_budget: jnp.ndarray  # (K,)
    has_last: jnp.ndarray     # (K,) bool
    frame_idx: jnp.ndarray    # () wall-frame counter (cadence phase,
                              # advances every frame — LiveState.frame_idx)
    ring_bgr: jnp.ndarray     # (K, N, 3) raw BGR ROI means (circular)


def init_state_multi(cfg: LiveConfig = LiveConfig(),
                     k_faces: int = 2) -> MultiLiveState:
    n_sections = _sos(cfg).shape[0]
    K = k_faces
    return MultiLiveState(
        ring_raw=jnp.zeros((K, cfg.ring_len), jnp.float32),
        ring_filt=jnp.zeros((K, cfg.ring_len), jnp.float32),
        count=jnp.zeros((K,), jnp.int32),
        zi=jnp.zeros((K, n_sections, 2), jnp.float32),
        last_box=jnp.zeros((K, 4), jnp.int32),
        hold_budget=jnp.zeros((K,), jnp.int32),
        has_last=jnp.zeros((K,), bool),
        frame_idx=jnp.int32(0),
        ring_bgr=jnp.zeros((K, cfg.ring_len, 3), jnp.float32),
    )


def _step_multi_impl(state: MultiLiveState, frame: jnp.ndarray,
                     det_args, cfg: LiveConfig, k_faces: int, det_fn
                     ) -> Tuple[MultiLiveState, LiveOutput]:
    from ..models.multiface import detect_faces_multi

    H, W, _ = frame.shape
    sos = _sos(cfg)

    def run_detect(fr):
        if det_fn is None:
            cand, cval = detect_faces_multi(fr, k_faces)
        else:
            cand, cval = det_fn(*det_args, fr)
        return cand[0].astype(jnp.int32), cval[0]

    if cfg.detect_every > 1:
        # Detection cadence on the wall-frame phase (LiveConfig
        # .detect_every, the single-face step's semantics): skipped frames
        # run only the trivial cond branch and hold every live track.
        attempt = jax.lax.rem(state.frame_idx,
                              jnp.int32(cfg.detect_every)) == 0
        cand0, cval0 = jax.lax.cond(
            attempt, run_detect,
            lambda fr: (jnp.zeros((k_faces, 4), jnp.int32),
                        jnp.zeros((k_faces,), bool)),
            frame[None])
    else:
        attempt = jnp.asarray(True)
        cand0, cval0 = run_detect(frame[None])

    carry = (state.last_box, state.hold_budget, state.has_last)
    (new_last, new_budget, new_has), (boxes, face_valid) = \
        vroi.holdover_multi_step(carry, cand0, cval0,
                                 cfg.roi.landmark_hold_frames,
                                 attempted=attempt)

    rois = vroi.measurement_roi(boxes, cfg.roi, W, H,
                                cfg.roi_site)                 # (K, 4)
    rois = jnp.where(face_valid[:, None], rois, 0)
    # One frame read for all K ROIs (not a K-fold broadcast) — this is the
    # 33 ms-budget path.
    means, _ = vreduce.roi_channel_means_multi(frame[None], rois[None])
    bgr_means = means[0]                                      # (K, 3)
    green = bgr_means[:, 1]                                   # (K,)

    filt, zi = jax.vmap(lambda z, g: filters.sos_stream_push(sos, z, g))(
        state.zi, green)

    ptr = jnp.mod(state.count, cfg.ring_len)                  # (K,)
    k_idx = jnp.arange(k_faces)
    ring_raw = jnp.where(face_valid[:, None],
                         state.ring_raw.at[k_idx, ptr].set(green),
                         state.ring_raw)
    ring_filt = jnp.where(face_valid[:, None],
                          state.ring_filt.at[k_idx, ptr].set(filt),
                          state.ring_filt)
    ring_bgr = jnp.where(face_valid[:, None, None],
                         state.ring_bgr.at[k_idx, ptr].set(bgr_means),
                         state.ring_bgr)
    count = state.count + face_valid.astype(jnp.int32)
    zi = jnp.where(face_valid[:, None, None], zi, state.zi)

    bpm, bpm_valid, choice = jax.vmap(
        lambda rr, rb, rf, c: _method_bpm(cfg, rr, rb, rf, c))(
        ring_raw, ring_bgr, ring_filt, count)

    new_state = MultiLiveState(ring_raw=ring_raw, ring_filt=ring_filt,
                               count=count, zi=zi, last_box=new_last,
                               hold_budget=new_budget, has_last=new_has,
                               frame_idx=state.frame_idx + 1,
                               ring_bgr=ring_bgr)
    out = LiveOutput(bpm=bpm, bpm_valid=bpm_valid, green_raw=green,
                     green_filtered=filt, box=boxes, face_valid=face_valid,
                     choice=choice)
    return new_state, out


def step_multi(state: MultiLiveState, frame: jnp.ndarray, cfg: LiveConfig,
               k_faces: int = 2, detector=None
               ) -> Tuple[MultiLiveState, LiveOutput]:
    """One frame of K-subject live monitoring (pure; jit via
    :func:`make_step_multi`).

    The reference requests ``num_faces=2`` but only processes
    ``face_landmarks[0]`` (``rppg_LIVESTREAM.py:308,339``); here every slot
    gets the full live treatment: per-frame top-K detection, the
    identity-matched K-track holdover (``ops.roi.holdover_multi_step`` —
    bit-identical semantics to the offline scan), a single-frame-read
    K-ROI reduction, and a vmapped per-face streaming-SOS -> masked-Welch
    chain.  Output fields carry a leading ``(K,)`` face axis.

    ``detector`` overrides detection with any ``frames -> (boxes (1, K, 4),
    valid (1, K))`` callable (e.g. ``cascade.make_tiled_detector_multi``).
    """
    from .offline import _split_detector as _split
    det_fn, det_args = (None, ()) if detector is None else _split(detector)
    return _step_multi_impl(state, frame, det_args, cfg, k_faces, det_fn)


def make_step_multi(cfg: LiveConfig = LiveConfig(), k_faces: int = 2,
                    detector=None, donate: bool = True):
    """Compiled K-subject per-frame step (state donated).

    A ``jax.tree_util.Partial`` detector is split into its (static)
    function and (traced) weight pytree — the weights enter the jitted
    program as arguments bound at call time, never as baked XLA literal
    constants, which compile slowly)."""
    from .offline import _split_detector as _split
    det_fn, det_args = (None, ()) if detector is None else _split(detector)
    f = functools.partial(_step_multi_impl, cfg=cfg, k_faces=k_faces,
                          det_fn=det_fn)
    jitted = jax.jit(f, donate_argnums=(0,) if donate else ())
    return lambda state, frame: jitted(state, frame, det_args)
