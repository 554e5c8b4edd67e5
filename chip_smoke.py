#!/usr/bin/env python3
"""End-to-end proof that vhr_tpu's main path runs on an NVIDIA GPU.

Drives the system through the entry points a user calls, at full size,
with frames made from ``--seed`` (nothing is downloaded), and compares what
each timed phase produced with the repository's plain references:

1. ``offline``  — ``pipeline.offline.measure_green_avg`` on 960 frames of
   1080p (32 s at 30 fps) with ``PipelineConfig()`` defaults and the skin
   detector.
2. ``live``     — the production MediaPipe port (bf16 activations) inside
   ``pipeline.live.make_step`` at 720p on the real-face portrait animated
   with a known pulse.
3. ``serving``  — ``serving.serve_forever`` with a 16-slot ``BpmServer`` at
   720p (MediaPipe, ``detect_every=8``, I420 wire format); four
   ``BpmClient`` connections stream frames over localhost TCP.
4. ``evm``      — ``pipeline.evm.magnified_pulse`` and ``magnify`` at 1080p.

``--multi`` instead runs the three cross-device paths on a 4-card mesh,
each against the same work on one card: the stream-sharded farm
(``parallel.streams``), the slot-sharded serving pool (``BpmServer(mesh=)``,
skin detector) and the time-sharded long recording (``parallel.long``).

``--rehearse`` runs the same phases on the CPU at toy sizes, to check paths
and control flow without a card; its output never names a GPU.

The script refuses to run without a GPU (exit code 2) and never falls back
to the CPU.  Any failed check raises, so the process exits non-zero and the
final ``{"ok": true, ...}`` line is printed only when every phase passed.

Usage::

    python chip_smoke.py [--seed N]           # one card
    python chip_smoke.py --multi [--seed N]   # four cards
    python chip_smoke.py --rehearse [--multi] # CPU, toy sizes
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason.
#  ROI means are float32 sums over at most ~2 M pixels of 8-bit values:
#  accumulated rounding stays far below 1e-3 intensity levels.
TOL_ROI_MEAN = 1e-3
#  BPM vs the CPU reference on the same green trace (BASELINE.md bar).
TOL_BPM_MAE = 0.5
#  BPM vs the injected truth after acquisition: half an FFT bin at the
#  10 s acquisition window is 3 BPM.
TOL_BPM_TRUTH = 3.0
#  Live Welch peak vs scipy's Welch on the same filtered samples: the same
#  bin, so only float formatting separates them.
TOL_WELCH_BPM = 1e-3
#  MediaPipe bf16-activation landmarks vs the float32 numpy TFLite oracle:
#  the landmark-RMS pin of tests/test_mediapipe_face.py (crop pixels).
TOL_LANDMARK_RMS_PX = 1.5
#  Served answers vs live.make_step on the same frames: the pool's
#  detection cadence follows its own tick counter, so a slot's detection
#  frames can sit up to detect_every-1 frames away from the single
#  stream's.  Boxes then come from neighbouring frames (IoU >= 0.9), the
#  first detect_every frames may differ in validity, and a Welch peak may
#  move by at most one bin (60/9 BPM at 9 s segments).  This holds while a
#  slot is active on every tick, so each client keeps SERVE_IN_FLIGHT
#  frames in flight (a camera streams; it does not wait for answers).
TOL_SERVE_IOU = 0.9
TOL_SERVE_BPM = 60.0 / 9.0 + 1e-3
SERVE_IN_FLIGHT = 4
#  Cross-device results vs one card: float32 reassociation only
#  (the __graft_entry__.dryrun_multichip bound); boxes exactly equal.
TOL_MULTI_RTOL, TOL_MULTI_ATOL = 1e-5, 1e-4
#  EVM uint8 output vs a float64 numpy reference: one rounding step.
TOL_EVM_U8 = 1
TOL_EVM_PULSE = 1e-4


@dataclasses.dataclass(frozen=True)
class Sizes:
    offline_hw: tuple = (1080, 1920)
    offline_frames: int = 960
    live_scale: int = 1              # portrait downscale (rehearsal only)
    live_hw: tuple = (720, 1280)
    live_frames: int = 900
    live_settle: int = 800           # first frame whose ring is past the
    live_segment_s: float = 9.0      # causal filter's start-up transient
    serve_slots: int = 16
    serve_clients: int = 4
    serve_frames: int = 300
    evm_hw: tuple = (1080, 1920)
    evm_frames: int = 64
    farm_streams: int = 8
    farm_hw: tuple = (720, 1280)
    farm_frames: int = 96
    pool_ticks: int = 300
    long_hw: tuple = (720, 1280)
    long_frames: int = 3600          # 2 min of 720p: ~2.5 GB per card


FULL = Sizes()
TOY = Sizes(offline_hw=(48, 64), offline_frames=360, live_scale=2,
            live_hw=(320, 288), live_frames=80, live_settle=70,
            live_segment_s=2.0,
            serve_slots=4, serve_clients=2, serve_frames=72,
            evm_hw=(64, 96), evm_frames=64, farm_streams=4,
            farm_hw=(48, 64), farm_frames=96, pool_ticks=72,
            long_hw=(96, 128), long_frames=1440)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines(rehearse: bool) -> list:
    """The card's name and power limit, as nvidia-smi gives them."""
    if rehearse:
        return ["card: none (CPU rehearsal)"]
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [line for line in out.stdout.splitlines() if line.strip()]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, *args, **kwargs):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


# --- frames ------------------------------------------------------------------

def portrait_offset(sz: Sizes):
    """Top-left corner of the (downscaled) portrait on the canvas."""
    from vhr_tpu.utils.realface import real_face_image
    h, w = real_face_image()[::sz.live_scale, ::sz.live_scale].shape[:2]
    H, W = sz.live_hw
    return (H - h) // 2, (W - w) // 2


def portrait_clip(sz: Sizes, n: int, bpm: float, seed: int):
    """The real-face portrait animated with a known pulse, centred on a
    grey canvas of ``sz.live_hw`` -> ``(frames (n, H, W, 3) u8, truth)``."""
    import numpy as np

    from vhr_tpu.utils.realface import synthesize_real_face_clip

    clip = synthesize_real_face_clip(bpm=bpm, fps=30.0, duration_s=n / 30.0,
                                     pulse_amplitude=2.0, motion_px=0.0,
                                     noise_std=1.0, seed=seed)
    small = clip.frames[:, ::sz.live_scale, ::sz.live_scale]
    H, W = sz.live_hw
    h, w = small.shape[1:3]
    y0, x0 = portrait_offset(sz)
    out = np.full((n, H, W, 3), 96, np.uint8)
    out[:, y0:y0 + h, x0:x0 + w] = small[:n]
    return out, clip.bpm_truth


def np_roi_means(frames, rois):
    """float64 numpy channel means over per-frame boxes (the plain
    reference of ``ops.reduce.roi_channel_means``)."""
    import numpy as np

    out = np.zeros((len(rois), frames.shape[-1]), np.float64)
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(rois)):
        patch = np.asarray(frames[i, max(y1, 0):y2, max(x1, 0):x2],
                           np.float64)
        if patch.size:
            out[i] = patch.reshape(-1, patch.shape[-1]).sum(0) / (
                (y2 - y1) * (x2 - x1))
    return out


# --- phase 1: offline flagship -----------------------------------------------

def phase_offline(sz: Sizes, seed: int) -> dict:
    import jax
    import numpy as np

    from vhr_tpu import validation
    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.models import skin_detector
    from vhr_tpu.pipeline import offline
    from vhr_tpu.utils.synth import SynthSpec, synthesize_on_device

    fps, bpm = 30.0, 72.0
    H, W = sz.offline_hw
    T = sz.offline_frames
    cfg = PipelineConfig()
    spec = SynthSpec(height=H, width=W, fps=fps, duration_s=T / fps,
                     bpm=bpm, noise_std=1.0, seed=seed)
    frames, _, _ = jax.block_until_ready(synthesize_on_device(spec))

    t0 = time.perf_counter()
    compiled = offline._extract_signals_jit.lower(
        frames, (), cfg=cfg, det_fn=skin_detector.detect_faces,
        detect_every=1).compile()
    compile_s = time.perf_counter() - t0
    log(f"[offline] extract step memory_analysis: "
        f"{compiled.memory_analysis()}")

    (_, bpm_out, valid), first_s = timed(offline.measure_green_avg, frames,
                                         fps, cfg)
    (_, bpm_out, valid), steady_s = timed(offline.measure_green_avg, frames,
                                          fps, cfg)
    trace = offline.extract_signals(frames, cfg)
    rois = np.asarray(trace.rois)
    bgr = np.asarray(trace.bgr)
    tvalid = np.asarray(trace.valid)
    check(tvalid.all(), f"face lost on {int((~tvalid).sum())} frames")

    host = np.asarray(frames)
    roi_err = float(np.abs(bgr - np_roi_means(host, rois)).max())
    check(roi_err <= TOL_ROI_MEAN, f"ROI means vs float64 numpy: {roi_err}")

    green = np.asarray(offline._fill_invalid(trace.bgr[:, cfg.channel],
                                             trace.valid))
    ref = validation.cpu_reference_green_avg(
        green, fps, cfg.window_seconds, cfg.acquisition_seconds, cfg.band)
    idx = sorted(set(ref) & set(np.nonzero(valid)[0].tolist()))
    check(len(idx) > 0, "no frame with both a device and a reference BPM")
    mae = float(np.mean([abs(bpm_out[i] - ref[i]) for i in idx]))
    check(mae <= TOL_BPM_MAE, f"BPM MAE vs CPU reference: {mae}")
    post = valid.copy()
    post[:cfg.acquisition_len(fps) - 1] = False
    truth_err = float(np.abs(bpm_out[post] - bpm).max())
    check(truth_err <= TOL_BPM_TRUTH, f"BPM vs injected truth: {truth_err}")
    return {"frames": T, "height": H, "width": W,
            "compile_s": round(compile_s, 3),
            "first_call_s": round(first_s, 3),
            "steady_s": round(steady_s, 4),
            "steady_frames_per_s": round(T / steady_s, 1),
            "valid_bpm_frames": int(valid.sum()),
            "roi_mean_max_abs_err": roi_err,
            "bpm_mae_vs_cpu_reference": mae,
            "bpm_max_err_vs_truth": truth_err,
            "peak_device_bytes": peak_bytes(jax.devices()[0])}


# --- phase 2: live MediaPipe -----------------------------------------------------

def landmark_oracle_rms(frame) -> float:
    """Mesh-net landmarks (bf16 activations, device) vs the float32 numpy
    TFLite interpreter on the same 256x256 crop, RMS in crop pixels."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vhr_tpu.models import mediapipe_face as mpf
    from vhr_tpu.models.tflite import load_task_models
    from vhr_tpu.models.tflite_exec import NumpyInterpreter

    params, det_apply, lm_apply = mpf.load_face_models(
        activation_dtype=jnp.bfloat16)

    @jax.jit
    def crop_and_mesh(p, fr):
        rects, _, ok = mpf.detect_faces_mp(p, det_apply, fr, k_faces=1)
        rects = rects._replace(rot=jnp.zeros_like(rects.rot))
        crops = mpf._crop_faces(fr, rects, 256, mode="axis",
                                dtype=jnp.bfloat16).reshape(1, 256, 256, 3)
        return crops, lm_apply(p.lm, crops)[0], ok

    crops, lm, ok = crop_and_mesh(params, jnp.asarray(frame[None]))
    check(bool(np.asarray(ok)[0, 0]), "MediaPipe found no face")
    graph = load_task_models(mpf.default_task_path())[
        "face_landmarks_detector.tflite"].graph
    ref = NumpyInterpreter(graph)(np.asarray(crops, np.float32))[0]
    d = (np.asarray(lm, np.float32).reshape(478, 3)[:, :2]
         - ref.reshape(478, 3)[:, :2])
    return float(np.sqrt(np.mean(d * d)))


def phase_live(sz: Sizes, seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.signal as sps

    from vhr_tpu.models.mediapipe_face import make_mediapipe_detector
    from vhr_tpu.ops import roi as vroi
    from vhr_tpu.pipeline import live

    bpm_truth = 72.0
    frames, _ = portrait_clip(sz, sz.live_frames, bpm_truth, seed)
    H, W = frames.shape[1:3]
    rms = landmark_oracle_rms(frames[0])
    check(rms <= TOL_LANDMARK_RMS_PX, f"landmark RMS vs oracle: {rms}")

    cfg = live.LiveConfig(fps=30.0, welch_segment_seconds=sz.live_segment_s)
    det = make_mediapipe_detector()
    step = live.make_step(cfg, detector=det)
    state = live.init_state(cfg)
    outs, lat = [], []
    for f in frames:
        t0 = time.perf_counter()
        state, out = jax.block_until_ready(step(state, jnp.asarray(f)))
        lat.append(time.perf_counter() - t0)
        outs.append(jax.device_get(out))
    first_s, lat = lat[0], lat[1:]
    fvalid = np.array([bool(o.face_valid) for o in outs])
    check(fvalid.all(), f"face lost on {int((~fvalid).sum())} frames")
    boxes = np.stack([o.box for o in outs])
    rois = np.asarray(vroi.measurement_roi(jnp.asarray(boxes), cfg.roi, W, H,
                                           cfg.roi_site))
    green = np.array([float(o.green_raw) for o in outs])
    roi_err = float(np.abs(green - np_roi_means(frames, rois)[:, 1]).max())
    check(roi_err <= TOL_ROI_MEAN, f"live ROI mean vs numpy: {roi_err}")

    nper = int(cfg.welch_segment_seconds * cfg.fps)
    filt = np.array([float(o.green_filtered) for o in outs])
    bvalid = np.array([bool(o.bpm_valid) for o in outs])
    bpms = np.array([float(o.bpm) for o in outs])
    check(bvalid.any(), "no valid live BPM")
    welch_err = 0.0
    for i in np.nonzero(bvalid)[0]:
        x = filt[max(0, i + 1 - cfg.ring_len):i + 1]
        freqs, psd = sps.welch(x - x.mean(), fs=cfg.fps, window="hann",
                               nperseg=nper, noverlap=nper // 2,
                               detrend="constant", scaling="density")
        band = (freqs >= cfg.band.low_hz) & (freqs <= cfg.band.high_hz)
        ref = freqs[band][np.argmax(psd[band])] * 60.0
        welch_err = max(welch_err, abs(bpms[i] - ref))
    check(welch_err <= TOL_WELCH_BPM, f"live Welch vs scipy: {welch_err}")
    # The causal filter starts on a step (0 -> the first green mean); its
    # transient fills the ring's first ~10 s, so truth is checked only on
    # frames whose 500-sample ring is past it.
    settled = bvalid.copy()
    settled[:sz.live_settle] = False
    check(settled.any(), "no valid live BPM after the settling frames")
    med = float(np.median(np.abs(bpms[settled] - bpm_truth)))
    check(med <= 60.0 / sz.live_segment_s,
          f"live BPM median error vs truth: {med}")
    return {"frames": len(frames), "height": H, "width": W,
            "first_step_s": round(first_s, 3),
            "step_p50_ms": round(1e3 * float(np.median(lat)), 3),
            "step_p90_ms": round(1e3 * float(np.percentile(lat, 90)), 3),
            "valid_bpm_frames": int(bvalid.sum()),
            "landmark_rms_vs_oracle_px": rms,
            "roi_mean_max_abs_err": roi_err,
            "welch_vs_scipy_max_abs_err": welch_err,
            "bpm_median_err_vs_truth": med}


# --- phase 3: serving over TCP ---------------------------------------------------

def _iou(a, b) -> float:
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area = lambda r: max(0, r[2] - r[0]) * max(0, r[3] - r[1])
    union = area(a) + area(b) - inter
    return inter / union if union > 0 else 1.0


def phase_serving(sz: Sizes, seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vhr_tpu import serving
    from vhr_tpu.models.mediapipe_face import make_mediapipe_detector
    from vhr_tpu.pipeline import live

    cfg = live.LiveConfig(fps=30.0, detect_every=8,
                          welch_segment_seconds=sz.live_segment_s)
    det = make_mediapipe_detector()
    truths = [60.0 + 12.0 * k for k in range(sz.serve_clients)]
    clips = []
    for k, bpm in enumerate(truths):
        bgr, _ = portrait_clip(sz, sz.serve_frames, bpm, seed + 1 + k)
        clips.append([live.bgr_to_i420_host(f) for f in bgr])
    H, W = sz.live_hw
    pool = serving.BpmServer(cfg, n_slots=sz.serve_slots, detector=det,
                             transfer="i420")
    srv = serving.serve_forever("127.0.0.1", 0, pool, frame_shape=(H, W))
    port = srv.server_address[1]
    answers, latency, errors = {}, {}, []
    ready = threading.Barrier(sz.serve_clients)

    def client(k):
        try:
            c = serving.BpmClient("127.0.0.1", port, transfer="i420",
                                  timeout=900.0)
            ready.wait(timeout=600)
            outs, lat, sent = [], [], []
            n = len(clips[k])

            def send(i):
                sent.append(time.perf_counter())
                c.send(clips[k][i])

            for i in range(min(SERVE_IN_FLIGHT, n)):
                send(i)
            for i in range(n):
                outs.append(c.recv())
                lat.append(time.perf_counter() - sent[i])
                if i + SERVE_IN_FLIGHT < n:
                    send(i + SERVE_IN_FLIGHT)
            c.close()
            answers[k], latency[k] = outs, lat
        except Exception as e:                 # noqa: BLE001 -- re-raised
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(sz.serve_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1100)
    wall = time.perf_counter() - t0
    stats = dict(srv.stats)
    srv.shutdown()
    srv.server_close()
    if errors:
        raise errors[0]
    check(all(not t.is_alive() for t in threads), "a client hung")
    for k in range(sz.serve_clients):
        check(len(answers.get(k, [])) == sz.serve_frames,
              f"client {k} got {len(answers.get(k, []))} answers")
        check([a["seq"] for a in answers[k]] == list(range(sz.serve_frames)),
              f"client {k}: answers out of order")
        check(all("error" not in a for a in answers[k]),
              f"client {k}: server error")

    # Per-slot reference: the single-stream live step on the same frames.
    step = live.make_step(cfg, detector=det, transfer="i420")
    min_iou, max_bpm_diff, exact_bpm, both_valid = 1.0, 0.0, 0, 0
    for k in range(sz.serve_clients):
        state = live.init_state(cfg)
        for i, f in enumerate(clips[k]):
            state, o = step(state, jnp.asarray(f))
            o = jax.device_get(o)
            a = answers[k][i]
            if i < cfg.detect_every:
                continue
            check(a["face_valid"] == bool(o.face_valid),
                  f"client {k} frame {i}: face validity differs")
            min_iou = min(min_iou, _iou(a["box"], [int(x) for x in o.box]))
            if a["bpm_valid"] and bool(o.bpm_valid):
                both_valid += 1
                d = abs(a["bpm"] - float(o.bpm))
                exact_bpm += d <= 1e-3
                max_bpm_diff = max(max_bpm_diff, d)
        check(answers[k][-1]["bpm_valid"],
              f"client {k}: no valid BPM at the end")
    check(min_iou >= TOL_SERVE_IOU, f"served vs live box IoU {min_iou}")
    check(max_bpm_diff <= TOL_SERVE_BPM, f"served vs live BPM {max_bpm_diff}")
    lat = np.concatenate([np.asarray(latency[k][1:])
                          for k in range(sz.serve_clients)])
    return {"slots": sz.serve_slots, "clients": sz.serve_clients,
            "frames_per_client": sz.serve_frames, "height": H, "width": W,
            "frames_in_flight": SERVE_IN_FLIGHT,
            "wall_s": round(wall, 3),
            "first_answer_s": round(max(latency[k][0]
                                        for k in range(sz.serve_clients)),
                                    3),
            "answer_p50_ms": round(1e3 * float(np.median(lat)), 3),
            "answer_p90_ms": round(1e3 * float(np.percentile(lat, 90)), 3),
            "ticks": stats["ticks"], "tick_errors": stats["tick_errors"],
            "served_vs_live_min_box_iou": min_iou,
            "served_vs_live_max_bpm_diff": max_bpm_diff,
            "served_vs_live_equal_bpm_frac": (exact_bpm / both_valid
                                              if both_valid else None)}


# --- phase 4: EVM ------------------------------------------------------------

def _np_yiq(frames):
    import numpy as np
    rgb = frames[..., ::-1].astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.30 * r + 0.59 * g + 0.11 * b
    return np.stack([y, 0.74 * (r - y) - 0.27 * (b - y),
                     0.48 * (r - y) + 0.41 * (b - y)], axis=-1)


def _np_down(x, levels):
    """Binomial 5-tap blur (edge-padded) + 2x decimation, per level."""
    import numpy as np
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0

    def along(a, axis, sl):
        idx = [slice(None)] * a.ndim
        idx[axis] = sl
        return a[tuple(idx)]

    for _ in range(levels):
        for axis in (1, 2):
            pad = [(0, 0)] * x.ndim
            pad[axis] = (2, 2)
            xp = np.pad(x, pad, mode="edge")
            n = x.shape[axis]
            out = sum(k[j] * along(xp, axis, slice(j, j + n))
                      for j in range(5))
            x = along(out, axis, slice(0, None, 2))
    return x


def _np_bandpass(x, fps, band):
    import numpy as np
    T = x.shape[0]
    freqs = np.fft.rfftfreq(T, d=1.0 / fps)
    keep = (freqs >= band.low_hz) & (freqs <= band.high_hz)
    X = np.fft.rfft(x, axis=0) * keep.reshape((-1,) + (1,) * (x.ndim - 1))
    return np.fft.irfft(X, n=T, axis=0)


def phase_evm(sz: Sizes, seed: int) -> dict:
    import jax
    import numpy as np

    from vhr_tpu.config import EVMConfig, HRBand
    from vhr_tpu.models.mediapipe_face import _resize_matrix
    from vhr_tpu.pipeline import evm
    from vhr_tpu.utils.synth import SynthSpec, synthesize_on_device

    fps = 30.0
    H, W = sz.evm_hw
    T = sz.evm_frames
    frames, _, _ = synthesize_on_device(SynthSpec(
        height=H, width=W, fps=fps, duration_s=T / fps, bpm=60.0,
        noise_std=1.0, seed=seed))
    host = np.asarray(frames)
    band = HRBand(0.65, 3.4)
    levels = 3
    pulse_fn = jax.jit(evm.magnified_pulse, static_argnums=(1, 2, 3))
    _, pulse_first = timed(pulse_fn, frames, fps, band, levels)
    pulse, pulse_s = timed(pulse_fn, frames, fps, band, levels)
    cfg = EVMConfig()
    _, mag_first = timed(evm.magnify, frames, fps, cfg)
    mag, mag_s = timed(evm.magnify, frames, fps, cfg)

    yiq = _np_yiq(host)
    ref_pulse = _np_bandpass(_np_down(yiq, levels), fps, band).mean(axis=(1, 2))
    pulse_err = float(np.abs(np.asarray(pulse) - ref_pulse).max())
    check(pulse_err <= TOL_EVM_PULSE, f"EVM pulse vs numpy: {pulse_err}")

    low = _np_down(yiq, cfg.pyramid_levels)
    gains = np.array([cfg.amplification,
                      cfg.amplification * cfg.attenuate_chroma,
                      cfg.amplification * cfg.attenuate_chroma])
    bandp = _np_bandpass(low, fps, cfg.band) * gains
    ry = _resize_matrix(low.shape[1], H).astype(np.float64)
    rx = _resize_matrix(low.shape[2], W).astype(np.float64)
    worst, n_off = 0, 0
    inv = np.array([[1.0, 0.9468822170900693, 0.6235565819861433],
                    [1.0, -0.27478764629897834, -0.6356910791873801],
                    [1.0, -1.1085450346420322, 1.7090069284064666]])
    got = np.asarray(mag)
    for t in range(T):
        up = np.stack([ry @ bandp[t, ..., c] @ rx.T for c in range(3)], -1)
        rgb = np.clip((yiq[t] + up) @ inv.T, 0.0, 1.0)
        ref = np.clip(np.round(rgb[..., ::-1] * 255.0), 0, 255)
        d = np.abs(got[t].astype(np.int64) - ref.astype(np.int64))
        worst = max(worst, int(d.max()))
        n_off += int((d > 0).sum())
    frac_off = n_off / got.size
    check(worst <= TOL_EVM_U8, f"EVM magnify vs numpy: {worst} levels")
    return {"frames": T, "height": H, "width": W,
            "pulse_first_call_s": round(pulse_first, 3),
            "pulse_steady_s": round(pulse_s, 4),
            "pulse_ms_per_frame": round(1e3 * pulse_s / T, 4),
            "magnify_first_call_s": round(mag_first, 3),
            "magnify_steady_s": round(mag_s, 4),
            "magnify_ms_per_frame": round(1e3 * mag_s / T, 4),
            "pulse_max_abs_err": pulse_err,
            "magnify_max_u8_err": worst,
            "magnify_frac_u8_off_by_one": frac_off}


# --- --multi: three cross-device paths vs one card ---------------------------

def _close(a, b, what):
    import numpy as np
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=TOL_MULTI_RTOL, atol=TOL_MULTI_ATOL,
                               err_msg=what)


def phase_multi(sz: Sizes, seed: int, devices) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.models.skin_detector import SkinDetectorConfig, detect_faces
    from vhr_tpu.ops import roi as vroi
    from vhr_tpu.parallel import mesh as vmesh
    from vhr_tpu.parallel import streams
    from vhr_tpu.parallel.long import (measure_green_avg_sharded,
                                       sharded_holdover)
    from vhr_tpu.pipeline import live
    from vhr_tpu.serving import BpmServer
    from vhr_tpu.utils.synth import SynthSpec, synthesize_on_device

    fps = 30.0
    n = len(devices)
    out = {"devices": n}

    # 1. stream-sharded farm --------------------------------------------------
    H, W = sz.farm_hw
    cfg = PipelineConfig(window_seconds=2.0, acquisition_seconds=1.0)
    clips = [synthesize_on_device(SynthSpec(
        height=H, width=W, fps=fps, duration_s=sz.farm_frames / fps,
        bpm=60.0 + 4 * s, noise_std=1.0, seed=seed + s))[0]
        for s in range(sz.farm_streams)]
    frames = jnp.stack(clips)
    del clips
    res = {}
    for name, devs in (("one", devices[:1]), ("mesh", devices)):
        m = vmesh.stream_mesh(devs)
        f = vmesh.shard(frames, m, "stream")
        r, secs = timed(streams.multistream_green_bpm, f, fps, m, cfg)
        r, secs = timed(streams.multistream_green_bpm, f, fps, m, cfg)
        res[name] = (jax.device_get(r), secs)
    one, mesh = res["one"][0], res["mesh"][0]
    check(np.array_equal(one.valid, mesh.valid), "farm validity differs")
    check(one.valid[:, cfg.window_len(fps):].all(), "farm BPM never valid")
    _close(mesh.bpm, one.bpm, "farm BPM")
    _close(mesh.green, one.green, "farm green")
    out["farm"] = {"streams": sz.farm_streams, "frames": sz.farm_frames,
                   "height": H, "width": W,
                   "one_card_s": round(res["one"][1], 4),
                   "mesh_s": round(res["mesh"][1], 4)}
    del frames

    # 2. slot-sharded serving pool ----------------------------------------
    # The pool's default skin detector: its boxes are exact integer
    # functions of the pixels.  (The MediaPipe nets' bf16 convolutions
    # round differently at another per-card batch size, which can move a
    # landmark box by a pixel; the served MediaPipe path is the single-card
    # serving phase's.)
    pcfg = live.LiveConfig(fps=fps, detect_every=8,
                           welch_segment_seconds=sz.live_segment_s)
    S = sz.serve_slots
    H, W = sz.live_hw
    plate = SynthSpec(height=H, width=W, fps=fps, duration_s=1.0 / fps,
                      noise_std=0.0)
    base = np.asarray(synthesize_on_device(plate)[0][0])
    skin = np.any(base != np.asarray(plate.background_bgr, np.uint8), -1)

    def slot_frame(s, t):
        f = base.copy()
        p = 2.0 * np.sin(2 * np.pi * (60.0 + 3 * s) / 60.0 * t / fps)
        g = f[..., 1].astype(np.float32)
        g[skin] += p
        f[..., 1] = np.clip(np.rint(g), 0, 255).astype(np.uint8)
        return f

    pools = {"one": BpmServer(pcfg, n_slots=S),
             "mesh": BpmServer(pcfg, n_slots=S,
                               mesh=vmesh.make_mesh(("slot",),
                                                    devices=devices))}
    got = {k: [] for k in pools}
    secs = {k: 0.0 for k in pools}
    for p in pools.values():
        for _ in range(S):
            p.attach()
    for t in range(sz.pool_ticks):
        batch = {s: slot_frame(s, t) for s in range(S)}
        for k, p in pools.items():
            t0 = time.perf_counter()
            o = p.tick(batch)
            secs[k] += time.perf_counter() - t0
            got[k].append([o[s] for s in range(S)])
    n_valid = 0
    for t in range(sz.pool_ticks):
        for s in range(S):
            a, b = got["one"][t][s], got["mesh"][t][s]
            check(np.array_equal(a.box, b.box), f"pool box t={t} s={s}")
            check(bool(a.face_valid) == bool(b.face_valid)
                  and bool(a.bpm_valid) == bool(b.bpm_valid),
                  f"pool validity t={t} s={s}")
            _close(b.green_raw, a.green_raw, f"pool green t={t} s={s}")
            _close(b.bpm, a.bpm, f"pool BPM t={t} s={s}")
            n_valid += bool(a.bpm_valid)
    check(n_valid > 0, "pool BPM never valid")
    out["pool"] = {"slots": S, "ticks": sz.pool_ticks,
                   "valid_bpm_answers": n_valid,
                   "one_card_tick_ms": round(1e3 * secs["one"]
                                             / sz.pool_ticks, 3),
                   "mesh_tick_ms": round(1e3 * secs["mesh"]
                                         / sz.pool_ticks, 3)}
    del pools

    # 3. time-sharded long recording ----------------------------------------
    H, W = sz.long_hw
    T = sz.long_frames
    lcfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    det_small = functools.partial(detect_faces,
                                  cfg=SkinDetectorConfig(downsample=4))
    frames, _, _ = synthesize_on_device(SynthSpec(
        height=H, width=W, fps=fps, duration_s=T / fps, bpm=66.0,
        noise_std=1.0, seed=seed))
    res = {}
    for name, devs in (("one", devices[:1]), ("mesh", devices)):
        m = vmesh.make_mesh(("time",), devices=devs)
        f = frames if name == "one" else vmesh.shard(frames, m, "time")
        r, secs_ = timed(measure_green_avg_sharded, f, fps, m, lcfg,
                         detector=det_small)
        r, secs_ = timed(measure_green_avg_sharded, f, fps, m, lcfg,
                         detector=det_small)
        res[name] = (jax.device_get(r), secs_)
        del f
    (b1, ok1, g1), (b4, ok4, g4) = res["one"][0], res["mesh"][0]
    check(np.array_equal(ok1, ok4), "long-recording validity differs")
    check(ok1[lcfg.window_len(fps):].all(), "long-recording BPM never valid")
    _close(b4, b1, "long-recording BPM")
    _close(g4, g1, "long-recording green")

    # Holdover boxes across shard boundaries: real detector boxes with
    # dropout runs (some longer than the 15-frame budget) that straddle
    # the shard edges, sequential scan on one card vs the sharded carry.
    boxes, dvalid = det_small(frames)
    drop = np.ones(T, bool)
    edge = T // n
    for e in range(1, n):
        drop[e * edge - 5:e * edge + 3] = False            # short, crossing
    drop[edge // 2:edge // 2 + 20] = False                 # > budget
    dvalid = jnp.logical_and(dvalid, jnp.asarray(drop))
    seq = vroi.holdover(boxes, dvalid, lcfg.roi.landmark_hold_frames)
    tm = vmesh.make_mesh(("time",), devices=devices)
    shd = sharded_holdover(vmesh.shard(boxes, tm, "time"),
                           vmesh.shard(dvalid, tm, "time"), tm,
                           lcfg.roi.landmark_hold_frames)
    check(np.array_equal(np.asarray(shd.box), np.asarray(seq.box)),
          "sharded holdover boxes differ")
    check(np.array_equal(np.asarray(shd.valid), np.asarray(seq.valid)),
          "sharded holdover validity differs")
    out["long"] = {"frames": T, "height": H, "width": W,
                   "gb_per_card": round(T * H * W * 3 / n / 1e9, 3),
                   "one_card_s": round(res["one"][1], 4),
                   "mesh_s": round(res["mesh"][1], 4)}
    return out


# --- driver ------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multi", action="store_true",
                   help="run the three cross-device paths on 4 cards")
    p.add_argument("--rehearse", action="store_true",
                   help="CPU, toy sizes: check paths and control flow")
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "vhr_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.multi:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    else:
        # One process per card: give it most of the card (the farm and the
        # long recording hold several GB of frames on one card).
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.90")
    sys.path.insert(0, REPO)

    for line in card_lines(args.rehearse):
        log(line)

    import jax
    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    from vhr_tpu import backend

    need = 4 if args.multi else 1
    if args.rehearse:
        info = backend.device_info()
    else:
        try:
            info = backend.require_gpu(need)
        except RuntimeError as e:
            print(f"no GPU: {e}", file=sys.stderr)
            return 2
    if info["count"] < need:
        print(f"need {need} devices, JAX found {info['count']}",
              file=sys.stderr)
        return 2
    # A rehearsal compiles for the CPU it runs on and keeps no cache.
    cache = None if args.rehearse else backend.enable_compile_cache()
    log(f"device: {json.dumps(info)}; compile cache: {cache}")
    sz = TOY if args.rehearse else FULL

    if args.multi:
        t0 = time.perf_counter()
        res = phase_multi(sz, args.seed, jax.devices()[:4])
        log(f"[multi] wall_s={time.perf_counter() - t0:.3f} "
            f"{json.dumps(res)}")
        info = dict(info, count=4)
    else:
        for name, phase in (("offline", phase_offline), ("live", phase_live),
                            ("serving", phase_serving), ("evm", phase_evm)):
            t0 = time.perf_counter()
            res = phase(sz, args.seed)
            log(f"[{name}] wall_s={time.perf_counter() - t0:.3f} "
                f"{json.dumps(res)}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
