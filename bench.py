"""Benchmarks: flagship offline throughput + (--full) latency/scale configs.

Runs on an NVIDIA GPU only: a measurement run that finds no GPU fails
instead of falling back to the CPU (``vhr_tpu.backend.require_gpu``).
Every result names the device it ran on (``device``: platform, device
kind, device count as JAX reports them).

Default run prints ONE JSON line — the headline metric: sustained 1080p
frames/sec/card of the FLAGSHIP offline pipeline (reference
``green_avg.py:7-8``): 30 s window / 10 s acquisition, full-frame skin
detection every frame, landmark holdover, cheek-ROI channel means,
per-frame rolling FFT BPM (exact growing-window DFT during the ramp).

``python bench.py --full`` additionally measures
  * live ``step()`` frame-in -> BPM-out latency (720p, BASELINE config 4),
  * 64-stream 720p batched monitoring throughput (BASELINE config 5),
  * the production MediaPipe nets, the serving pool tick and EVM,
  * file-in -> BPM-out with the native threaded decode (staging-ring stats),
and writes everything to ``results/bench_detail.json`` (stdout still gets
exactly the one headline line; the rest goes to stderr).

Conventions kept for now (the benchmark's own PR revisits them):
repetitions run inside one jitted ``lax.scan`` over distinct per-rep
offsets, and the input batch materializes on device each rep behind an
``optimization_barrier`` (its write cost is included).

``--record`` writes the gated metrics, keyed by the device kind, to
``results/bench_baselines.json``; ``--check`` compares a fresh run with a
recording made on the same device kind.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_FPS = 500.0     # BASELINE.md: >=500 sustained 1080p frames/sec
LIVE_BUDGET_MS = 33.0    # BASELINE.md: livestream p50 within a 33 ms budget


def _timed_median(call, n=3):
    """Median wall time of ``n`` calls with distinct seeds (the warm-up
    call that compiles is the caller's).  ``call(seed)`` must block until
    its result is ready."""
    import jax.numpy as jnp
    times = []
    for k in range(n):
        t0 = time.perf_counter()
        call(jnp.uint8(1 + k))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _portrait_canvas(H, W):
    """The bundled real portrait centred on a grey ``(H, W, 3)`` canvas
    (numpy only), or the synthetic face plate when the asset is absent."""
    from vhr_tpu.utils.realface import real_face_image

    img = real_face_image()
    if img is None:
        base, noise = _face_plate(H, W, seed=9)
        return np.minimum(base.astype(np.uint16) + noise,
                          255).astype(np.uint8)
    h, w = min(img.shape[0], H), min(img.shape[1], W)
    out = np.full((H, W, 3), 96, np.uint8)
    y0, x0 = (H - h) // 2, (W - w) // 2
    out[y0:y0 + h, x0:x0 + w] = img[:h, :w]
    return out


def _downsample4(frame):
    """Exact 4x4 block means (what INTER_AREA computes for a 4x shrink)."""
    H, W = frame.shape[0] // 4 * 4, frame.shape[1] // 4 * 4
    f = frame[:H, :W].reshape(H // 4, 4, W // 4, 4, 3).astype(np.float32)
    return np.rint(f.mean(axis=(1, 3))).astype(np.uint8)


def _face_plate(H, W, seed=0):
    """Host-side 1-frame template: skin ellipse on dark background."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cx, cy, rx, ry = 0.5 * W, 0.45 * H, 0.16 * W, 0.26 * H
    face = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1.0
    base = np.where(face[..., None],
                    np.array([105, 135, 180], np.float32),
                    np.array([60, 60, 60], np.float32)).astype(np.uint8)
    noise = np.random.default_rng(seed).integers(0, 8, (H, W, 3), np.uint8)
    return base, noise


def bench_flagship() -> dict:
    """Headline: honest flagship config (30 s/10 s, full-res detection every
    frame) on 1080p frames resident in device memory."""
    import jax
    import jax.numpy as jnp

    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.ops import windows as vwin
    from vhr_tpu.pipeline import offline

    T, H, W = 960, 1080, 1920           # 32 s @ 30 fps -> full 30 s window
    REPS = 32
    cfg = PipelineConfig()               # 30 s window / 10 s acquisition
    fps = 30.0

    base, noise = _face_plate(H, W)
    offs = np.random.default_rng(1).integers(0, 4, (T, 1, 1, 1), np.uint8)
    base_j, noise_j, offs_j = map(jnp.asarray, (base, noise, offs))
    jax.block_until_ready((base_j, noise_j, offs_j))

    def one(base, noise, offs, i):
        # Small per-rep offset (i % 8) keeps pixels inside the skin chroma
        # box, so detection genuinely succeeds every rep (validity checked
        # below — an undetected face would SKIP the ROI pass and flatter the
        # number).
        frames = jax.lax.optimization_barrier(
            base[None] + noise[None] + offs
            + jax.lax.rem(i, jnp.uint8(8)))
        trace = offline.extract_signals(frames, cfg)
        green = offline._fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
        rolling = vwin.rolling_bpm_fft(
            green, fps, cfg.band,
            cfg.window_len(fps), cfg.acquisition_len(fps))
        ok = jnp.logical_and(rolling.valid, trace.valid)
        return jnp.sum(rolling.bpm), jnp.sum(ok.astype(jnp.int32))

    @jax.jit
    def reps(base, noise, offs, seed):
        def body(c, i):
            s, v = one(base, noise, offs, i + seed)
            return (c[0] + s, c[1] + v), None
        out, _ = jax.lax.scan(body, (jnp.float32(0), jnp.int32(0)),
                              jnp.arange(REPS, dtype=jnp.uint8))
        return out

    last = {}

    def call(seed):
        _, n_valid = reps(base_j, noise_j, offs_j, seed)
        last["n_valid"] = int(n_valid)               # blocks on the result

    call(jnp.uint8(0))                               # compile + warm
    dt = _timed_median(call)
    n_valid = last["n_valid"]
    fps_card = T * REPS / dt

    # Honesty check: (almost) every post-acquisition frame produced a valid
    # detection + estimate; otherwise the ROI pass was partially skipped.
    expect = (T - cfg.acquisition_len(fps)) * REPS
    assert n_valid >= 0.95 * expect, (n_valid, expect)

    return {
        "metric": "offline_1080p_rppg_frames_per_sec_per_card",
        "value": round(fps_card, 1),
        "unit": "frames/sec",
        "vs_baseline": round(fps_card / BASELINE_FPS, 2),
        "config": {"frames": T, "h": H, "w": W, "reps": REPS,
                   "window_s": cfg.window_seconds,
                   "acquisition_s": cfg.acquisition_seconds,
                   "detection": "full-resolution skin test, every frame",
                   "valid_frames": n_valid},
    }


def bench_live_latency() -> dict:
    """BASELINE config 4: live step() frame-in -> BPM-out latency, 720p."""
    import jax
    import jax.numpy as jnp

    from vhr_tpu.pipeline import live

    H, W = 720, 1280
    K = 40
    cfg = live.LiveConfig(fps=30.0)

    base, noise = _face_plate(H, W, seed=2)
    offs = np.random.default_rng(3).integers(0, 4, (K, 1, 1, 1), np.uint8)
    frames = jnp.asarray(
        np.minimum(base[None].astype(np.uint16) + noise[None] + offs,
                   255).astype(np.uint8))
    jax.block_until_ready(frames)

    # Sequential synced calls: dispatch, device compute and the result
    # fetch in series, every frame.
    step = live.make_step(cfg, donate=True)
    state = live.init_state(cfg)
    state, out = step(state, frames[0])
    float(out.bpm)                               # compile + warm
    lats = []
    for i in range(1, K):
        t0 = time.perf_counter()
        state, out = step(state, frames[i])
        float(out.bpm)
        lats.append((time.perf_counter() - t0) * 1e3)
    p50_rtt = float(np.percentile(lats, 50))

    # Pipelined host loop (the production serving shape): dispatch frame N, then read frame N-1's BPM — the dispatch round trip
    # overlaps device compute at a one-frame answer lag (the reference's
    # async detector accepts the same lag, rppg_LIVESTREAM.py:335-341).
    pipe = live.LivePipeline(cfg, donate=True)
    pipe.submit(frames[0])                       # fill the 1-deep queue
    lats_p = []
    for i in range(1, K):
        t0 = time.perf_counter()
        out = pipe.submit(frames[i])
        float(out.bpm)                           # prev frame, already host
        lats_p.append((time.perf_counter() - t0) * 1e3)
    pipe.flush()
    p50_pipelined = float(np.percentile(lats_p, 50))

    # Host-origin frames (the true serving shape: the camera frame crosses
    # the host->device link every step).  BGR ships 3 B/px; transfer="i420"
    # ships planar YUV 4:2:0 (1.5 B/px, reconstructed on device bit-exactly
    # vs OpenCV).  The i420_ds4 row composes host 4x block-mean
    # downsampling (commutes with the ROI's own spatial mean; the
    # spatial_resolution degradation sweep measures the accuracy impact)
    # with I420 staging: 32x fewer bytes per step.
    host_frames = np.asarray(frames)
    host_rows = {}
    for mode, ds in (("bgr", 1), ("i420", 1), ("i420_ds4", 4)):
        transfer = "i420" if mode.startswith("i420") else "bgr"

        def feed(f, _ds=ds, _t=transfer):
            if _ds > 1:
                f = _downsample4(f)
            return jnp.asarray(live.bgr_to_i420_host(f) if _t == "i420"
                               else f)

        # The budget-claim row (i420_ds4) is measured as a DISTRIBUTION
        # over >=5 independent runs (fresh pipeline each), not one pass.
        n_runs = 5 if ds == 4 else 1
        run_p50s, all_lats = [], []
        for _r in range(n_runs):
            pipe_h = live.LivePipeline(cfg, donate=True, transfer=transfer)
            pipe_h.submit(feed(host_frames[0]))
            lats_h = []
            for i in range(1, K):
                t0 = time.perf_counter()
                out = pipe_h.submit(feed(host_frames[i]))
                float(out.bpm)
                lats_h.append((time.perf_counter() - t0) * 1e3)
            pipe_h.flush()
            run_p50s.append(round(float(np.percentile(lats_h, 50)), 2))
            all_lats.extend(lats_h)
        host_rows[f"p50_pipelined_hostframe_{mode}"] = round(
            float(np.percentile(all_lats, 50)), 2)
        if n_runs > 1:
            p90 = float(np.percentile(all_lats, 90))
            host_rows[f"hostframe_{mode}_dist"] = {
                "runs": n_runs, "steps_per_run": K - 1,
                "per_run_p50": run_p50s,
                "p50": round(float(np.percentile(all_lats, 50)), 2),
                "p90": round(p90, 2),
                "margin_p90_ms": round(LIVE_BUDGET_MS - p90, 2),
            }

    # frames_per_call=4 micro-batches the loop: 4 frames ship as ONE upload,
    # run as one 4-step lax.scan, and return as one fetch — one round trip
    # per 4 frames.  Batched calls make per-step latencies bimodal, so
    # report the steady-state mean ms/frame over the whole run.
    pipe_b = live.LivePipeline(cfg, donate=True, transfer="i420",
                               frames_per_call=4)
    feed4 = lambda f: live.bgr_to_i420_host(_downsample4(f))
    for i in range(8):                          # warm both compiles + queue
        pipe_b.submit(feed4(host_frames[i % K]))
    t0 = time.perf_counter()
    for i in range(1, K):
        pipe_b.submit(feed4(host_frames[i]))
    # drain the queued batch inside the timed window (fair accounting)
    out = pipe_b.submit(feed4(host_frames[0]))
    dt = time.perf_counter() - t0
    pipe_b.flush()
    host_rows["ms_per_frame_hostframe_i420_ds4_mbatch4"] = round(
        dt * 1e3 / K, 2)

    # Scan-amortized device compute per frame (one dispatch, K steps).
    @jax.jit
    def run(state, frames, seed):
        def body(s, f):
            s2, o = live.step(s, f, cfg)
            return s2, o.bpm
        s, bpms = jax.lax.scan(body, state,
                               frames + seed.astype(frames.dtype))
        return jnp.sum(bpms)

    float(run(live.init_state(cfg), frames, jnp.uint8(0)))   # compile + warm
    times = []
    for k in range(3):
        t0 = time.perf_counter()
        float(run(live.init_state(cfg), frames, jnp.uint8(1 + k)))
        times.append(time.perf_counter() - t0)
    per_frame_ms = float(np.median(times)) * 1e3 / K

    return {
        "metric": "live_720p_step_latency_ms",
        "p50_sequential": round(p50_rtt, 2),
        "p50_pipelined": round(p50_pipelined, 2),
        **host_rows,
        "device_compute_per_frame_amortized": round(per_frame_ms, 3),
        "unit": "ms",
        "budget_ms": LIVE_BUDGET_MS,
        "within_budget": per_frame_ms <= LIVE_BUDGET_MS,
        "within_budget_pipelined": p50_pipelined <= LIVE_BUDGET_MS,
        # The micro-batch row is AMORTIZED ms/frame — a frame can wait up
        # to (M-1) frame periods for its batch to fill, so it does not
        # bound per-frame latency; the per-frame host-origin numbers are
        # the single-frame i420+ds4 rows (p50, and p90 over 5 runs).
        "within_budget_hostframe_p50": (
            host_rows["p50_pipelined_hostframe_i420_ds4"]
            <= LIVE_BUDGET_MS),
        "within_budget_hostframe_p90": (
            host_rows["hostframe_i420_ds4_dist"]["p90"] <= LIVE_BUDGET_MS),
        "within_budget_hostframe_amortized": (
            host_rows["ms_per_frame_hostframe_i420_ds4_mbatch4"]
            <= LIVE_BUDGET_MS),
        "config": {"h": H, "w": W, "steps": K, "ring_len": cfg.ring_len},
    }


def bench_multistream() -> dict:
    """BASELINE config 5: 64 concurrent 720p streams on one card.

    Each leg (skin / mediapipe-farm) runs under its own try/except: one
    failed leg reports ``errors[leg]`` for itself while the healthy leg's
    numbers survive."""
    import traceback

    import jax
    import jax.numpy as jnp

    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.models.skin_detector import SkinDetectorConfig
    from vhr_tpu.parallel import mesh as vmesh, streams

    S, T, H, W = 64, 32, 720, 1280
    det = SkinDetectorConfig(downsample=4)       # documented many-stream mode
    REPS = 16
    fps = 30.0
    cfg = PipelineConfig(window_seconds=1.0, acquisition_seconds=0.5)
    smesh = vmesh.stream_mesh(jax.devices()[:1])

    base, noise = _face_plate(H, W, seed=4)
    offs = np.random.default_rng(5).integers(
        0, 4, (S, T, 1, 1, 1), np.uint8)
    base_j, noise_j, offs_j = map(jnp.asarray, (base, noise, offs))
    jax.block_until_ready((base_j, noise_j, offs_j))

    def one(base, noise, offs, i):
        frames = jax.lax.optimization_barrier(
            base[None, None] + noise[None, None] + offs
            + jax.lax.rem(i, jnp.uint8(8)))
        res = streams.multistream_green_bpm(frames, fps, smesh, cfg, det)
        return (jnp.sum(res.bpm),
                jnp.sum(res.valid.astype(jnp.int32)))

    @jax.jit
    def reps(base, noise, offs, seed):
        def body(c, i):
            s, v = one(base, noise, offs, i + seed)
            return (c[0] + s, c[1] + v), None
        out, _ = jax.lax.scan(body, (jnp.float32(0), jnp.int32(0)),
                              jnp.arange(REPS, dtype=jnp.uint8))
        return out

    last = {}
    errors = {}

    def call(seed):
        _, n_valid = reps(base_j, noise_j, offs_j, seed)
        last["n_valid"] = int(n_valid)               # blocks on the result

    agg_fps = n_valid = None
    try:
        call(jnp.uint8(0))                           # compile + warm
        dt = _timed_median(call)
        n_valid = last["n_valid"]
        agg_fps = S * T * REPS / dt
        expect = S * (T - cfg.acquisition_len(fps)) * REPS
        assert n_valid >= 0.95 * expect, (n_valid, expect)
    except Exception as e:
        errors["skin"] = repr(e)
        traceback.print_exc(file=sys.stderr)

    # Production-weights farm: the ported MediaPipe detector data-parallel
    # over the stream mesh (streams.multistream_green_bpm(detector=...)),
    # detect+mesh EVERY frame on the real bundled portrait.  Short chunks
    # (T=8) bound the letterboxed f32 intermediate; the rolling window
    # shrinks to match so validity still asserts end-to-end detection.
    mp_fps = mp_valid = None
    try:
        from vhr_tpu.models.mediapipe_face import make_mediapipe_detector

        frame_mp = _portrait_canvas(H, W)
        Sm, Tm, REPSm = S, 8, 24
        # 8-sample window at 10 fps: df=1.25 Hz puts bins in the HR
        # band and meets estimate_bpm's N>=8 floor (estimate_bpm.py:31)
        # on the chunk's last frame — windowing is exercised end-to-end
        # while the 8-frame chunks bound the letterboxed f32
        # intermediate (the detector, not the DSP, is the load here).
        fps_mp = 10.0
        cfg_mp = PipelineConfig(window_seconds=0.8,
                                acquisition_seconds=0.8)
        det_mp = make_mediapipe_detector()
        frame_j = jnp.asarray(frame_mp)
        offs_mp = jnp.asarray(np.random.default_rng(7).integers(
            0, 4, (Sm, Tm, 1, 1, 1), np.uint8))
        jax.block_until_ready((frame_j, offs_mp))

        @jax.jit
        def reps_mp(frame, offs, seed):
            def body(c, i):
                fr = jax.lax.optimization_barrier(
                    frame[None, None] + offs
                    + jax.lax.rem(i + seed, jnp.uint8(4)))
                res = streams.multistream_green_bpm(
                    fr, fps_mp, smesh, cfg_mp, detector=det_mp)
                return (c[0] + jnp.sum(res.bpm),
                        c[1] + jnp.sum(res.valid.astype(jnp.int32))), None
            out, _ = jax.lax.scan(body, (jnp.float32(0), jnp.int32(0)),
                                  jnp.arange(REPSm, dtype=jnp.uint8))
            return out

        def call_mp(seed):
            _, v = reps_mp(frame_j, offs_mp, seed)
            last["n_valid_mp"] = int(v)

        call_mp(jnp.uint8(0))
        dt_mp = _timed_median(call_mp)
        mp_fps = Sm * Tm * REPSm / dt_mp
        mp_valid = last["n_valid_mp"]
        expect_mp = Sm * REPSm * (
            Tm - cfg_mp.acquisition_len(fps_mp) + 1)
        assert mp_valid >= 0.95 * expect_mp, (mp_valid, expect_mp)
    except Exception as e:
        errors["mediapipe_farm"] = repr(e)
        traceback.print_exc(file=sys.stderr)
        mp_fps = None

    out = {
        "metric": "multistream_720p_frames_per_sec_per_card",
        "aggregate_fps": round(agg_fps, 1) if agg_fps else None,
        "per_stream_fps": round(agg_fps / S, 1) if agg_fps else None,
        "mediapipe_farm_aggregate_fps":
            round(mp_fps, 1) if mp_fps else None,
        "unit": "frames/sec",
        "config": {"streams": S, "chunk_frames": T, "h": H, "w": W,
                   "reps": REPS, "detection_downsample": det.downsample,
                   "mediapipe_farm": ("production detect+mesh every frame, "
                                      "real portrait, 64 streams x 8-frame "
                                      "chunks"),
                   "valid_frames": n_valid,
                   "mediapipe_farm_valid_frames": mp_valid},
    }
    if errors:
        out["errors"] = errors
    return out


def _bench_clip(H, W, secs, fourcc_pref):
    """Synthesize + encode the bench clip once; returns (path, codec)."""
    import os
    import tempfile

    from vhr_tpu.io import native
    from vhr_tpu.utils.synth import SynthSpec, synthesize

    v = None
    for fourcc in fourcc_pref:
        path = os.path.join(tempfile.gettempdir(),
                            f"vhr_bench_{H}p_{int(secs)}s_{fourcc}.avi")
        if os.path.exists(path):
            return path, fourcc
        try:
            if v is None:
                print(f"[bench] synthesizing {H}p clip ({secs:.0f}s) ...",
                      file=sys.stderr)
                v = synthesize(SynthSpec(duration_s=secs, height=H, width=W,
                                         bpm=72.0, noise_std=1.0))
            with native.NativeVideoWriter(path, W, H, v.fps, fourcc) as wtr:
                for k in range(0, v.frames.shape[0], 32):
                    wtr.write(v.frames[k:k + 32])
            return path, fourcc
        except IOError:
            continue                    # codec not built in this image
    raise RuntimeError(f"no encoder available from {fourcc_pref}")


def bench_decode_e2e(clip_seconds: float = 15.0) -> dict:
    """File-in -> BPM-out, decomposed (SURVEY §7 risk (b)).  Needs the
    native reader (OpenCV's C++ libraries at build time).

    Reports, per codec (MJPG intra-only + an inter-frame codec when the
    image's OpenCV can encode one):
      * decode-only fps (drain the native reader, no device) for
        n_decoders in {1, 4} — isolates pure decode and the segment-
        parallel speedup (1-core host: expect ~none; the code path is the
        deliverable),
      * host->device copy fps (stage every chunk to the device, no
        compute) — isolates the transfer link,
      * end-to-end fps (decode overlapped with device compute),
    plus the staging-ring occupancy counters for the e2e run.
    """
    import jax
    import jax.numpy as jnp

    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.io import native
    from vhr_tpu.pipeline import offline

    H, W = 1080, 1920
    secs = clip_seconds
    out = {"metric": "decode_to_bpm_e2e_frames_per_sec",
           "unit": "frames/sec", "resolution": f"{W}x{H}", "codecs": {}}

    for fourcc_pref in (("MJPG",), ("avc1", "H264", "XVID")):
        try:
            path, codec = _bench_clip(H, W, secs, fourcc_pref)
        except RuntimeError as e:
            out["codecs"][fourcc_pref[0]] = {"error": repr(e)}
            continue
        entry = {}

        # (1) decode-only: drain the reader, count wall time.
        for n_dec in (1, 4):
            with native.NativeVideoReader(path, chunk_frames=64,
                                          n_decoders=n_dec) as r:
                t0 = time.perf_counter()
                n = sum(c.shape[0] for c in r)
                dt = time.perf_counter() - t0
            entry[f"decode_only_fps_n{n_dec}"] = round(n / dt, 1)

        # (2) decode + host->device copy, no compute — BGR (3 B/px) vs the
        # planar I420 staging mode (1.5 B/px): the transfer link is the
        # measured bottleneck, so halving-and-halving the bytes is the lever.
        for fmt in ("bgr", "i420"):
            with native.NativeVideoReader(path, chunk_frames=64,
                                          fmt=fmt) as r:
                t0 = time.perf_counter()
                n = 0
                for c in r:
                    jax.block_until_ready(jnp.asarray(c))
                    n += c.shape[0]
                dt = time.perf_counter() - t0
            key = ("decode_plus_h2d_fps" if fmt == "bgr"
                   else "decode_plus_h2d_fps_i420")
            entry[key] = round(n / dt, 1)

        # (3) end-to-end (decode overlapped with device compute),
        # both staging formats (i420 reconstructs BGR on device, bit-exact
        # vs OpenCV — ops/color.py::i420_to_bgr_flat).
        cfg = PipelineConfig(window_seconds=5.0, acquisition_seconds=2.0)
        for fmt in ("bgr", "i420"):
            stats: dict = {}
            t0 = time.perf_counter()
            bgr, valid, fps = offline.extract_signals_streaming(
                path, cfg, chunk_frames=64, ring_stats=stats, n_decoders=2,
                transfer=fmt)
            dt = time.perf_counter() - t0
            key = "e2e_fps" if fmt == "bgr" else "e2e_fps_i420"
            entry[key] = round(bgr.shape[0] / dt, 1)
            if fmt == "bgr":
                entry["frames"] = int(bgr.shape[0])
                entry["staging_ring"] = stats
        out["codecs"][codec] = entry

    out["value"] = next(iter(out["codecs"].values())).get("e2e_fps", 0.0)
    out["note"] = (
        "decode_only vs decode_plus_h2d vs e2e localizes the bottleneck.  "
        "The *_i420 rows stage planar YUV 4:2:0 (1.5 B/px, half the bytes) "
        "and reconstruct BGR on device bit-exactly vs OpenCV.  "
        "n_decoders=4 shows the segment-parallel decode path.")
    return out


def bench_mediapipe() -> dict:
    """Production face pipeline (ported MediaPipe weights) throughput:
    BlazeFace detect + 478-pt face mesh + landmark bbox, frames/sec/card.

    The reference runs this model one frame at a time through the C++
    TFLite runtime (``rppg_VIDEO.py:380`` detect_for_video is the hot
    cost); here the whole frame batch runs both conv nets in one program
    (``models/mediapipe_face.py``).  Uses the real bundled photograph on a
    720p canvas so the semantic output (detection + box) is genuine, not
    just FLOPs.
    """
    import jax
    import jax.numpy as jnp

    from vhr_tpu.models.mediapipe_face import load_face_models, _detect_single

    T, H, W = 256, 720, 1280
    REPS = 12
    frame = _portrait_canvas(H, W)
    frames_j = jnp.asarray(np.broadcast_to(frame[None], (T, H, W, 3)).copy())

    jax.block_until_ready(frames_j)

    def run_mode(compute_dtype, crop_mode="axis", activation_dtype=None):
        params, det_apply, lm_apply = load_face_models(
            compute_dtype=compute_dtype, activation_dtype=activation_dtype)

        @jax.jit
        def reps(frames, seed):
            def body(c, i):
                fr = jax.lax.optimization_barrier(
                    frames + jax.lax.rem(i + seed, jnp.uint8(4)))
                boxes, valid = _detect_single(params, det_apply, lm_apply,
                                              fr, crop_mode=crop_mode)
                return c + jnp.sum(boxes) + jnp.sum(valid), None
            out, _ = jax.lax.scan(body, jnp.int32(0),
                                  jnp.arange(REPS, dtype=jnp.uint8))
            return out

        last = {}

        def call(seed):
            last["v"] = int(reps(frames_j, seed))
        call(jnp.uint8(0))                       # compile + warm
        dt = _timed_median(call)
        # Semantic spot-check outside the timed loop: face must be found.
        _, valid = _detect_single(params, det_apply, lm_apply, frames_j[:1],
                                  crop_mode=crop_mode)
        return T * REPS / dt, dt, bool(np.asarray(valid)[0])

    # Headline = the PRODUCT DEFAULT mode (make_mediapipe_detector): bf16
    # activations + bf16 interchange — precision-comparable to the fp16
    # TFLite runtime the reference runs these weights on (landmark RMS vs
    # f32 pinned in tests/test_mediapipe_face.py).
    fps, dt, found = run_mode(jnp.bfloat16, activation_dtype=jnp.bfloat16)
    fps_f32, _, found_f32 = run_mode(None)
    fps_exact, _, found_exact = run_mode(None, crop_mode="exact")

    return {
        "metric": "mediapipe_face_pipeline_fps",
        "value": round(fps, 1),
        "unit": "frames/sec/card (720p, detect+mesh every frame)",
        "ms_per_frame": round(dt / (T * REPS) * 1e3, 3),
        "face_found": found,
        "f32_fps": round(fps_f32, 1),
        "f32_face_found": found_f32,
        "exact_crop_fps": round(fps_exact, 1),
        "exact_crop_face_found": found_exact,
        "config": {"frames": T, "h": H, "w": W, "reps": REPS,
                   "source": "bundled real portrait on a 720p canvas",
                   "note": ("detection cadence 1 (every frame); pipelines "
                            "typically run detect_every>=4 with holdover, "
                            "so end-to-end cost divides accordingly; "
                            "value = product default (bf16-activation "
                            "nets + bf16 interchange, crop_mode='axis' "
                            "separable matmul crop); f32_fps = f32-storage "
                            "opt-out (activation_dtype=None); "
                            "exact_crop_fps = MediaPipe-exact rotated "
                            "sampling (f32)")},
    }


def bench_evm() -> dict:
    """EVM magnification throughput (BASELINE config 3): ``magnify`` (full
    uint8 -> magnified-uint8 reconstruction) and ``magnified_pulse`` (the
    analysis signal) at 1080p, frames/sec/card.

    The reference only ever shipped a dead stub of this path
    (``/root/reference/rppg_VIDEO.py:120-124``), so there is no baseline.
    """
    import jax
    import jax.numpy as jnp

    from vhr_tpu.config import EVMConfig
    from vhr_tpu.pipeline import evm as vevm

    T, H, W = 64, 1080, 1920
    REPS_MAG, REPS_PULSE = 32, 64

    cfg = EVMConfig()
    base, noise = _face_plate(H, W, seed=11)
    frame = np.minimum(base.astype(np.uint16) + noise, 255).astype(np.uint8)
    frames_j = jnp.asarray(np.broadcast_to(frame[None], (T, H, W, 3)).copy())
    jax.block_until_ready(frames_j)

    def run(kind, reps):
        @jax.jit
        def loop(frames, seed):
            def body(c, i):
                fr = jax.lax.optimization_barrier(
                    frames + jax.lax.rem(i + seed, jnp.uint8(4)))
                if kind == "magnify":
                    out = vevm.magnify(fr, fps=30.0, cfg=cfg)
                    # Consume a strided slice (forces materialization of
                    # the full magnified clip without a full reduce).
                    return c + jnp.sum(
                        out[:, ::89, ::97, 1].astype(jnp.int32)), None
                pulse = vevm.magnified_pulse(fr, 30.0, cfg.band,
                                             levels=cfg.pyramid_levels)
                return c + jnp.sum(pulse).astype(jnp.int32), None
            out, _ = jax.lax.scan(body, jnp.int32(0),
                                  jnp.arange(reps, dtype=jnp.uint8))
            return out

        last = {}

        def call(seed):
            last["v"] = int(loop(frames_j, seed))
        call(jnp.uint8(0))                           # compile + warm
        return T * reps / _timed_median(call)

    fps_mag = run("magnify", REPS_MAG)
    fps_pulse = run("pulse", REPS_PULSE)
    return {
        "metric": "evm_magnify_fps",
        "value": round(fps_mag, 1),
        "unit": "frames/sec/card (1080p u8->u8 magnify)",
        "magnify_fps": round(fps_mag, 1),
        "pulse_fps": round(fps_pulse, 1),
        "config": {"frames": T, "h": H, "w": W,
                   "reps_magnify": REPS_MAG, "reps_pulse": REPS_PULSE,
                   "levels": cfg.pyramid_levels,
                   "note": ("per-rep input materialization inside the "
                            "scan (flagship convention)")},
    }


def bench_serving() -> dict:
    """Serving pool (``vhr_tpu/serving.py``): one batched dispatch advances
    S live clients' slots per tick.  Measures per-tick device compute and
    the implied client capacity at 30 fps — the deployment shape the
    reference cannot express (one camera per Python process,
    ``rppg_LIVESTREAM.py:256-366``).

    Frames are materialized per tick inside the scan (base + per-tick and
    per-slot offsets behind an optimization_barrier) — the same
    conservative input-write convention as the flagship bench.
    """
    import jax
    import jax.numpy as jnp

    from vhr_tpu import serving
    from vhr_tpu.pipeline import live
    from vhr_tpu.pipeline.offline import _split_detector

    H, W = 720, 1280

    base, noise = _face_plate(H, W, seed=5)
    base_d = jnp.asarray(base)
    noise_d = jnp.asarray(noise)

    rows = {}
    from vhr_tpu.models.mediapipe_face import make_mediapipe_detector
    mp_det = make_mediapipe_detector()
    # (row, detector, slots, ticks/call, detect_every): cadence rows
    # cond-skip the WHOLE batched detector on off-phase ticks (uniform
    # pool predicate).
    modes = [("skin_s16", None, 16, 512, 1),
             ("mediapipe_s16", mp_det, 16, 256, 1),
             ("mediapipe_s16_de8", mp_det, 16, 256, 8),
             ("mediapipe_s64", mp_det, 64, 96, 1),
             ("mediapipe_s64_de8", mp_det, 64, 96, 8)]
    for name, detector, S, T, de in modes:
        cfg = live.LiveConfig(fps=30.0, detect_every=de)
        det_fn, det_args = ((None, ()) if detector is None
                            else _split_detector(detector))
        active = jnp.ones((S,), bool)
        reset = jnp.zeros((S,), bool)
        slot_off = jnp.arange(S, dtype=jnp.uint16).reshape(S, 1, 1, 1) % 3

        @jax.jit
        def reps(state, seed, det_args):
            def body(s, t):
                fr = jnp.minimum(
                    base_d[None].astype(jnp.uint16) + noise_d[None]
                    + slot_off + (t % 4).astype(jnp.uint16),
                    255).astype(jnp.uint8)
                frames = jax.lax.optimization_barrier(
                    jnp.broadcast_to(fr, (S, H, W, 3)))
                s2, packed = serving._step_batched_impl(
                    s, frames, active, reset, t.astype(jnp.int32),
                    det_args, cfg, det_fn)
                return s2, jnp.sum(packed[:, 0])
            s, acc = jax.lax.scan(body, state,
                                  jnp.arange(T, dtype=jnp.uint16)
                                  + seed.astype(jnp.uint16))
            return jnp.sum(acc)

        def call(seed):
            float(reps(serving.init_state_batched(cfg, S), seed, det_args))

        call(jnp.uint8(0))                       # compile + warm
        dt = _timed_median(call)
        tick_ms = dt * 1e3 / T
        rows[name] = {
            "tick_ms": round(tick_ms, 3),
            "slots": S,
            "detect_every": de,
            "aggregate_fps": round(S * T / dt, 1),
            # one card ticking flat out, each client at 30 fps:
            "clients_at_30fps": int((S / 30.0) * (1e3 / tick_ms)),
            "duty_cycle_at_30fps": round(tick_ms * 30.0 / 1e3, 3),
        }

    return {
        "metric": "serving_pool_tick",
        "unit": "ms per 16-slot 720p tick (one dispatch, all clients)",
        "value": rows["skin_s16"]["tick_ms"],
        "detectors": rows,
        "config": {"h": H, "w": W,
                   "note": ("per-slot semantics pinned equal to the single "
                            "live step (tests/test_serving.py); capacity = "
                            "slots * tick_rate / 30; detect_every=N rows "
                            "cond-skip the whole batched detector on "
                            "off-phase pool ticks")},
    }


# --- perf regression gate --------------------------------------------------

# name -> (path into the result dict, relative tolerance, direction)
# direction +1 = bigger is better (fail when below baseline*(1-tol)),
#           -1 = smaller is better (fail when above baseline*(1+tol)).
CHECKS = {
    "flagship_fps": (("flagship", "value"), 0.25, +1),
    "live_device_ms": (("live_latency",
                        "device_compute_per_frame_amortized"), 0.5, -1),
    "mediapipe_fps": (("mediapipe", "value"), 0.5, +1),
    "multistream_agg_fps": (("multistream", "aggregate_fps"), 0.5, +1),
    "mediapipe_farm_fps": (("multistream", "mediapipe_farm_aggregate_fps"),
                           0.5, +1),
    "serving_tick_ms": (("serving", "value"), 0.5, -1),
    "serving_mp64_de8_agg_fps": (("serving", "detectors",
                                  "mediapipe_s64_de8", "aggregate_fps"),
                                 0.5, +1),
    "evm_magnify_fps": (("evm", "magnify_fps"), 0.5, +1),
    "evm_pulse_fps": (("evm", "pulse_fps"), 0.5, +1),
}
RESULTS_DIR = "results"
BASELINE_FILE = RESULTS_DIR + "/bench_baselines.json"


def _collect_check() -> dict:
    """One guarded section per bench: a crashed section reports
    ``{"error": ...}`` for itself instead of killing the whole gate.
    Missing metrics then FAIL the gate loudly in :func:`run_check`."""
    out = {}
    for name, fn in (("flagship", bench_flagship),
                     ("live_latency", bench_live_latency),
                     ("mediapipe", bench_mediapipe),
                     ("multistream", bench_multistream),
                     ("serving", bench_serving),
                     ("evm", bench_evm)):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": repr(e)}
            print(f"[check] section {name} crashed: {e!r}", file=sys.stderr)
    return out


def run_check(record: bool, device: dict) -> int:
    """``--check``: fail (exit 1) when any gated metric regresses past its
    tolerance band vs a recording made on the same device kind;
    ``--record`` refreshes that recording from a fresh run."""
    import os

    results = _collect_check()
    fresh = {}
    for name, (path, tol, direction) in CHECKS.items():
        v = results
        try:
            for k in path:
                v = v[k]
        except (KeyError, TypeError):
            v = None
        if v is None:
            # A gated metric that did not get measured is a loud failure,
            # never a silent skip.
            print(f"[check] metric {name} MISSING "
                  f"(section: {results.get(path[0], {}).get('error', '?')})",
                  file=sys.stderr)
        fresh[name] = v
    missing = [n for n, v in fresh.items() if v is None]

    if record:
        if missing:
            print(f"[check] refusing to record with missing metrics: "
                  f"{missing}", file=sys.stderr)
            return 1
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(BASELINE_FILE, "w") as f:
            json.dump({"device": device, "metrics": fresh,
                       "tolerances": {k: CHECKS[k][1] for k in CHECKS}},
                      f, indent=2)
        print(f"[check] recorded {fresh} -> {BASELINE_FILE}",
              file=sys.stderr)
        return 0

    if not os.path.exists(BASELINE_FILE):
        print(f"[check] no {BASELINE_FILE}; run bench.py --record first",
              file=sys.stderr)
        return 1
    with open(BASELINE_FILE) as f:
        recorded = json.load(f)
    if recorded.get("device", {}).get("kind") != device["kind"]:
        print(f"[check] baselines were recorded on {recorded.get('device')},"
              f" this run is on {device}; re-record", file=sys.stderr)
        return 1
    base = recorded["metrics"]
    failed = []
    for name, (path, tol, direction) in CHECKS.items():
        b, v = base.get(name), fresh[name]
        if b is None:
            # A CHECKS key with no recorded baseline is a gate hole, not a
            # pass.
            print(f"[check] {name}: NO BASELINE — re-run bench.py --record",
                  file=sys.stderr)
            failed.append(name)
            continue
        if v is None:
            failed.append(name)
            continue
        if direction > 0:
            ok = v >= b * (1.0 - tol)
        else:
            ok = v <= b * (1.0 + tol)
        status = "ok" if ok else "REGRESSED"
        print(f"[check] {name}: fresh={v} baseline={b} tol={tol:.0%} "
              f"{status}", file=sys.stderr)
        if not ok:
            failed.append(name)
    if failed:
        print(f"[check] FAILED: {failed}", file=sys.stderr)
        return 1
    print("[check] all gated metrics within tolerance", file=sys.stderr)
    return 0


def main() -> None:
    import os

    from vhr_tpu import backend

    device = backend.require_gpu()
    backend.enable_compile_cache()
    if "--check" in sys.argv or "--record" in sys.argv:
        raise SystemExit(run_check("--record" in sys.argv, device))
    full = "--full" in sys.argv
    headline = bench_flagship()
    out = {k: headline[k] for k in ("metric", "value", "unit", "vs_baseline")}
    out["device"] = device
    if full:
        detail = {"device": device, "flagship": headline}
        for name, fn in (("live_latency", bench_live_latency),
                         ("multistream", bench_multistream),
                         ("mediapipe", bench_mediapipe),
                         ("serving", bench_serving),
                         ("evm", bench_evm),
                         ("decode_e2e", bench_decode_e2e)):
            try:
                detail[name] = dict(fn(), device=device)
            except Exception as e:  # keep the headline printable regardless
                detail[name] = {"error": repr(e), "device": device}
            print(f"[bench] {name}: "
                  f"{json.dumps(detail[name])}", file=sys.stderr)
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR, "bench_detail.json")
        with open(path, "w") as f:
            json.dump(detail, f, indent=2)
        print(f"[bench] wrote {path}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
