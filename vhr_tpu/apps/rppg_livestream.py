"""Live webcam heart-rate app — the ``rppg_LIVESTREAM.py`` equivalent.

The reference's live loop couples an async MediaPipe callback, global deques
and a module-level SOS state (``rppg_LIVESTREAM.py:256-366``).  Here the
host loop is: grab frame -> one compiled device step
(``vhr_tpu.pipeline.live.step``) -> draw.  All state lives on device in a
donated pytree; the host never touches a filter coefficient.

Usage::

    python -m vhr_tpu.apps.rppg_livestream [--camera 0] [--video FILE]
        [--max-frames N] [--no-display] [--faces K]
        [--detector skin|landmarker|refined|mediapipe[-bf16|-exact]]

``--video`` replays a file as if it were a camera (useful headless);
``--no-display`` prints the BPM trace instead of opening windows;
``--faces K`` monitors K subjects concurrently (K live chains on device).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def run(source, cfg, max_frames=None, display=True, k_faces=1,
        detector=None, pipelined=True, plot=False, plot_out=None,
        transfer="bgr", ingest_downsample=1, fetch_every=1,
        frames_per_call=1) -> int:
    import cv2
    import jax.numpy as jnp

    from ..pipeline import live

    plotter = None
    if plot or plot_out:
        # In-loop signal panel parity (rppg_LIVESTREAM.py:78-91,343-345):
        # raw cheek green + filtered + BPM; interactive when displaying,
        # summary PNG on exit when headless.
        from ..utils.live_plot import LivePlotter
        plotter = LivePlotter(maxlen=cfg.ring_len, show=plot and display,
                              out_path=plot_out)

    cam = cv2.VideoCapture(source)
    if not cam.isOpened():
        print(f"error: could not open source {source!r}")
        return 1
    fps = cam.get(cv2.CAP_PROP_FPS) or 15.0   # rppg_LIVESTREAM.py:291 fallback
    cfg = dataclasses.replace(cfg, fps=float(fps))
    # Pipelined (default): dispatch frame N, then read frame N-1's output —
    # the dispatch round trip overlaps device compute, at a one-frame
    # answer lag (the reference's async detector has the same lag,
    # rppg_LIVESTREAM.py:335-341).  ``pipelined=False`` syncs every frame.
    pipe = live.LivePipeline(cfg, detector=detector, k_faces=k_faces,
                             donate=False, transfer=transfer,
                             fetch_every=fetch_every,
                             frames_per_call=frames_per_call)

    paused = False
    n = 0
    t_start = time.perf_counter()
    while max_frames is None or n < max_frames:
        if not paused:
            ret, frame = cam.read()
            if not ret:
                print("End of stream reached.")
                break
            dev_frame = frame
            if ingest_downsample > 1:
                # Host INTER_AREA downsample = exact kxk block means — the
                # same spatial averaging the ROI mean performs; the
                # degradation suite measures the (small) accuracy impact of
                # running at reduced resolution (spatial_resolution sweep).
                h2 = frame.shape[0] // ingest_downsample // 2 * 2
                w2 = frame.shape[1] // ingest_downsample // 2 * 2
                dev_frame = cv2.resize(frame, (w2, h2),
                                       interpolation=cv2.INTER_AREA)
            if transfer == "i420":
                # Host cvtColor (cv2's SIMD path) halves the bytes shipped
                # to the device; BGR is reconstructed on device bit-exactly.
                dev_frame = live.bgr_to_i420_host(dev_frame)
            # host arrays go straight in: the pipeline stages them (and
            # micro-batches the upload when frames_per_call > 1)
            out = pipe.submit(dev_frame)
            if not pipelined:
                out = pipe.flush()
            n += 1
            if isinstance(out, list):
                # fetch_every>1 batch: plot every sample, display the newest.
                if plotter is not None:
                    for o in out[:-1]:
                        plotter.push(
                            float(np.atleast_1d(o.green_raw)[0]),
                            float(np.atleast_1d(o.green_filtered)[0]),
                            float(np.atleast_1d(o.bpm)[0]),
                            bool(np.atleast_1d(o.bpm_valid)[0]))
                out = out[-1] if out else None
            if out is not None:
                # Normalize to a face axis so one path serves both modes.
                boxes = np.atleast_2d(out.box)
                bpms = np.atleast_1d(out.bpm)
                bpm_ok = np.atleast_1d(out.bpm_valid)
                face_ok = np.atleast_1d(out.face_valid)
                if plotter is not None:
                    plotter.push(float(np.atleast_1d(out.green_raw)[0]),
                                 float(np.atleast_1d(out.green_filtered)[0]),
                                 float(bpms[0]), bool(bpm_ok[0]))
                if bpm_ok.any():
                    if len(bpms) == 1:    # reference format, rppg_LIVESTREAM
                        print(f"Bpm after filtering: {bpms[0]:.2f}")
                    else:
                        msg = "  ".join(f"face{k}: {bpms[k]:.2f}"
                                        for k in range(len(bpms))
                                        if bpm_ok[k])
                        print(f"Bpm after filtering: {msg}")
                if display:
                    for k in range(len(boxes)):
                        # device boxes are in ingest coordinates; scale back
                        # to the display frame
                        x1, y1, x2, y2 = boxes[k] * ingest_downsample
                        if face_ok[k]:
                            cv2.rectangle(frame, (x1, y1), (x2, y2),
                                          (0, 255, 0), 2)
                        if bpm_ok[k]:
                            cv2.putText(frame, f"{bpms[k]:.1f} BPM",
                                        (8, 24 * (k + 1)),
                                        cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                                        (255, 255, 255), 2)
        if display:
            cv2.imshow("vhr_tpu livestream", frame)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord(" "):
                paused = not paused

    last = pipe.flush()
    if isinstance(last, list):
        last = last[-1] if last else None
    if last is not None and np.atleast_1d(last.bpm_valid).any():
        bpms = np.atleast_1d(last.bpm)
        print(f"Bpm after filtering: {bpms[0]:.2f}")
    if plotter is not None:
        saved = plotter.close()
        if saved:
            print(f"wrote signal plot to {saved}")
    dt = time.perf_counter() - t_start
    if n:
        print(f"processed {n} frames in {dt:.1f}s ({n / dt:.1f} fps)")
    cam.release()
    if display:
        cv2.destroyAllWindows()
    return 0


def main(argv=None) -> int:
    from ..pipeline import live

    p = argparse.ArgumentParser(description="Live heart-rate")
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--video", default=None,
                   help="replay a video file instead of a camera")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--no-display", action="store_true")
    p.add_argument("--plot", action="store_true",
                   help="live raw/filtered/BPM signal panel next to the "
                        "camera window (the reference's in-loop matplotlib "
                        "traces, rppg_LIVESTREAM.py:78-91); with "
                        "--no-display, implies a summary PNG on exit")
    p.add_argument("--plot-out", default=None, metavar="PNG",
                   help="write the signal panel to this file on exit "
                        "(works headless)")
    p.add_argument("--profile-trace", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the run "
                        "into DIR (view with TensorBoard)")
    p.add_argument("--sync", action="store_true",
                   help="read each frame's output before grabbing the next "
                        "(default is 1-frame-deep pipelining: dispatch N+1 "
                        "while N computes — lower latency per frame, one "
                        "frame of answer lag)")
    p.add_argument("--faces", type=int, default=1,
                   help="monitor up to K subjects at once (the reference "
                        "requests num_faces=2 but only processes face 0; "
                        "here every slot gets a full live chain)")
    p.add_argument("--transfer", default="bgr", choices=("bgr", "i420"),
                   help="host->device frame staging: i420 ships planar "
                        "YUV 4:2:0 (half the bytes) and reconstructs BGR "
                        "on device")
    p.add_argument("--ingest-downsample", type=int, default=1, metavar="K",
                   help="host-side INTER_AREA downsample (exact KxK block "
                        "means) before staging: K=4 with --transfer i420 "
                        "cuts the per-frame wire cost 32x (the lever for "
                        "bandwidth-limited host->device links)")
    p.add_argument("--fetch-every", type=int, default=1, metavar="N",
                   help="amortize the blocking output fetch over N frames "
                        "(one stacked fetch; answer lag <= N+1 frames) — "
                        "for high-round-trip host->device links")
    p.add_argument("--frames-per-call", type=int, default=1, metavar="M",
                   help="micro-batch M frames per device call (one upload, "
                        "one scan of M steps, one fetch; answer lag <= 2M "
                        "frames) — the stronger lever when each call costs "
                        "a round trip")
    p.add_argument("--detect-every", type=int, default=1, metavar="N",
                   help="run detection every N wall frames; holdover "
                        "tracking in between (all detection modes, "
                        "single- and multi-face)")
    p.add_argument("--detector", default="skin",
                   choices=["skin", "landmarker", "landmarker-real",
                            "refined", "mediapipe", "mediapipe-bf16",
                            "mediapipe-exact"],
                   help="single-face localization model (the reference's "
                        "live mode is MediaPipe, rppg_LIVESTREAM.py:336); "
                        "--faces >1 uses its own multi-face detectors")
    args = p.parse_args(argv)

    detector = None
    if args.detector != "skin":
        if args.faces == 1:
            from .rppg_video import _resolve_detector
            detector = _resolve_detector(args.detector)
        else:
            # Multi-face honors --detector too: tiled learned
            # proposals or the skin+refine cascade instead of pure chroma.
            from .rppg_video import _resolve_detector_multi
            detector = _resolve_detector_multi(args.detector, args.faces)
    cfg = live.LiveConfig(detect_every=args.detect_every)
    source = args.video if args.video is not None else args.camera
    print("PRESS q to quit -- PRESS spacebar to pause")
    plot_out = args.plot_out
    if args.sync and (args.frames_per_call > 1 or args.fetch_every > 1):
        p.error("--sync flushes every frame; it cannot combine with "
                "--frames-per-call/--fetch-every batching")
    if args.plot and args.no_display and plot_out is None:
        plot_out = "livestream_signals.png"
    import contextlib
    stack = contextlib.ExitStack()
    if args.profile_trace:
        from ..utils.profiling import device_trace
        stack.enter_context(device_trace(args.profile_trace))
    with stack:
        return run(source, cfg, max_frames=args.max_frames,
                   display=not args.no_display, k_faces=args.faces,
                   detector=detector, pipelined=not args.sync,
                   plot=args.plot, plot_out=plot_out, transfer=args.transfer,
                   ingest_downsample=args.ingest_downsample,
                   fetch_every=args.fetch_every,
                   frames_per_call=args.frames_per_call)


if __name__ == "__main__":
    from vhr_tpu.backend import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())
