"""Offline video heart-rate app — the ``rppg_VIDEO.py`` equivalent.

The reference interleaves decode, detection, filtering, Welch estimation and
matplotlib/cv2 UI in one per-frame ``while True`` (``rppg_VIDEO.py:354-430``),
recomputing the full 10 s filter+Welch stack every frame.  The batched
inversion: the whole video is processed as one batched program (all three
filters — Butterworth-2, Cheby2-4, FIR-41 — over every window at once), then
the results are rendered: an annotated output video (face box + cheek/
forehead ROI + BPM overlay, mirroring the reference's drawing at
``rppg_VIDEO.py:54,100``), a signal/BPM plot, and a console trace.

Usage::

    python -m vhr_tpu.apps.rppg_video VIDEO [--out-dir DIR] [--show]
        [--faces K] [--detector skin|landmarker|refined|mediapipe[-bf16|-exact]]
    python -m vhr_tpu.apps.rppg_video --videos-dir videos   # stdin picker
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from ..config import BAND_VIDEO, FilterConfig, PipelineConfig
from ..io import video as vio
from ..pipeline import offline


def _resolve_detector(name: str):
    """CLI detector choice -> pipeline detector callable (or None)."""
    if name == "skin":
        return None
    if name == "landmarker":
        from ..models.landmarker import load_default_detector
        return load_default_detector()
    if name == "landmarker-real":
        from ..models.landmarker import load_real_distilled_detector
        return load_real_distilled_detector()
    if name == "refined":
        from ..models.cascade import load_default_refined_detector
        return load_default_refined_detector()
    if name in ("mediapipe", "mediapipe-bf16", "mediapipe-exact"):
        import jax.numpy as jnp
        from ..models.mediapipe_face import make_mediapipe_detector
        cd = jnp.bfloat16 if name.endswith("bf16") else None
        cm = "exact" if name.endswith("exact") else "axis"
        return make_mediapipe_detector(compute_dtype=cd, crop_mode=cm)
    raise SystemExit(
        f"unknown detector {name!r} "
        "(skin|landmarker|refined|mediapipe|mediapipe-bf16|mediapipe-exact)")


def _resolve_detector_multi(name: str, k_faces: int):
    """CLI detector choice -> *multi-face* detector callable (or None).

    ``landmarker`` maps to the fully-learned tiled-proposal detector and
    ``refined`` to the skin-proposal + crop-refine cascade — so
    ``--detector`` is honored for ``--faces > 1`` instead of silently
    falling back to the chroma multiface path (ADVICE r2)."""
    if name == "skin":
        return None
    if name in ("mediapipe", "mediapipe-bf16", "mediapipe-exact"):
        import jax.numpy as jnp
        from ..models.mediapipe_face import make_mediapipe_detector_multi
        cd = jnp.bfloat16 if name.endswith("bf16") else None
        cm = "exact" if name.endswith("exact") else "axis"
        return make_mediapipe_detector_multi(k_faces=k_faces,
                                             compute_dtype=cd,
                                             crop_mode=cm)
    from ..models.landmarker import (load_default_detector,
                                     load_real_distilled_detector)
    from ..models.train import TrainConfig
    loader = (load_real_distilled_detector if name.endswith("-real")
              else load_default_detector)
    params = loader().args[0]
    if name in ("landmarker", "landmarker-real"):
        from ..models.cascade import make_tiled_detector_multi
        return make_tiled_detector_multi(params, TrainConfig().model,
                                         k_faces=k_faces)
    if name == "refined":
        from ..models.cascade import make_cascade_detector_multi
        return make_cascade_detector_multi(params, TrainConfig().model,
                                           k_faces=k_faces)
    raise SystemExit(f"unknown detector {name!r} "
                     "(skin|landmarker|refined|mediapipe|mediapipe-bf16|mediapipe-exact)")


def analyze(video_path: str, detector=None, detect_every: int = 1):
    """Run the app's three-filter analysis; returns a dict of traces.

    ``detect_every`` runs face detection on every N-th frame only, with
    holdover tracking in between (`pipeline.offline.extract_signals`) —
    an N-fold cut of the detector cost for ported-weights detectors."""
    import jax.numpy as jnp

    frames, fps = vio.read_video(video_path)
    if frames.shape[0] == 0:
        raise ValueError(f"empty video: {video_path}")
    fj = jnp.asarray(frames)

    results = {"fps": fps, "frames": frames}
    trace = offline.extract_signals(fj, detector=detector,
                                    detect_every=detect_every)
    results["green"] = np.asarray(trace.bgr[:, 1])
    results["boxes"] = np.asarray(trace.boxes)
    results["rois"] = np.asarray(trace.rois)
    results["valid"] = np.asarray(trace.valid)
    # Forehead ROI for display parity with the reference's second ROI
    # (rppg_VIDEO.py:102).
    from ..config import ROIConfig
    from ..ops import roi as vroi
    H, W = frames.shape[1:3]
    results["rois_forehead"] = np.asarray(
        vroi.forehead_roi(trace.boxes, ROIConfig(), W, H))

    # The reference's three filters over the 10 s window, Welch estimate
    # (rppg_VIDEO.py:402-409).
    for kind, order in [("butterworth", 2), ("cheby2", 4), ("fir", 41)]:
        cfg = PipelineConfig(
            window_seconds=10.0, band=BAND_VIDEO,
            filter=FilterConfig(kind=kind if kind != "fir" else "fir",
                                order=order, fir_numtaps=41))
        ts, bpm, valid = offline.measure_app_welch(
            fj, fps, cfg, detector=detector, detect_every=detect_every)
        results[f"bpm_{kind}"] = bpm
        results[f"valid_{kind}"] = valid
        results["ts"] = ts
    return results


def analyze_multi(video_path: str, k_faces: int, detector=None,
                  detect_every: int = 1):
    """K-subject analysis: per-face cheek-green traces + Welch BPM.

    Goes beyond the reference, which requests ``num_faces=2`` but renders
    only ``face_landmarks[0]`` (``rppg_LIVESTREAM.py:308,339``).
    """
    import jax.numpy as jnp

    frames, fps = vio.read_video(video_path)
    if frames.shape[0] == 0:
        raise ValueError(f"empty video: {video_path}")
    fj = jnp.asarray(frames)

    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0,
                         band=BAND_VIDEO, estimator="welch")
    trace = offline.extract_signals_multi(fj, k_faces, cfg,
                                          detector=detector,
                                          detect_every=detect_every)
    ts, bpm, ok = offline.measure_green_avg_multi(fj, fps, k_faces, cfg,
                                                  trace=trace)
    return {"fps": fps, "frames": frames, "ts": ts,
            "green": np.asarray(trace.bgr[..., 1]),       # (T, K)
            "boxes": np.asarray(trace.boxes),             # (T, K, 4)
            "rois": np.asarray(trace.rois),
            "valid": np.asarray(trace.valid),
            "bpm": bpm, "bpm_valid": ok}


def render_multi(results, out_dir: str) -> None:
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    frames, fps = results["frames"], results["fps"]
    K = results["boxes"].shape[1]

    annotated = frames.copy()
    for i in range(frames.shape[0]):
        for k in range(K):
            if results["valid"][i, k]:
                x1, y1, x2, y2 = results["boxes"][i, k]
                cv2.rectangle(annotated[i], (x1, y1), (x2, y2),
                              (0, 255, 0), 2)
                rx1, ry1, rx2, ry2 = results["rois"][i, k]
                cv2.rectangle(annotated[i], (rx1, ry1), (rx2, ry2),
                              (255, 0, 0), 2)
            if results["bpm_valid"][i, k]:
                cv2.putText(annotated[i],
                            f"face{k}: {results['bpm'][i, k]:.1f} BPM",
                            (8, 20 * (k + 1)), cv2.FONT_HERSHEY_SIMPLEX,
                            0.5, (255, 255, 255), 1)
    out_path = os.path.join(out_dir, "annotated_multi.mp4")
    vio.write_video(annotated, out_path, fps)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    ts = results["ts"]
    for k in range(K):
        ax1.plot(ts, results["green"][:, k], lw=0.8, label=f"face{k}")
        v = results["bpm_valid"][:, k]
        ax2.plot(ts[v], results["bpm"][v, k], lw=1.2, label=f"face{k}")
    ax1.set_ylabel("cheek green mean")
    ax1.legend()
    ax2.set_xlabel("time (s)")
    ax2.set_ylabel("BPM (Welch)")
    ax2.legend()
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "signals_multi.png"), dpi=150)
    plt.close(fig)
    print(f"wrote {out_path} and signals_multi.png to {out_dir}")


def live_panel_data(results, window_seconds: float = 10.0):
    """Per-frame trailing-window PSDs for the in-loop panels, computed in
    ONE batched device call (the device-friendly schedule for the reference's
    per-frame display loop, ``rppg_VIDEO.py:305-328, 385-411``: it
    re-filters + re-Welchs the trailing window on the host EVERY frame;
    here all T windows batch into one program and the host only draws).

    Returns ``(W, freqs, psd_butter (T', F), psd_cheby2 (T', F),
    bpm_butter (T',), bpm_cheby2 (T',))`` where row ``j`` covers frames
    ``[j, j+W)`` — i.e. replay frame ``i`` shows row ``i - W + 1`` (the
    window *ending* at frame ``i``; first full window at ``i = W - 1``).
    """
    import jax
    import jax.numpy as jnp

    from ..dsp import design, filters, spectral
    from ..ops.windows import sliding_windows

    fps = float(results["fps"])
    g = jnp.asarray(results["green"], jnp.float32)
    W = int(round(window_seconds * fps))
    T = g.shape[0]
    if T < W:          # T == W still yields one full window
        return None
    lo, hi = BAND_VIDEO.low_hz, BAND_VIDEO.high_hz
    sos_b = design.sos_design("butterworth", fps, lo, hi, order=2)
    sos_c = design.sos_design("cheby2", fps, lo, hi, order=4)
    nperseg = min(W, int(round(4.0 * fps)))

    @jax.jit
    def panels(g):
        win = sliding_windows(g, W)                    # (T-W+1, W)
        win = win - jnp.mean(win, axis=-1, keepdims=True)
        fb = jax.vmap(lambda x: filters.sosfiltfilt(sos_b, x))(win)
        fc = jax.vmap(lambda x: filters.sosfiltfilt(sos_c, x))(win)
        _, pb = spectral.welch_psd(fb, fps, nperseg)
        _, pc = spectral.welch_psd(fc, fps, nperseg)
        return pb, pc

    psd_b, psd_c = panels(g)
    freqs = np.fft.rfftfreq(nperseg, 1.0 / fps)
    pb, pc = np.asarray(psd_b), np.asarray(psd_c)
    inband = (freqs >= lo) & (freqs <= hi)
    bpm_b = 60.0 * freqs[inband][np.argmax(pb[:, inband], axis=1)]
    bpm_c = 60.0 * freqs[inband][np.argmax(pc[:, inband], axis=1)]
    return W, freqs, pb, pc, bpm_b, bpm_c


def render(results, out_dir: str, show: bool = False,
           live_panels: bool = False) -> None:
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    frames = results["frames"]
    fps = results["fps"]

    # Annotated video: face box (green), cheek ROI (blue), BPM text.
    annotated = frames.copy()
    for i in range(frames.shape[0]):
        if results["valid"][i]:
            x1, y1, x2, y2 = results["boxes"][i]
            cv2.rectangle(annotated[i], (x1, y1), (x2, y2), (0, 255, 0), 2)
            rx1, ry1, rx2, ry2 = results["rois"][i]
            cv2.rectangle(annotated[i], (rx1, ry1), (rx2, ry2), (255, 0, 0), 2)
            fx1, fy1, fx2, fy2 = results["rois_forehead"][i]
            cv2.rectangle(annotated[i], (fx1, fy1), (fx2, fy2), (255, 0, 0), 2)
        if results["valid_butterworth"][i]:
            txt = (f"BPM butter {results['bpm_butterworth'][i]:.1f} "
                   f"cheby2 {results['bpm_cheby2'][i]:.1f} "
                   f"fir {results['bpm_fir'][i]:.1f}")
            cv2.putText(annotated[i], txt, (8, 20),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    out_path = os.path.join(out_dir, "annotated.mp4")
    vio.write_video(annotated, out_path, fps)

    # Signal + BPM plot.
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    ts = results["ts"]
    ax1.plot(ts, results["green"], color="green", lw=0.8)
    ax1.set_ylabel("cheek green mean")
    for kind in ["butterworth", "cheby2", "fir"]:
        v = results[f"valid_{kind}"]
        ax2.plot(ts[v], results[f"bpm_{kind}"][v], lw=1.2, label=kind)
    ax2.set_xlabel("time (s)")
    ax2.set_ylabel("BPM (Welch)")
    ax2.legend()
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "signals.png"), dpi=150)
    plt.close(fig)
    print(f"wrote {out_path} and signals.png to {out_dir}")

    panels = live_panel_data(results) if live_panels else None
    if panels is not None and not show:
        # Headless: the reference's three in-loop panels (signal +
        # butter-PSD + cheby2-PSD with BPM annotations) as a final frame
        # snapshot — the panel content of the last replay frame.
        W0, freqs, pb, pc, bpm_b, bpm_c = panels
        fig, (axs, axb, axc) = plt.subplots(3, 1, figsize=(9, 10))
        axs.plot(results["green"], color="green", lw=0.8)
        axs.set_title("Heart Rate bpm")
        axs.set_xlabel("frame")
        axs.set_ylabel("signal value")
        axs.text(0.95, 0.95, f"BPM Chebyshev II: {bpm_c[-1]:.2f}",
                 transform=axs.transAxes, ha="right", va="top")
        axs.text(0.95, 0.88, f"BPM Butterworth: {bpm_b[-1]:.2f}",
                 transform=axs.transAxes, ha="right", va="top")
        for ax, p, lbl in ((axb, pb, "Butterworth PSD"),
                           (axc, pc, "Chebyshev-II PSD")):
            ax.plot(freqs, p[-1], lw=1.0)
            ax.set_xlim(0, 5.0)
            ax.set_xlabel("Hz")
            ax.set_title(lbl)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "live_panels.png"), dpi=130)
        plt.close(fig)
        print(f"wrote live_panels.png to {out_dir}")

    if show:  # interactive replay (requires a display)
        pfig = None
        if panels is not None:
            # The reference's in-loop display (rppg_VIDEO.py:305-328):
            # growing signal line + two PSD panels updated per frame.  All
            # panel data is already on the host (one batched device call,
            # live_panel_data) — the loop only draws.
            W0, freqs, pb, pc, bpm_b, bpm_c = panels
            plt.ion()
            pfig, (axs, axb, axc) = plt.subplots(3, 1, figsize=(8, 9))
            sig_line, = axs.plot([], [], color="green")
            axs.set_title("Heart Rate bpm")
            txt_c = axs.text(0.95, 0.95, "", transform=axs.transAxes,
                             ha="right", va="top")
            txt_b = axs.text(0.95, 0.88, "", transform=axs.transAxes,
                             ha="right", va="top")
            lb, = axb.plot(freqs, pb[0], lw=1.0)
            lc, = axc.plot(freqs, pc[0], lw=1.0)
            axb.set_title("Butterworth PSD")
            axc.set_title("Chebyshev-II PSD")
            for ax in (axb, axc):
                ax.set_xlim(0, 5.0)
        g_host = np.asarray(results["green"])
        for i in range(annotated.shape[0]):
            cv2.imshow("vhr_tpu rppg_video", annotated[i])
            if pfig is not None:
                sig_line.set_data(np.arange(i + 1), g_host[:i + 1])
                axs.relim(); axs.autoscale_view()
                if i >= W0 - 1:
                    # window ending at frame i is row i - W + 1 (ADVICE r4)
                    j = min(i - W0 + 1, pb.shape[0] - 1)
                    lb.set_ydata(pb[j]); lc.set_ydata(pc[j])
                    axb.relim(); axb.autoscale_view()
                    axc.relim(); axc.autoscale_view()
                    txt_b.set_text(f"BPM Butterworth: {bpm_b[j]:.2f}")
                    txt_c.set_text(f"BPM Chebyshev II: {bpm_c[j]:.2f}")
                pfig.canvas.draw_idle()
                pfig.canvas.flush_events()
            key = cv2.waitKey(max(1, int(1000 / fps))) & 0xFF
            if key == ord("q"):
                break
            if key == ord(" "):
                cv2.waitKey(0)
        cv2.destroyAllWindows()
        if pfig is not None:
            plt.ioff()
            plt.close(pfig)


def pick_video(videos_dir: str) -> str:
    files = [f for f in sorted(os.listdir(videos_dir))
             if not f.startswith(".")]
    print("Select input video file:")
    for i, f in enumerate(files):
        print(f"[{i + 1}] {f}")
    choice = int(input().strip()) - 1
    if not 0 <= choice < len(files):
        print("Invalid choice, exiting...")
        raise SystemExit(1)
    return os.path.join(videos_dir, files[choice])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Offline video heart-rate")
    p.add_argument("video", nargs="?", help="video path (omit for picker)")
    p.add_argument("--videos-dir", default="videos")
    p.add_argument("--out-dir", default="rppg_out")
    p.add_argument("--show", action="store_true",
                   help="interactive replay window")
    p.add_argument("--live-panels", action="store_true",
                   help="the reference's in-loop panels (signal + "
                        "butter/cheby2 PSD + BPM text) alongside the "
                        "replay; headless runs write live_panels.png")
    p.add_argument("--faces", type=int, default=1,
                   help="analyze up to K subjects (annotated video + "
                        "per-face BPM traces)")
    p.add_argument("--detector", default="skin",
                   choices=["skin", "landmarker", "landmarker-real",
                            "refined", "mediapipe", "mediapipe-bf16",
                            "mediapipe-exact"],
                   help="face localization: weight-free skin chroma "
                        "(fastest), learned landmarker, or landmarker + "
                        "crop self-refinement (most accurate)")
    p.add_argument("--detect-every", type=int, default=1, metavar="N",
                   help="run face detection every N frames, holdover "
                        "tracking in between")
    p.add_argument("--profile-trace", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the "
                        "analysis into DIR (view with TensorBoard)")
    args = p.parse_args(argv)

    import contextlib
    stack = contextlib.ExitStack()
    if args.profile_trace:
        from ..utils.profiling import device_trace
        stack.enter_context(device_trace(args.profile_trace))

    with stack:
        path = args.video or pick_video(args.videos_dir)
        if args.faces > 1:
            results = analyze_multi(
                path, args.faces,
                detector=_resolve_detector_multi(args.detector, args.faces),
                detect_every=args.detect_every)
            ok = results["bpm_valid"]
            for k in range(args.faces):
                idx = np.nonzero(ok[:, k])[0]
                if len(idx):
                    print(f"face{k} BPM: {results['bpm'][idx[-1], k]:.2f}")
            render_multi(results, args.out_dir)
            return 0
        results = analyze(path, detector=_resolve_detector(args.detector),
                          detect_every=args.detect_every)
        last = np.nonzero(results["valid_butterworth"])[0]
        if len(last):
            i = last[-1]
            print(f"BPM Butterworth: {results['bpm_butterworth'][i]:.2f} | "
                  f"Cheby2: {results['bpm_cheby2'][i]:.2f} | "
                  f"FIR: {results['bpm_fir'][i]:.2f}")
        render(results, args.out_dir, show=args.show,
               live_panels=args.live_panels)
        return 0


if __name__ == "__main__":
    from vhr_tpu.backend import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())
