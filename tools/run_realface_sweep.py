"""The reference's central validation workflow
(`/root/reference/analysis/README.md:22-40`, `analysis/main.py:49-59`) run
end-to-end over the real-face clip — the closest available proxy to a real
recording in this image (docs/DETECTION.md: the bundled portrait is the
only real photograph of a person available).

Synthesizes the portrait-with-known-pulse clip, writes it + a ground-truth
CSV, then drives ``vhr_tpu.analysis.main`` exactly as a user would: the
pixel-domain degradation ladders x {green_avg, chrom, pos, adaptive, ica}
x all three metric plugins, production MediaPipe detector.  Artifacts
(MAE/signals/accuracy plots + a summary.json) land in
``artifacts/realface_sweep/`` for commit.

Run from the repository root on a machine with OpenCV (the clip is
written as an MJPG video); the production detector runs at real speed on
a GPU:
    python tools/run_realface_sweep.py
CPU works too (slow): add ``--cpu --detector skin``.
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "artifacts", "realface_sweep")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--detector", default="mediapipe-bf16")
    ap.add_argument("--detect-every", type=int, default=2)
    ap.add_argument("--bpm", type=float, default=72.0)
    ap.add_argument("--duration", type=float, default=16.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--degradations", nargs="*", default=[
        "colour_noise", "colour_quantisation", "spatial_resolution"])
    ap.add_argument("--methods", nargs="*", default=[
        "green_avg", "chrom", "pos", "adaptive", "ica"])
    args = ap.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import cv2

    from vhr_tpu.utils.realface import synthesize_real_face_clip

    os.makedirs(os.path.join(OUT, "videos"), exist_ok=True)
    clip = synthesize_real_face_clip(
        bpm=args.bpm, fps=args.fps, duration_s=args.duration,
        pulse_amplitude=2.5, motion_px=1.0, noise_std=1.0, seed=0)
    vid = os.path.join(OUT, "videos", "realface.avi")
    wr = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), clip.fps,
                         (clip.frames.shape[2], clip.frames.shape[1]))
    assert wr.isOpened(), "cv2 MJPG writer unavailable"
    for f in clip.frames:
        wr.write(f)
    wr.release()

    truth = os.path.join(OUT, "videos", "realface.csv")
    T = clip.frames.shape[0]
    ts = np.arange(0, T) / clip.fps
    with open(truth, "w") as f:
        f.write("timestamp,heart_rate\n")
        for t in ts:
            f.write(f"{t:.3f},{clip.bpm_truth:.1f}\n")
    print(f"[sweep] clip: {vid} ({T} frames @ {clip.fps} fps, "
          f"truth {clip.bpm_truth} BPM)", flush=True)

    from vhr_tpu.analysis.main import main as analysis_main
    rc = analysis_main([
        "--video", vid,
        "--truth", truth,
        "--results-dir", os.path.join(OUT, "results"),
        "--degradation", *args.degradations,
        "--methods", *args.methods,
        "--detector", args.detector,
        "--detect-every", str(args.detect_every),
    ])
    if rc != 0:
        return rc

    # Condense per-(method, degradation, level) MAE into one mae.json next
    # to the sweep's own summary.json (run_sweep writes rows/timings).
    from vhr_tpu.io.video import align_truth_to_measurement, read_truth_csv
    res_root = os.path.join(OUT, "results", "realface", "measurements")
    mae_map = {}
    tr = read_truth_csv(truth)
    for method in sorted(os.listdir(res_root)):
        mdir = os.path.join(res_root, method)
        for deg in sorted(os.listdir(mdir)):
            for f in sorted(os.listdir(os.path.join(mdir, deg))):
                if not f.endswith(".npy"):
                    continue
                arr = np.load(os.path.join(mdir, deg, f))
                if arr.size == 0:
                    mae = None
                else:
                    hr = align_truth_to_measurement(tr, arr)[:, 1]
                    mae = float(np.mean(np.abs(arr[:, 1] - hr)))
                mae_map[f"{method}/{deg}/{f[:-4]}"] = (
                    round(mae, 3) if mae is not None else None)
    with open(os.path.join(OUT, "mae.json"), "w") as f:
        json.dump({"clip": {"bpm": clip.bpm_truth, "fps": clip.fps,
                            "frames": int(T)},
                   "detector": args.detector,
                   "detect_every": args.detect_every,
                   "mae": mae_map}, f, indent=2)
    print(json.dumps(mae_map, indent=1), flush=True)
    print(f"[sweep] artifacts in {OUT}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
