"""Fidelity validation: the JAX pipeline vs the CPU reference pipeline.

BASELINE.md target: BPM MAE <= 0.5 vs the reference pipeline on identical
inputs.  MediaPipe isn't installable here, so per SURVEY.md §7's mitigation
the comparison decouples detector fidelity from DSP fidelity: both pipelines
consume the *same* per-frame ROI signals (ours batched on the device, the
comparator a faithful per-frame numpy/scipy port of
``analysis/measurement/green_avg.py`` + ``analysis/utils/estimate_bpm.py``),
and are additionally scored against the synthetic clips' ground-truth BPM.

Run ``python -m vhr_tpu.validation`` to (re)generate ``VALIDATION.md``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List

import numpy as np

from .config import BAND_ANALYSIS, HRBand, PipelineConfig
from .utils.synth import SynthSpec, synthesize

__all__ = ["cpu_reference_green_avg", "validate_green_avg", "main"]


def cpu_reference_green_avg(green: np.ndarray, fps: float,
                            window_s: float = 30.0, acq_s: float = 10.0,
                            band: HRBand = BAND_ANALYSIS) -> Dict[int, float]:
    """Frame-at-a-time CPU pipeline on a green trace (the reference's deque
    loop + FFT peak), returning {frame: bpm}."""
    window_len = int(window_s * fps)
    acq_len = int(acq_s * fps)
    dq = deque(maxlen=window_len)
    out: Dict[int, float] = {}
    for i, v in enumerate(green):
        dq.append(float(v))
        if len(dq) < acq_len:
            continue
        sig = np.asarray(dq, dtype=np.float32)
        sig = (sig - np.mean(sig)).astype(np.float64)
        N = len(sig)
        if N < 8:
            continue
        freqs = np.fft.fftfreq(N, d=1.0 / fps)
        mags = np.abs(np.fft.fft(sig))
        pos = freqs > 0
        fp, mp = freqs[pos], mags[pos]
        mask = (fp >= band.low_hz) & (fp <= band.high_hz)
        if not mask.any():
            continue
        out[i] = float(fp[mask][np.argmax(mp[mask])] * 60.0)
    return out


def validate_green_avg(specs: List[SynthSpec],
                       cfg: PipelineConfig = PipelineConfig()) -> List[dict]:
    """Per-clip fidelity record: JAX-vs-CPU MAE and truth MAEs."""
    import jax.numpy as jnp

    from .pipeline import offline

    from .ops import reduce as vreduce
    from .ops import roi as vroi
    from .ops import windows as vwin

    rows = []
    for spec in specs:
        clip = synthesize(spec)
        frames = jnp.asarray(clip.frames)
        trace = offline.extract_signals(frames, cfg)
        green = np.asarray(trace.bgr[:, cfg.channel])

        rolling = vwin.rolling_bpm_fft(
            jnp.asarray(green), clip.fps, cfg.band,
            cfg.window_len(clip.fps), cfg.acquisition_len(clip.fps))
        jax_bpm = np.asarray(rolling.bpm)
        jax_valid = np.asarray(rolling.valid)

        # Detector-in-the-loop error: the same rolling estimator fed by the
        # GROUND-TRUTH face boxes' cheek ROI — any difference is detector-
        # induced BPM error (ROI placement), not DSP error.
        H, W = clip.frames.shape[1:3]
        rois_t = vroi.cheek_roi(jnp.asarray(clip.face_boxes), cfg.roi, W, H)
        green_t, _ = vreduce.roi_channel_means(frames, rois_t)
        rolling_t = vwin.rolling_bpm_fft(
            green_t[:, cfg.channel], clip.fps, cfg.band,
            cfg.window_len(clip.fps), cfg.acquisition_len(clip.fps))
        truthroi_bpm = np.asarray(rolling_t.bpm)

        ref = cpu_reference_green_avg(green, clip.fps, cfg.window_seconds,
                                      cfg.acquisition_seconds, cfg.band)
        idx = sorted(set(ref) & set(np.nonzero(jax_valid)[0].tolist()))
        vs_ref = float(np.mean([abs(jax_bpm[i] - ref[i]) for i in idx]))
        vs_truth_jax = float(np.mean(
            [abs(jax_bpm[i] - clip.bpm_truth[i]) for i in idx]))
        vs_truth_ref = float(np.mean(
            [abs(ref[i] - clip.bpm_truth[i]) for i in idx]))
        vs_truth_roi = float(np.mean(
            [abs(jax_bpm[i] - truthroi_bpm[i]) for i in idx]))
        rows.append({
            "spec": dataclasses.asdict(spec),
            "frames_compared": len(idx),
            "mae_jax_vs_cpu_reference": vs_ref,
            "mae_jax_vs_truth": vs_truth_jax,
            "mae_cpu_reference_vs_truth": vs_truth_ref,
            "mae_detector_vs_truth_roi": vs_truth_roi,
        })
    return rows


DEFAULT_SPECS = [
    SynthSpec(duration_s=45.0, bpm=60.0, noise_std=1.0),
    SynthSpec(duration_s=45.0, bpm=72.0, noise_std=2.0,
              motion_amplitude=3.0),
    SynthSpec(duration_s=45.0, bpm=95.0, noise_std=1.0,
              drift_amplitude=4.0),
    SynthSpec(duration_s=45.0, bpm=130.0, noise_std=0.5),
    SynthSpec(duration_s=45.0, bpm=72.0, noise_std=1.0,
              hr_drift_bpm=10.0),
]


def main() -> int:
    rows = validate_green_avg(DEFAULT_SPECS)
    lines = [
        "# VALIDATION — JAX pipeline vs CPU reference pipeline",
        "",
        "Green-channel (green_avg) pipeline on synthetic clips with known",
        "BPM.  Column semantics (what each number does and does NOT prove):",
        "",
        "- **MAE vs CPU ref** — both pipelines consume IDENTICAL per-frame",
        "  ROI greens; 0.0000 proves *DSP equivalence* (windowing, FFT, band",
        "  mask, peak pick) — it says nothing about detection.",
        "- **det-vs-truth-ROI** — the same estimator fed by the detector's",
        "  ROI vs the ground-truth face box's ROI: *detector-induced* BPM",
        "  error in the loop.",
        "- **vs truth** — absolute accuracy incl. estimator limits; the",
        "  HR-drift clip's ~2.75 BPM is intrinsic 30 s-window lag (the CPU",
        "  reference shows the identical error).",
        "",
        "(BASELINE target: MAE <= 0.5 BPM vs the CPU reference.)",
        "",
        "| clip | frames | MAE vs CPU ref | det-vs-truth-ROI "
        "| JAX vs truth | CPU ref vs truth |",
        "|---|---|---|---|---|---|",
    ]
    worst = 0.0
    for r in rows:
        s = r["spec"]
        label = (f"{s['bpm']:g}bpm n{s['noise_std']:g} "
                 f"m{s['motion_amplitude']:g} d{s['hr_drift_bpm']:g}")
        lines.append(
            f"| {label} | {r['frames_compared']} | "
            f"{r['mae_jax_vs_cpu_reference']:.4f} | "
            f"{r['mae_detector_vs_truth_roi']:.4f} | "
            f"{r['mae_jax_vs_truth']:.2f} | "
            f"{r['mae_cpu_reference_vs_truth']:.2f} |")
        worst = max(worst, r["mae_jax_vs_cpu_reference"])
    lines += ["", f"Worst-case MAE vs CPU reference: **{worst:.4f} BPM** "
              f"(target <= 0.5)."]
    # Standing sections (pinned by their named tests, so regeneration
    # keeps them current rather than clobbering them).
    lines += [
        "",
        "## Real-imagery validation (round 3)",
        "",
        "The synthetic-only caveat on the numbers above is now bounded"
        " from the",
        "real side (`vhr_tpu/utils/realface.py`, `tests/test_realface.py`):"
        " the",
        "bundled real photograph, animated with a known injected pulse"
        " and rigid",
        "micro-motion, runs the full production path (`--detector"
        " mediapipe`,",
        "ported production weights) end-to-end — face tracked at IoU"
        " >= 0.97",
        "against the motion-tracked truth box, injected BPM recovered"
        " to the",
        "nearest FFT bin.  Detector fidelity on real imagery is tabulated"
        " in",
        "`docs/DETECTION.md` (\"Real-face validation\").",
        "",
        "## Adaptive method selection (round 3)",
        "",
        "`measure_adaptive` picks green/CHROM/POS/OMIT per rolling window"
        " by",
        "in-band SNR at the cross-method consensus frequency.  Pinned"
        " behavior",
        "(`tests/test_adaptive.py`): under 20x in-band common-mode flicker"
        " the",
        "raw green mean locks to the flicker; the selector de-selects"
        " green on",
        ">90% of steady frames and the output tracks the true pulse"
        " within the",
        "FFT-bin tolerance; on clean traces every steady frame stays"
        " within",
        "3 BPM of truth.",
    ]
    with open("VALIDATION.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0 if worst <= 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
