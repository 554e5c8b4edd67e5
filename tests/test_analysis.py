"""End-to-end analysis harness tests: sweep, plugins, metrics, caching."""

import os
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vhr_tpu.analysis import main as amain
from vhr_tpu.analysis import registry
from vhr_tpu.analysis.metrics import mae as mae_metric
from vhr_tpu.io import video as vio
from vhr_tpu.utils.synth import SynthSpec, synthesize


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A videos/ dir with a synthetic clip + matching truth CSV."""
    root = tmp_path_factory.mktemp("analysis_ws")
    clip = synthesize(SynthSpec(duration_s=15.0, bpm=78.0, height=64,
                                width=80, noise_std=0.5))
    video_path = root / "subject.mp4"
    vio.write_video(clip.frames, str(video_path), clip.fps)
    t = np.arange(0, 15.0, 0.5)
    csv = root / "subject.csv"
    csv.write_text("timestamp,heart_rate\n" +
                   "\n".join(f"{x},{78.0}" for x in t))
    os.environ["VHR_RESULTS_DIR"] = str(root / "results")
    os.environ["VHR_CACHE_DIR"] = str(root / "cache")
    return {"root": root, "video": video_path, "csv": csv, "clip": clip}


def test_video_roundtrip(workspace):
    frames, fps = vio.read_video(str(workspace["video"]))
    clip = workspace["clip"]
    assert frames.shape == clip.frames.shape
    assert fps == pytest.approx(clip.fps, abs=0.1)
    # mp4v is lossy; pixel values must still be close.
    assert float(np.mean(np.abs(frames.astype(float)
                                - clip.frames.astype(float)))) < 4.0


def test_truth_csv_and_alignment(workspace):
    truth = vio.read_truth_csv(str(workspace["csv"]))
    assert truth.shape[1] == 2
    measured = np.column_stack([np.array([0.1, 0.74, 20.0]),
                                np.zeros(3)])
    aligned = vio.align_truth_to_measurement(truth, measured)
    assert aligned.shape == (3, 2)
    assert np.all(aligned[:, 1] == 78.0)


def test_registry_lists_all_reference_plugins():
    # Component-inventory parity (SURVEY.md §2 rows for analysis plugins).
    assert set(registry.degradations()) >= {
        "spatial_resolution", "temporal_resolution", "colour_quantisation",
        "colour_noise", "crf", "encoding", "dummy"}
    assert set(registry.measurements()) >= {
        "green_avg", "ica", "green_avg_psd", "dummy"}
    assert set(registry.metrics()) >= {"mae", "signals"}


def test_dummy_sweep_end_to_end(workspace):
    """The reference's no-ML smoke: dummy degradation x dummy measurement."""
    results = amain.run_sweep(str(workspace["video"]), str(workspace["csv"]),
                              ["dummy"], ["dummy"],
                              results_dir=str(workspace["root"] / "results"))
    assert set(results["dummy"]["dummy"]) == {"Dummy 1", "Dummy 2", "Dummy 3"}
    base = workspace["root"] / "results" / "subject"
    assert (base / "measurements" / "dummy" / "dummy" / "Dummy 1.npy").exists()
    assert (base / "plots" / "mae_vs_dummy.png").exists()
    assert (base / "plots" / "signals_dummy.png").exists()
    assert (base / "summary.json").exists()


def test_green_avg_measurement_accuracy(workspace):
    arr = registry.get_measurement("green_avg").measure(
        str(workspace["video"]))
    assert arr.shape[1] == 2 and arr.shape[0] > 100
    # After mp4v round-trip the 78 BPM pulse must survive.
    steady = arr[arr[:, 0] >= 10.0]
    assert np.abs(steady[:, 1] - 78.0).mean() < 5.0


def test_colour_noise_degradation_sweep(workspace):
    mod = registry.get_degradation("colour_noise")
    levels = list(mod.apply(str(workspace["video"])))
    labels = [lbl for _, lbl in levels]
    assert labels == ["0std", "5std", "10std", "20std", "40std"]
    for path, _ in levels:
        assert Path(path).exists()
    # Determinism/idempotency: a second run reuses the cached files.
    mtimes = [Path(p).stat().st_mtime_ns for p, _ in levels]
    levels2 = list(mod.apply(str(workspace["video"])))
    assert [Path(p).stat().st_mtime_ns for p, _ in levels2] == mtimes
    # Higher sigma -> noisier video.
    from vhr_tpu.ops.reduce import video_stats
    import jax.numpy as jnp
    noise = []
    for path, _ in [levels[0], levels[-1]]:
        frames, _ = vio.read_video(path)
        noise.append(float(video_stats(jnp.asarray(frames)).nsr.mean()))
    assert noise[1] > noise[0]


def test_colour_quantisation_sweep(workspace):
    mod = registry.get_degradation("colour_quantisation")
    levels = list(mod.apply(str(workspace["video"])))
    assert [lbl for _, lbl in levels] == \
        ["8-bit", "7-bit", "6-bit", "5-bit", "4-bit"]


def test_spatial_resolution_sweep(workspace):
    mod = registry.get_degradation("spatial_resolution")
    levels = list(mod.apply(str(workspace["video"])))
    # 64p original: no target below it except none (targets start at 240).
    assert levels[0][1] == "64p"
    assert len(levels) == 1


def test_mae_metric_computation():
    truth = np.array([[0.0, 70.0], [10.0, 70.0]])
    results = {"m": {"a": np.array([[1.0, 72.0], [2.0, 68.0]])}}
    maes = mae_metric.compute(truth, results)
    assert maes["m"]["a"] == pytest.approx(2.0)


def test_user_plugin_file(workspace, tmp_path):
    plugin = tmp_path / "const_hr.py"
    plugin.write_text(
        "import numpy as np\n"
        "def measure(path):\n"
        "    return np.column_stack([np.arange(5.0), np.full(5, 65.0)])\n")
    mod = registry.get_measurement(str(plugin))
    arr = mod.measure("ignored")
    assert arr.shape == (5, 2) and arr[0, 1] == 65.0


def test_evm_measurement_plugin(workspace):
    arr = registry.get_measurement("evm").measure(str(workspace["video"]))
    assert arr.ndim == 2 and arr.shape[1] == 2 and arr.shape[0] > 100
    # Detection-free Eulerian pooling still recovers the pulse.
    steady = arr[arr[:, 0] >= 10.0]
    assert np.abs(np.median(steady[:, 1]) - 78.0) <= 6.0


def test_streaming_measure_matches_whole_video(workspace):
    """Chunked decode + carried holdover state == whole-video pass."""
    import jax.numpy as jnp
    from vhr_tpu.pipeline import offline
    frames, fps = vio.read_video(str(workspace["video"]))
    from vhr_tpu.config import PipelineConfig
    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    ts_a, bpm_a, valid_a = offline.measure_green_avg(jnp.asarray(frames),
                                                     fps, cfg)
    ts_b, bpm_b, valid_b = offline.measure_green_avg_file(
        str(workspace["video"]), cfg, chunk_frames=64)
    np.testing.assert_array_equal(valid_a, valid_b)
    np.testing.assert_allclose(bpm_a[valid_a], bpm_b[valid_b],
                               rtol=1e-5, atol=1e-4)


def test_accuracy_metric_computation(tmp_path):
    from vhr_tpu.analysis.metrics import accuracy

    truth = np.array([[0.0, 70.0], [10.0, 70.0]])
    results = {"m": {"a": np.array([[1.0, 73.0], [2.0, 64.0]]),
                     "b": np.empty((0, 2))}}
    stats = accuracy.compute(truth, results)
    s = stats["m"]["a"]
    assert s["rmse"] == pytest.approx(np.sqrt((9 + 36) / 2))
    assert s["pte5"] == pytest.approx(50.0)
    assert s["pte10"] == pytest.approx(100.0)
    assert np.isnan(stats["m"]["b"]["rmse"])

    accuracy.plot(truth, {"m": results["m"]}, "dummy", str(tmp_path))
    assert (tmp_path / "accuracy_vs_dummy.png").exists()
    csv = (tmp_path / "accuracy_vs_dummy.csv").read_text()
    assert csv.splitlines()[0] == "method,degradation,rmse,pte5,pte10,corr"
    assert "m,a," in csv


def test_sweep_detector_context(workspace, tmp_path):
    """`--detector` on the sweep threads the face-localization choice to
    every measurement through analysis.context (the reference's harness
    hard-codes MediaPipe; here it is a harness option with the plugin
    contract unchanged), and the green_avg_psd ROI-mean cache keys on it."""
    from vhr_tpu.analysis import context
    from vhr_tpu.utils import realface

    # A real-portrait clip: the skin-chroma default barely tracks it, the
    # production weights do — the context choice must change the result.
    clip = realface.synthesize_real_face_clip(bpm=72.0, fps=10.0,
                                              duration_s=14.0, scale=0.35)
    video = tmp_path / "real.avi"
    vio.write_video(clip.frames, str(video), clip.fps)

    try:
        context.set_detector("mediapipe")
        context.set_detect_every(2)
        arr = registry.get_measurement("green_avg").measure(str(video))
        assert arr.shape[0] > 0
        steady = arr[arr[:, 0] >= 10.0]
        assert len(steady) and np.abs(steady[:, 1] - 72.0).min() < 10.0

        # Cache key isolation for the psd variant.
        from vhr_tpu.analysis.measurement import green_avg_psd
        g1, v1, _ = green_avg_psd._cached_green(str(video))
        cache_dir = Path(os.environ["VHR_CACHE_DIR"]) / "roi_mean_data"
        named = list(cache_dir.glob("real.mediapipe-e2.npz"))
        assert named, list(cache_dir.glob("*"))
    finally:
        context.set_detector("skin")
        context.set_detect_every(1)

    # CLI surface parses and stores the choice.
    import argparse
    try:
        amain.main(["--video", str(video), "--methods", "dummy",
                    "--degradation", "dummy",
                    "--detector", "mediapipe", "--detect-every", "4",
                    "--results-dir", str(tmp_path / "res")])
        assert context.current_detector_name() == "mediapipe"
        assert context.current_detect_every() == 4
    finally:
        context.set_detector("skin")
        context.set_detect_every(1)
