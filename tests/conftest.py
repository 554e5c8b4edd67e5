"""Test harness config: run everything on a virtual 8-device CPU mesh.

Backend selection in JAX is lazy, so ``jax.config`` redirects the tests to
the CPU even where JAX was imported before this file ran.
``xla_force_host_platform_device_count`` fakes an 8-device mesh for
``shard_map``/``pjit`` tests (the standard JAX recipe for testing
multi-device code without hardware).  Tests marked ``gpu`` need the real
card and ask for the ``gpu_backend`` fixture, which skips them here.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
# The card's own tests (marked ``gpu``) run with JAX_PLATFORMS=cuda,cpu;
# everything else is forced onto the CPU.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if "cuda" not in _platforms:
    _platforms = "cpu"
os.environ["JAX_PLATFORMS"] = _platforms

import jax  # noqa: E402

jax.config.update("jax_platforms", _platforms)

# Golden tests compare against float64 scipy/sklearn; enable x64 so tests can
# opt into float64 (production code follows input dtype, float32/bf16).
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Fast/slow split: the default gate is `pytest tests/ -m "not slow"`;
# `pytest tests/` runs everything (~2x).  Slow = measured >=14 s on a 1-core
# host (app E2E, training loops, big-clip sweeps).  The list
# lives centrally so test files stay clean.
import pytest

_SLOW_TESTS = {
    "test_measure_green_avg_recovers_bpm",
    "test_landmarker_learns_synthetic_faces",
    "test_skin_detector_finds_face",
    "test_colour_noise_degradation_sweep",
    "test_multistream_sharded_matches_single",
    "test_sosfiltfilt_parallel_path",
    "test_measure_green_avg_contract",
    "test_params_roundtrip",
    "test_rolling_bpm_welch_estimator",
    "test_train_step_sharded",
    "test_halo_sosfiltfilt_matches_global",
    "test_measure_app_welch_recovers_bpm",
    "test_trained_checkpoint_localizes_faces",
    "test_detector_adapter_interface",
    "test_two_bpms_recovered_independently",
    "test_cascade_multi_detector_in_pipeline",
    "test_tiled_multi_bpm_on_skin_background",
    "test_rppg_video_app_multiface",
    # >15 s each on the 1-core host with sibling fast coverage (profiled
    # 2026-08-17); the full suite still runs them.
    "test_adversarial_skin_detector_fails_landmarker_passes",
    "test_refined_detector_improves_iou",
    "test_skin_detector_downsampled_matches_full",
    "test_measure_ica_recovers_bpm",
    "test_tiled_detector_survives_skin_background",
    "test_pooled_gated_detect_recovers_bpm",
    "test_roi_detector_pose_robust_pipeline",
    "test_projection_plugins_registered",
    "test_rppg_video_app_learned_detector",
    # real-face corpus: each drives the 21 s-compile mediapipe graph on CPU
    "test_production_detector_on_real_photo",
    "test_production_detector_tracks_moving_real_face",
    "test_real_face_bpm_recovery_production_path",
    "test_real_face_detector_domain_contrast",
    # mesh-polygon ROI: same 21 s mediapipe CPU compiles
    "test_cheek_poly_idx_derivation_pinned",
    "test_polygon_excludes_band_corner_contamination",
    "test_polygon_pipeline_recovers_bpm_real_face",
    "test_polygon_pipeline_cadence_and_holdover",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu_backend():
    """Skip unless an NVIDIA GPU backend is present.  Decided here, at run
    time, never at import or collection: every xdist worker must collect
    the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: checks its float32 contractions")
    return devices[0]
