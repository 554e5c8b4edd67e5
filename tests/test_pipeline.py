"""End-to-end pipeline tests on synthetic face videos with known physiology."""

import numpy as np
import pytest
import jax.numpy as jnp

from vhr_tpu.config import PipelineConfig, ROIConfig, FilterConfig, BAND_ANALYSIS
from vhr_tpu.models.skin_detector import detect_faces
from vhr_tpu.ops import windows as vwin
from vhr_tpu.pipeline import offline
from vhr_tpu.utils.synth import SynthSpec, SynthVideo, synthesize


@pytest.fixture(scope="module")
def clip() -> SynthVideo:
    return synthesize(SynthSpec(duration_s=40.0, bpm=72.0, noise_std=1.0,
                                motion_amplitude=2.0))


def test_skin_detector_finds_face(clip):
    boxes, valid = detect_faces(jnp.asarray(clip.frames))
    assert bool(np.all(np.asarray(valid)))
    got = np.asarray(boxes)
    truth = clip.face_boxes
    # Detector box within a few pixels of the true ellipse bbox.
    assert np.max(np.abs(got - truth)) <= 6


def test_skin_detector_dropout_invalid():
    v = synthesize(SynthSpec(duration_s=3.0, dropout_frames=(10, 11, 12)))
    _, valid = detect_faces(jnp.asarray(v.frames))
    valid = np.asarray(valid)
    assert not valid[10] and not valid[11] and not valid[12]
    assert valid[9] and valid[13]


def _ref_rolling_bpm(signal, fps, band, window_len, acq_len):
    """Per-frame port of the reference deque loop (green_avg.py:24-50)."""
    from collections import deque
    green = deque(maxlen=window_len)
    out = {}
    for i, v in enumerate(signal):
        green.append(v)
        if len(green) < acq_len:
            continue
        sig = np.asarray(green, dtype=np.float32)
        sig = sig - np.mean(sig)
        X = sig[:, None].astype(np.float64)
        N = X.shape[0]
        if N < 8:
            continue
        fft_vals = np.fft.fft(X, axis=0)
        freqs = np.fft.fftfreq(N, d=1 / fps)
        pos = freqs > 0
        mags = np.abs(fft_vals[pos, 0])
        freqs_pos = freqs[pos]
        mask = (freqs_pos >= band.low_hz) & (freqs_pos <= band.high_hz)
        if not np.any(mask):
            continue
        k = int(np.argmax(mags[mask]))
        out[i] = float(freqs_pos[mask][k] * 60.0)
    return out


def test_rolling_bpm_matches_reference_loop():
    """rolling_bpm_fft reproduces the deque loop frame-for-frame, including
    the growing-window ramp with its per-length frequency grids."""
    fps = 20.0
    rng = np.random.default_rng(2)
    t = np.arange(400) / fps
    sig = (np.sin(2 * np.pi * 1.3 * t) + 0.2 * rng.standard_normal(400)
           + 0.5 * np.sin(2 * np.pi * 0.2 * t))
    window_len, acq_len = int(15 * fps), int(5 * fps)
    ref = _ref_rolling_bpm(sig, fps, BAND_ANALYSIS, window_len, acq_len)
    got = vwin.rolling_bpm_fft(jnp.asarray(sig, jnp.float64), fps,
                               BAND_ANALYSIS, window_len, acq_len)
    bpm, valid = np.asarray(got.bpm), np.asarray(got.valid)
    assert set(np.nonzero(valid)[0]) == set(ref.keys())
    for i, v in ref.items():
        assert bpm[i] == pytest.approx(v, abs=1e-6), f"frame {i}"


def test_measure_green_avg_recovers_bpm(clip):
    cfg = PipelineConfig()
    ts, bpm, valid = offline.measure_green_avg(
        jnp.asarray(clip.frames), clip.fps, cfg)
    # Steady-state frames (full 30 s window):
    steady = slice(cfg.window_len(clip.fps), None)
    assert valid[steady].all()
    err = np.abs(bpm[steady] - 72.0)
    # FFT bin resolution at W=900, fps=30 is 2 BPM.
    assert float(err.mean()) <= 2.0
    assert float(err.max()) <= 2.1


def test_measure_green_avg_contract(clip):
    ts, bpm, valid = offline.measure_green_avg(
        jnp.asarray(clip.frames), clip.fps)
    arr = offline.to_measurement_array(ts, bpm, valid)
    assert arr.ndim == 2 and arr.shape[1] == 2
    # First estimate at the acquisition boundary (green_avg.py:38-39).
    assert arr[0, 0] == pytest.approx((int(10.0 * clip.fps) - 1) / clip.fps)


def test_measure_app_welch_recovers_bpm(clip):
    cfg = PipelineConfig(window_seconds=10.0, band=BAND_ANALYSIS,
                         filter=FilterConfig(kind="butterworth", order=2))
    ts, bpm, valid = offline.measure_app_welch(
        jnp.asarray(clip.frames), clip.fps, cfg)
    w = cfg.window_len(clip.fps)
    assert valid[w:].all()
    assert not valid[:w].any()
    err = np.abs(bpm[w:] - 72.0)
    # Welch bin resolution at 9 s segments is ~6.7 BPM.
    assert float(err.mean()) <= 7.0


def test_measure_ica_recovers_bpm():
    v = synthesize(SynthSpec(duration_s=15.0, bpm=90.0, noise_std=0.5))
    ts, bpm, valid = offline.measure_ica(jnp.asarray(v.frames), v.fps)
    w = int(10.0 * v.fps)
    sel = valid & (np.arange(len(ts)) >= w)
    assert sel.sum() > 50
    err = np.abs(bpm[sel] - 90.0)
    assert float(np.median(err)) <= 6.0


def test_pipeline_survives_dropout():
    v = synthesize(SynthSpec(duration_s=15.0, bpm=80.0,
                             dropout_frames=tuple(range(200, 210))))
    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    ts, bpm, valid = offline.measure_green_avg(jnp.asarray(v.frames),
                                               v.fps, cfg)
    # 10-frame dropout is inside the 15-frame holdover: no validity gap.
    assert valid[200:210].all()


def test_skin_detector_downsampled_matches_full(clip):
    from vhr_tpu.models.skin_detector import SkinDetectorConfig
    boxes1, valid1 = detect_faces(jnp.asarray(clip.frames))
    boxes4, valid4 = detect_faces(jnp.asarray(clip.frames),
                                  SkinDetectorConfig(downsample=4, smooth=1))
    assert bool(np.asarray(valid4).all())
    # Pooled boxes within one pooling cell (+smoothing slack) of full-res.
    assert np.max(np.abs(np.asarray(boxes4) - np.asarray(boxes1))) <= 16


def test_degraded_144p_5fps_config():
    """BASELINE config 1: the reference's dev-speed preset (144p @ 5 fps)."""
    v = synthesize(SynthSpec(duration_s=40.0, bpm=66.0, fps=5.0,
                             height=144, width=176, noise_std=1.0))
    cfg = PipelineConfig()
    ts, bpm, valid = offline.measure_green_avg(jnp.asarray(v.frames),
                                               v.fps, cfg)
    steady = slice(cfg.window_len(v.fps), None)
    assert valid[steady].all()
    # 30 s window at 5 fps -> 2 BPM bins.
    assert float(np.abs(bpm[steady] - 66.0).mean()) <= 2.5


def test_rolling_bpm_welch_estimator(clip):
    """PipelineConfig.estimator='welch' drives the Welch rolling estimator."""
    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0,
                         estimator="welch")
    ts, bpm, valid = offline.measure_green_avg(jnp.asarray(clip.frames),
                                               clip.fps, cfg)
    W = cfg.window_len(clip.fps)
    assert not valid[:W - 1].any()          # Welch needs the full window
    assert valid[W:].all()
    assert float(np.abs(bpm[W:] - 72.0).mean()) <= 4.0


def test_learned_detector_params_are_traced(clip):
    """make_detector returns a jax.tree_util.Partial whose weights enter the
    jitted pipeline as traced args, not baked literal constants (ADVICE r1)."""
    import jax
    from vhr_tpu.models import landmarker as lmk
    from vhr_tpu.models.train import TrainConfig, init_state

    cfg = TrainConfig()
    _, params, _, _ = init_state(cfg, jax.random.PRNGKey(0))
    det = lmk.make_detector(params, cfg.model)
    assert isinstance(det, jax.tree_util.Partial)
    trace = offline.extract_signals(jnp.asarray(clip.frames[:8]),
                                    detector=det)
    assert trace.bgr.shape == (8, 3)


def test_extract_signals_landmark_roi_wiring(clip):
    """extract_signals_landmark_roi: the detector-supplied ROI rect rides
    the holdover scan and feeds the masked reduction."""
    import jax

    from vhr_tpu.ops import reduce as vreduce
    from vhr_tpu.ops import roi as vroi

    frames = jnp.asarray(clip.frames[:60])
    T, H, W, _ = frames.shape
    boxes = jnp.asarray(clip.face_boxes[:60])
    # Synthetic "landmark" ROIs: the true cheek rect, with a 10-frame dropout.
    rois = vroi.cheek_roi(boxes, PipelineConfig().roi, W, H)
    valid = np.ones(T, bool)
    valid[20:30] = False
    valid_j = jnp.asarray(valid)

    def fake_det(b, r, v, fr):
        return b, r, v

    det = jax.tree_util.Partial(fake_det, boxes, rois, valid_j)
    trace = offline.extract_signals_landmark_roi(frames, det)
    assert bool(np.asarray(trace.valid).all())       # holdover spans dropout
    # During the dropout the ROI must be frame 19's (held), not frame t's.
    np.testing.assert_array_equal(np.asarray(trace.rois)[20:30],
                                  np.tile(np.asarray(rois)[19], (10, 1)))
    m_ref, _ = vreduce.roi_channel_means(frames, trace.rois)
    np.testing.assert_allclose(np.asarray(trace.bgr), np.asarray(m_ref),
                               rtol=1e-6)


def test_roi_site_forehead_pipeline():
    """roi_site="forehead" measures the second ROI the reference only ever
    draws (rppg_VIDEO.py:102): the ROI sits in the face's upper band and
    the BPM still recovers (the synthetic pulse spans the face)."""
    from vhr_tpu.utils.synth import SynthSpec, synthesize

    clip = synthesize(SynthSpec(duration_s=12.0, bpm=81.0, height=64,
                                width=80, noise_std=0.5))
    fj = jnp.asarray(clip.frames)
    cheek = offline.extract_signals(
        fj, PipelineConfig(roi_site="cheek"))
    fore = offline.extract_signals(
        fj, PipelineConfig(roi_site="forehead"))
    assert bool(np.asarray(fore.valid).all())
    # Forehead band lies strictly above the cheek band within the same box.
    assert (np.asarray(fore.rois)[:, 3] <= np.asarray(cheek.rois)[:, 1] + 1).all()
    cfg = PipelineConfig(window_seconds=8.0, acquisition_seconds=4.0,
                         roi_site="forehead")
    ts, bpm, ok = offline.measure_green_avg(fj, clip.fps, cfg)
    W = cfg.window_len(clip.fps)
    assert ok[W:].all()
    assert abs(float(np.median(bpm[W:])) - 81.0) <= 3.5



@pytest.mark.parametrize("hw,duration_s,noise_std", [
    ((48, 64), 2.0, 0.0),
    ((37, 53), 1.1, 0.0),        # T = 33: blocks of 11 frames, odd sizes
    ((48, 64), 2.0, 1.5),
])
def test_synthesize_on_device_matches_host(hw, duration_s, noise_std):
    """The on-device generator shares the host generator's face, box and
    pulse: with no sensor noise its frames are identical; with noise only
    the noise differs."""
    from vhr_tpu.utils.synth import synthesize_on_device

    spec = SynthSpec(height=hw[0], width=hw[1], duration_s=duration_s,
                     bpm=84.0, noise_std=noise_std, seed=5)
    host = synthesize(spec)
    frames, box, bpm_t = synthesize_on_device(spec)
    frames = np.asarray(frames)
    assert frames.shape == host.frames.shape and frames.dtype == np.uint8
    np.testing.assert_array_equal(box, host.face_boxes[0])
    np.testing.assert_array_equal(bpm_t, host.bpm_truth)
    diff = np.abs(frames.astype(np.int16) - host.frames.astype(np.int16))
    if noise_std == 0.0:
        assert diff.max() == 0
    else:
        assert diff.mean() < 2.0 * noise_std


def test_synthesize_on_device_rejects_moving_faces():
    from vhr_tpu.utils.synth import synthesize_on_device

    with pytest.raises(ValueError):
        synthesize_on_device(SynthSpec(duration_s=1.0, motion_amplitude=2.0))
