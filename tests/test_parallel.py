"""Multi-chip tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vhr_tpu.config import PipelineConfig
from vhr_tpu.dsp import design, filters
from vhr_tpu.parallel import mesh as vmesh
from vhr_tpu.parallel import streams, time_shard
from vhr_tpu.utils.synth import SynthSpec, synthesize


@pytest.fixture(scope="module")
def devices():
    ds = jax.devices()
    assert len(ds) >= 8, "conftest must fake 8 CPU devices"
    return ds[:8]


def test_multistream_sharded_matches_single(devices):
    m = vmesh.stream_mesh(devices)
    clips = [synthesize(SynthSpec(duration_s=12.0, bpm=60.0 + 5 * i,
                                  height=48, width=64, seed=i))
             for i in range(8)]
    frames = jnp.asarray(np.stack([c.frames for c in clips]))
    fps = clips[0].fps
    cfg = PipelineConfig(window_seconds=8.0, acquisition_seconds=4.0)
    frames = vmesh.shard(frames, m, "stream")
    res = streams.multistream_green_bpm(frames, fps, m, cfg)
    bpm = np.asarray(res.bpm)
    valid = np.asarray(res.valid)
    W = cfg.window_len(fps)
    for i in range(8):
        assert valid[i, W:].all()
        err = np.abs(bpm[i, W:] - (60.0 + 5 * i))
        assert err.mean() <= 8.0, f"stream {i}: {err.mean()}"


def test_halo_sosfiltfilt_matches_global(devices):
    m = vmesh.make_mesh(("time",), devices=devices)
    sos = design.butter_bandpass_sos(2, 0.7 / 15.0, 2.0 / 15.0)
    rng = np.random.default_rng(0)
    T = 8 * 512
    t = np.arange(T) / 30.0
    x = np.sin(2 * np.pi * 1.2 * t) + 0.1 * rng.standard_normal(T)
    x = jnp.asarray(x, jnp.float64)

    y_global = filters.sosfiltfilt(sos, x)
    xs = vmesh.shard(x, m, "time")
    y_sharded = time_shard.halo_sosfiltfilt(sos, xs, m)
    np.testing.assert_allclose(np.asarray(y_sharded), np.asarray(y_global),
                               rtol=1e-6, atol=1e-9)


def test_default_halo_reasonable():
    sos = design.butter_bandpass_sos(2, 0.7 / 15.0, 2.0 / 15.0)
    h = time_shard.default_halo(sos)
    assert 10 < h < 5000


def test_train_step_sharded(devices):
    """dp x tp sharded landmark training step runs and reduces the loss."""
    from vhr_tpu.models import train as vtrain
    m = vmesh.train_mesh(4, 2, devices=devices)
    cfg = vtrain.TrainConfig(batch_size=16)
    model, params, tx, opt_state = vtrain.init_state(
        cfg, jax.random.PRNGKey(0))
    step = vtrain.make_train_step(model, tx, cfg, mesh=m,
                                  params_example=params)
    rng = np.random.default_rng(0)
    p_shard = vtrain.param_shardings(params, m)
    params = jax.tree.map(jax.device_put, params, p_shard)
    losses = []
    for _ in range(3):
        batch = {k: jnp.asarray(v) for k, v in
                 vtrain.synth_batch(cfg, rng).items()}
        params, opt_state, loss, aux = step(params, opt_state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    # Check tensor-parallel layout actually applied to a big kernel.
    trunk = params["trunk"]["kernel"]
    assert "model" in str(trunk.sharding.spec)


def test_landmarker_learns_synthetic_faces():
    """A short single-device training run reduces loss markedly (gradients
    flow through the flatten head + bbox term).  Uses an EASY generator
    config — the HARD task needs thousands of steps and is validated by the
    committed checkpoint's held-out IoU tests (test_landmarker.py)."""
    from vhr_tpu.models import facegen, train as vtrain
    easy = facegen.FaceGenConfig(skin_background_prob=0.0,
                                 light_gain=(1.0, 1.0), occlusion_prob=0.0,
                                 texture_amp=0.0, max_distractors=0,
                                 angle_deg=0.0)
    cfg = vtrain.TrainConfig(batch_size=32, total_steps=40, gen=easy)
    model, params, losses = vtrain.train(cfg, steps=40, seed=1)
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_sharded_steady_bpm_matches_unsharded(devices):
    """Time-sharded rolling BPM == unsharded steady region, bit for bit."""
    from vhr_tpu.config import BAND_ANALYSIS
    from vhr_tpu.ops import windows as vwin
    from vhr_tpu.parallel import long as vlong

    m = vmesh.make_mesh(("time",), devices=devices)
    fps, W = 20.0, 128
    rng = np.random.default_rng(5)
    t = np.arange(8 * 256) / fps
    sig = np.sin(2 * np.pi * 1.1 * t) + 0.3 * rng.standard_normal(len(t))
    x = jnp.asarray(sig, jnp.float64)

    ref = vwin.rolling_bpm_fft(x, fps, BAND_ANALYSIS, W, W)  # steady only
    xs = vmesh.shard(x, m, "time")
    bpm, valid = vlong.sharded_steady_bpm(xs, fps, BAND_ANALYSIS, W, m)
    bpm, valid = np.asarray(bpm), np.asarray(valid)
    ref_bpm, ref_valid = np.asarray(ref.bpm), np.asarray(ref.valid)
    assert not valid[:W - 1].any()
    np.testing.assert_array_equal(valid[W - 1:], ref_valid[W - 1:])
    np.testing.assert_allclose(bpm[valid], ref_bpm[valid], atol=1e-9)


@pytest.mark.slow
def test_multistream_mediapipe_detector_sharded(devices):
    """The production MediaPipe detector runs data-parallel over the stream
    mesh (weights as replicated shard_map inputs) and agrees exactly with
    the direct single-stream call — the 'production face model at farm
    scale' path."""
    from tests.test_mediapipe_face import draw_face
    from vhr_tpu.models.mediapipe_face import make_mediapipe_detector

    m = vmesh.stream_mesh(devices)
    img = draw_face(H=192, W=224, cx=112, cy=96, rx=45, ry=62)
    rng = np.random.default_rng(5)
    # Streams differ by per-stream photometric jitter so each shard does
    # real, distinct work.
    frames = np.stack([
        np.clip(img.astype(np.int16) + rng.integers(-6, 7), 0, 255)
        .astype(np.uint8)[None].repeat(2, axis=0) for _ in range(8)])
    frames_j = jnp.asarray(frames)

    det = make_mediapipe_detector()
    cfg = PipelineConfig(window_seconds=8.0, acquisition_seconds=4.0)
    sharded = vmesh.shard(frames_j, m, "stream")
    res = streams.multistream_green_bpm(sharded, 30.0, m, cfg,
                                        detector=det)
    # T=2 is below acquisition so BPM validity stays False; detection
    # success shows in the green trace (zero iff the detector missed).
    assert not np.asarray(res.valid).any()
    green = np.asarray(res.green)
    assert (green > 0).all()
    # Shard 0 must reproduce the unsharded detector bit-exactly.
    boxes0, v0 = det(frames_j[0])
    assert np.asarray(v0).all()
    x1, y1, x2, y2 = np.asarray(boxes0)[0]
    assert 60 <= x1 <= 100 and 120 <= x2 <= 165
    assert 30 <= y1 <= 70 and 140 <= y2 <= 180


@pytest.mark.slow
def test_multistream_mediapipe_farm_validity(devices):
    """BPM *validity* above acquisition through the production detector at
    farm shape — the r4 on-chip blind spot (the farm produced 0/1536
    valid BPMs while the tests only pinned shapes and green>0;
    VERDICT r4 #1/#3).  Real portrait, streams sharded over the mesh,
    window fully inside the chunk: every post-acquisition frame of every
    stream must be valid with an in-band BPM."""
    from vhr_tpu.models.mediapipe_face import make_mediapipe_detector
    from vhr_tpu.utils.realface import real_face_image

    cv2 = pytest.importorskip("cv2")
    img = real_face_image()
    if img is None:
        pytest.skip("no bundled portrait")

    m = vmesh.stream_mesh(devices)
    small = cv2.resize(img, (176, 144), interpolation=cv2.INTER_AREA)
    T, fps = 12, 10.0
    rng = np.random.default_rng(11)
    frames = np.stack([
        np.clip(small.astype(np.int16)
                + rng.integers(-4, 5, (T, 1, 1, 1)), 0, 255)
        .astype(np.uint8) for _ in range(8)])
    cfg = PipelineConfig(window_seconds=1.0, acquisition_seconds=1.0)
    det = make_mediapipe_detector()
    res = streams.multistream_green_bpm(
        vmesh.shard(jnp.asarray(frames), m, "stream"), fps, m, cfg,
        detector=det)
    valid = np.asarray(res.valid)
    bpm = np.asarray(res.bpm)
    acq = cfg.acquisition_len(fps)
    assert valid[:, acq - 1:].all(), (
        f"farm validity hole: {valid.sum()}/{valid[:, acq - 1:].size}")
    assert (bpm[valid] >= cfg.band.low_hz * 60.0 - 1e-6).all()
    assert (bpm[valid] <= cfg.band.high_hz * 60.0 + 1e-6).all()


def test_multistream_degradation_sweep_on_device(devices):
    """BASELINE config 5's full wording — concurrent streams x degradation
    sweep: each stream carries a different Gaussian-noise degradation level
    (the colour_noise ladder), applied ON DEVICE, and the sharded pipeline
    recovers every stream's BPM in one program; accuracy decays
    monotonically-ish with sigma but stays in-band across the ladder."""
    m = vmesh.stream_mesh(devices)
    base = synthesize(SynthSpec(duration_s=12.0, bpm=75.0, height=48,
                                width=64, seed=3, noise_std=0.0))
    frames = jnp.asarray(np.stack([base.frames] * 8))
    sigmas = jnp.asarray([0.0, 1.0, 2.0, 4.0, 6.0, 8.0, 12.0, 16.0])

    def noisy(fr, sd, key):
        n = sd * jax.random.normal(key, fr.shape, jnp.float32)
        return jnp.clip(fr.astype(jnp.float32) + n, 0, 255).astype(jnp.uint8)

    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    frames = jax.jit(jax.vmap(noisy))(frames, sigmas, keys)

    fps = base.fps
    cfg = PipelineConfig(window_seconds=8.0, acquisition_seconds=4.0)
    frames = vmesh.shard(frames, m, "stream")
    res = streams.multistream_green_bpm(frames, fps, m, cfg)
    bpm, valid = np.asarray(res.bpm), np.asarray(res.valid)
    W = cfg.window_len(fps)
    for i in range(8):
        assert valid[i, W:].all(), f"stream {i} lost validity"
        err = np.abs(bpm[i, W:] - 75.0)
        assert err.mean() <= 8.0, f"sigma={float(sigmas[i])}: {err.mean()}"


def test_sharded_holdover_matches_sequential(devices):
    """Time-sharded detection holdover (two local scans + one carry
    all_gather, parallel/long.py) is EXACTLY the sequential
    ops.roi.holdover scan — across shard-boundary dropouts, cadence
    'attempted' gaps, and a no-detection-in-shard chain."""
    from vhr_tpu.ops import roi as vroi
    from vhr_tpu.parallel.long import sharded_holdover

    m = vmesh.make_mesh(("time",), devices=devices)
    rng = np.random.default_rng(0)
    T = 8 * 25
    cases = []
    for drop in (0.2, 0.5):
        cases.append((rng.random(T) > drop, np.ones(T, bool)))
        cases.append((rng.random(T) > drop, rng.random(T) > 0.3))
    v_single = np.zeros(T, bool)
    v_single[137] = True                      # carry chains across 4 shards
    cases.append((v_single, np.ones(T, bool)))
    for valid, att in cases:
        valid = np.asarray(valid) & np.asarray(att)   # failed == attempted
        box = rng.integers(0, 100, (T, 4)).astype(np.int32)
        ref = vroi.holdover(jnp.asarray(box), jnp.asarray(valid), 15,
                            attempted=jnp.asarray(att))
        sh = NamedSharding(m, P("time"))
        got = sharded_holdover(
            jax.device_put(jnp.asarray(box), sh),
            jax.device_put(jnp.asarray(valid), sh), m, 15,
            attempted=jax.device_put(jnp.asarray(att), sh))
        np.testing.assert_array_equal(np.asarray(got.box),
                                      np.asarray(ref.box))
        np.testing.assert_array_equal(np.asarray(got.valid),
                                      np.asarray(ref.valid))


def test_sharded_forward_fill_matches_sequential(devices):
    from vhr_tpu.dsp.filters import forward_fill
    from vhr_tpu.parallel import long as vlong

    m = vmesh.make_mesh(("time",), devices=devices)
    rng = np.random.default_rng(2)
    T = 8 * 32
    x = jnp.asarray(rng.normal(100.0, 5.0, (T,)).astype(np.float32))
    # Dropout runs that cross shard boundaries, plus an all-invalid shard
    # (shard 3) and leading invalids on shard 0.
    ok = rng.random(T) > 0.3
    ok[:5] = False
    ok[3 * 32:4 * 32] = False
    ok_j = jnp.asarray(ok)

    ref = np.asarray(forward_fill(x, ok_j, init="zeros"))
    got = np.asarray(vlong.sharded_forward_fill(
        vmesh.shard(x, m, "time"), vmesh.shard(ok_j, m, "time"), m))
    np.testing.assert_array_equal(got, ref)


def test_sharded_rolling_bpm_fft_matches_unsharded(devices):
    """Ramp (growing-window acquisition) + steady regions both pinned equal
    to the sequential rolling_bpm_fft — the deque-semantics estimator over
    a time-sharded trace (VERDICT r4 #6)."""
    from vhr_tpu.config import BAND_ANALYSIS
    from vhr_tpu.ops import windows as vwin
    from vhr_tpu.parallel import long as vlong

    m = vmesh.make_mesh(("time",), devices=devices)
    fps, W, A = 16.0, 32, 12
    rng = np.random.default_rng(9)
    T = 8 * 40
    t = np.arange(T) / fps
    sig = np.sin(2 * np.pi * 1.3 * t) + 0.2 * rng.standard_normal(T)
    x = jnp.asarray(sig, jnp.float32)

    ref = vwin.rolling_bpm_fft(x, fps, BAND_ANALYSIS, W, A)
    bpm, valid = vlong.sharded_rolling_bpm_fft(
        vmesh.shard(x, m, "time"), fps, BAND_ANALYSIS, W, A, m)
    bpm, valid = np.asarray(bpm), np.asarray(valid)
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_allclose(bpm[valid], np.asarray(ref.bpm)[valid],
                               rtol=1e-5, atol=1e-4)


def test_measure_green_avg_timesharded_matches_single(devices):
    """The full long-recording e2e over a time mesh (detection + cross-shard
    holdover + forward-fill + windowed BPM as ONE measure()-shaped entry)
    pinned equal to the single-device pipeline (VERDICT r4 #6)."""
    from vhr_tpu.parallel.long import measure_green_avg_sharded
    from vhr_tpu.pipeline import offline

    m = vmesh.make_mesh(("time",), devices=devices)
    clip = synthesize(SynthSpec(duration_s=16.0, bpm=66.0, height=48,
                                width=64, seed=3))
    frames = np.asarray(clip.frames)[:8 * (len(clip.frames) // 8)].copy()
    frames[::11] = 0                     # dropout frames cross shards
    fps = clip.fps
    frames_j = jnp.asarray(frames)
    cfg = PipelineConfig(window_seconds=2.0, acquisition_seconds=1.0)

    _, bpm_ref, ok_ref = offline.measure_green_avg(frames_j, fps, cfg)
    bpm_sh, ok_sh, green_sh = measure_green_avg_sharded(
        vmesh.shard(frames_j, m, "time"), fps, m, cfg)
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(np.asarray(ok_sh), ok_ref)
    np.testing.assert_allclose(np.asarray(bpm_sh)[ok_ref],
                               np.asarray(bpm_ref)[ok_ref],
                               rtol=1e-5, atol=1e-4)
    assert ok_ref.sum() > 0              # the pin is not vacuous


def test_measure_green_avg_timesharded_bandpass(devices):
    """The bandpass=True composition (halo zero-phase filter between fill
    and windowing) recovers the synthetic pulse over the time mesh and
    matches the equivalent single-device composition."""
    from vhr_tpu.dsp import filters as vfilt
    from vhr_tpu.ops import windows as vwin
    from vhr_tpu.parallel.long import measure_green_avg_sharded
    from vhr_tpu.pipeline import offline

    m = vmesh.make_mesh(("time",), devices=devices)
    # 90 BPM = 1.5 Hz sits ON a bin of the 2 s window's 0.5 Hz grid (the
    # short window quantizes estimates to 30 BPM steps; an off-bin pulse
    # would make the accuracy check meaningless).
    clip = synthesize(SynthSpec(duration_s=16.0, bpm=90.0, height=48,
                                width=64, seed=4))
    frames = np.asarray(clip.frames)[:8 * (len(clip.frames) // 8)]
    fps = clip.fps
    frames_j = jnp.asarray(frames)
    # W == T_local (the sharded path's tightest legal window).
    cfg = PipelineConfig(window_seconds=2.0, acquisition_seconds=2.0)

    bpm_sh, ok_sh, _ = measure_green_avg_sharded(
        vmesh.shard(frames_j, m, "time"), fps, m, cfg, bandpass=True)

    # Single-device composition: extract -> ffill -> sosfiltfilt -> window.
    trace = offline.extract_signals(frames_j, cfg)
    green = vfilt.forward_fill(trace.bgr[:, cfg.channel], trace.valid,
                               init="zeros")
    sos = design.sos_design("butterworth", fps, cfg.band.low_hz,
                            cfg.band.high_hz, order=2)
    filt = vfilt.sosfiltfilt(sos, green)
    roll = vwin.rolling_bpm_fft(filt, fps, cfg.band, cfg.window_len(fps),
                                cfg.acquisition_len(fps))
    ok_ref = np.asarray(jnp.logical_and(roll.valid, trace.valid))
    np.testing.assert_array_equal(np.asarray(ok_sh), ok_ref)
    bpm_sh, bpm_ref = np.asarray(bpm_sh), np.asarray(roll.bpm)
    # The halo filter matches to float tolerance, and the FFT argmax bin is
    # robust to it: the BPM traces agree everywhere valid.
    np.testing.assert_allclose(bpm_sh[ok_ref], bpm_ref[ok_ref], atol=0.5)
    err = np.abs(bpm_sh[ok_ref] - 90.0)
    assert err.mean() <= 5.0, err.mean()
