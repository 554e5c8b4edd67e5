"""Tests: ROI geometry, holdover semantics, masked reductions."""

import numpy as np
import pytest
import jax.numpy as jnp

from vhr_tpu.config import ROIConfig
from vhr_tpu.ops import reduce as vreduce
from vhr_tpu.ops import roi as vroi

RNG = np.random.default_rng(11)


# --- reference ports (analysis/utils/roi.py:43-59) -------------------------

def _ref_bbox(landmarks, w, h):
    xs, ys = landmarks[:, 0], landmarks[:, 1]
    return (int(max(0, xs.min() * w)), int(max(0, ys.min() * h)),
            int(min(w - 1, xs.max() * w)), int(min(h - 1, ys.max() * h)))


def _ref_cheek(bb, w, h, cfg: ROIConfig):
    x1, y1, x2, y2 = bb
    ry1 = int(np.clip(y1 + cfg.cheek_top * (y2 - y1), 0, h - 1))
    ry2 = int(np.clip(y1 + cfg.cheek_bottom * (y2 - y1), 0, h))
    rx1 = int(np.clip(x1 + cfg.cheek_horizontal * (x2 - x1), 0, w - 1))
    rx2 = int(np.clip(x2 - cfg.cheek_horizontal * (x2 - x1), 0, w))
    return rx1, ry1, rx2, ry2


def test_bbox_from_landmarks_matches_reference():
    w, h = 640, 480
    lms = RNG.uniform(0.1, 0.9, size=(10, 478, 2))
    ours = np.asarray(vroi.bbox_from_landmarks(jnp.asarray(lms), w, h))
    for i in range(10):
        assert tuple(ours[i]) == _ref_bbox(lms[i], w, h)


def test_cheek_roi_matches_reference():
    w, h = 640, 480
    cfg = ROIConfig()
    lms = RNG.uniform(0.05, 0.95, size=(20, 478, 2))
    bbox = vroi.bbox_from_landmarks(jnp.asarray(lms), w, h)
    ours = np.asarray(vroi.cheek_roi(bbox, cfg, w, h))
    for i in range(20):
        ref = _ref_cheek(_ref_bbox(lms[i], w, h), w, h, cfg)
        assert tuple(ours[i]) == ref


def _ref_holdover(valid, hold=15):
    """Port of the *intended* reuse rule at analysis/utils/roi.py:91-101."""
    out = []
    last = None
    budget = 0
    for v in valid:
        if v:
            last = True
            budget = hold
            out.append(True)
        elif last is not None and budget > 0:
            budget -= 1
            out.append(True)
        else:
            out.append(False)
    return out


@pytest.mark.parametrize("pattern", [
    [True] * 10,
    [False] * 5 + [True] * 5,
    [True] + [False] * 20,          # budget exhaustion after 15
    [True, False, False, True] * 5,
    [False] * 3,                    # never detected
])
def test_holdover_matches_reference_semantics(pattern):
    T = len(pattern)
    boxes = jnp.asarray(RNG.integers(0, 100, size=(T, 4)), dtype=jnp.int32)
    track = vroi.holdover(boxes, jnp.asarray(pattern), hold_frames=15)
    assert list(np.asarray(track.valid)) == _ref_holdover(pattern)


def test_holdover_reuses_last_box():
    boxes = np.zeros((5, 4), np.int32)
    boxes[0] = [1, 2, 3, 4]
    boxes[3] = [5, 6, 7, 8]
    valid = jnp.asarray([True, False, False, True, False])
    track = vroi.holdover(jnp.asarray(boxes), valid)
    got = np.asarray(track.box)
    assert list(got[1]) == [1, 2, 3, 4]
    assert list(got[2]) == [1, 2, 3, 4]
    assert list(got[4]) == [5, 6, 7, 8]


# --- reductions -------------------------------------------------------------

def _random_rois(T, H, W):
    rois = np.zeros((T, 4), np.int32)
    for t in range(T):
        x1 = RNG.integers(0, W - 2)
        y1 = RNG.integers(0, H - 2)
        rois[t] = [x1, y1, RNG.integers(x1 + 1, W), RNG.integers(y1 + 1, H)]
    return rois


def test_roi_channel_means_matches_numpy():
    T, H, W = 6, 48, 64
    frames = RNG.integers(0, 256, size=(T, H, W, 3), dtype=np.uint8)
    rois = _random_rois(T, H, W)
    means, count = vreduce.roi_channel_means(jnp.asarray(frames),
                                             jnp.asarray(rois))
    for t in range(T):
        x1, y1, x2, y2 = rois[t]
        patch = frames[t, y1:y2, x1:x2]
        ref = patch.reshape(-1, 3).mean(axis=0)
        np.testing.assert_allclose(np.asarray(means)[t], ref, rtol=1e-5)
        assert float(count[t]) == patch.shape[0] * patch.shape[1]


def test_roi_channel_means_empty_roi():
    frames = RNG.integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    rois = np.array([[5, 5, 5, 10], [3, 8, 10, 8]], np.int32)  # zero area
    means, count = vreduce.roi_channel_means(jnp.asarray(frames),
                                             jnp.asarray(rois))
    assert np.all(np.asarray(count) == 0)
    assert np.all(np.asarray(means) == 0)


# --- masked reduction edge cases ----------------------------------------------

def _boxes(kind, T, H, W):
    """Per-frame ROI tables exercising one edge case each."""
    if kind == "random":
        return _random_rois(T, H, W)
    if kind == "full":
        return np.tile(np.array([[0, 0, W, H]], np.int32), (T, 1))
    if kind == "empty":                      # zero area, invalid (all-zero)
        r = _random_rois(T, H, W)
        r[::2] = 0
        r[1::2, 2] = r[1::2, 0]
        return r
    if kind == "degenerate":                 # one row / one column
        r = _random_rois(T, H, W)
        r[:, 3] = r[:, 1] + 1
        r[1::2, 2] = r[1::2, 0] + 1
        return r
    if kind == "border":                     # spills past every frame edge
        r = _random_rois(T, H, W)
        r[:, 0] -= W // 2
        r[:, 1] -= H // 2
        r[1::2, 2] += W
        r[1::2, 3] += H
        return r
    raise ValueError(kind)


@pytest.mark.parametrize("shape", [(4, 40, 56), (3, 130, 96), (5, 37, 201),
                                   (1, 9, 600)])
@pytest.mark.parametrize("kind", ["random", "full", "empty", "degenerate",
                                  "border"])
def test_roi_channel_means_edge_cases(shape, kind):
    """The masked reduction vs float64 numpy over odd shapes and box edge
    cases; its contract: the sum over the in-frame part of the box divided
    by the (unclipped) box area, 0 for an empty box."""
    T, H, W = shape
    frames = RNG.integers(0, 256, size=(T, H, W, 3), dtype=np.uint8)
    rois = _boxes(kind, T, H, W)
    m, c = vreduce.roi_channel_means(jnp.asarray(frames), jnp.asarray(rois))
    for t in range(T):
        x1, y1, x2, y2 = rois[t]
        patch = frames[t, max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)]
        area = max(y2 - y1, 0) * max(x2 - x1, 0)
        ref = (patch.reshape(-1, 3).astype(np.float64).sum(0)
               / max(area, 1))
        np.testing.assert_allclose(np.asarray(m)[t], ref, rtol=1e-5,
                                   atol=1e-4)
        assert float(np.asarray(c)[t]) == area


# --- bpp.py statistics -------------------------------------------------------

def test_grayscale_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    frames = RNG.integers(0, 256, size=(3, 32, 48, 3), dtype=np.uint8)
    ours = np.asarray(vreduce.grayscale_u8(jnp.asarray(frames)))
    for t in range(3):
        ref = cv2.cvtColor(frames[t], cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(ours[t], ref)


def test_video_stats_match_reference_math():
    cv2 = pytest.importorskip("cv2")
    frames = RNG.integers(0, 256, size=(4, 24, 24, 3), dtype=np.uint8)
    stats = vreduce.video_stats(jnp.asarray(frames))
    for t in range(4):
        gray = cv2.cvtColor(frames[t], cv2.COLOR_BGR2GRAY)
        hist = cv2.calcHist([gray], [0], None, [256], [0, 256])
        hist = hist / hist.sum()
        ent = -np.sum(hist * np.log2(hist + 1e-6))       # bpp.py:41-45
        np.testing.assert_allclose(float(stats.entropy[t]), ent, rtol=1e-5)
        np.testing.assert_allclose(float(stats.noise_variance[t]),
                                   np.var(gray), rtol=1e-4)
        np.testing.assert_allclose(float(stats.nsr[t]),
                                   np.std(gray) / np.mean(gray), rtol=1e-5)


def _ellipse_cloud(cx, cy, rx, ry, angle_rad, L=68):
    """Rotated-ellipse boundary cloud, normalized coords (facegen layout)."""
    theta = 2.0 * np.pi * np.arange(L) / L
    ex, ey = rx * np.cos(theta), ry * np.sin(theta)
    ca, sa = np.cos(angle_rad), np.sin(angle_rad)
    return np.stack([cx + ex * ca - ey * sa,
                     cy + ex * sa + ey * ca], axis=-1).astype(np.float32)


def test_roi_from_landmarks_upright_matches_bbox_ratios():
    """For an upright face the landmark-frame ROI reduces to the reference's
    bbox-interior ratios (rppg_VIDEO.py:93-103) up to rounding."""
    from vhr_tpu.config import ROIConfig
    W, H = 640, 480
    cfg = ROIConfig()
    lm = jnp.asarray(_ellipse_cloud(0.5, 0.45, 0.2, 0.3, 0.0))[None]
    got = np.asarray(vroi.cheek_roi_from_landmarks(lm, cfg, W, H))[0]
    box = vroi.bbox_from_landmarks(lm, W, H)
    ref = np.asarray(vroi.cheek_roi(box, cfg, W, H))[0]
    assert np.abs(got - ref).max() <= 2, (got, ref)


def test_roi_from_landmarks_tracks_rotation():
    """Under 30 deg of head roll the landmark-frame ROI center follows the
    rotated cheek band; the naive bbox-ratio ROI drifts off it."""
    from vhr_tpu.config import ROIConfig
    W, H = 640, 480
    cfg = ROIConfig()
    cx, cy, rx, ry, ang = 0.5, 0.45, 0.15, 0.25, np.deg2rad(30.0)
    lm = jnp.asarray(_ellipse_cloud(cx, cy, rx, ry, ang))[None]

    got = np.asarray(vroi.cheek_roi_from_landmarks(lm, cfg, W, H))[0]
    gc = np.array([(got[0] + got[2]) / 2.0, (got[1] + got[3]) / 2.0])

    # Analytic rotated cheek-band center: c + beta_mid * R(0, ry).
    beta_mid = ((2 * cfg.cheek_top - 1) + (2 * cfg.cheek_bottom - 1)) / 2.0
    v = np.array([-np.sin(ang) * ry, np.cos(ang) * ry])  # rotated (0, ry)
    expect = np.array([(cx + beta_mid * v[0]) * W,
                       (cy + beta_mid * v[1]) * H])
    assert np.abs(gc - expect).max() <= 3.0, (gc, expect)

    box = vroi.bbox_from_landmarks(lm, W, H)
    naive = np.asarray(vroi.cheek_roi(box, cfg, W, H))[0]
    nc = np.array([(naive[0] + naive[2]) / 2.0, (naive[1] + naive[3]) / 2.0])
    # The naive center misses the rotated band by more than the landmark ROI.
    assert np.linalg.norm(nc - expect) > 2.0 * np.linalg.norm(gc - expect)


def test_holdover_attempted_mask_cadence_semantics():
    """Detection-cadence tracking (``attempted``): not-attempted frames
    reuse the box WITHOUT draining the holdover failure budget; the budget
    counts only attempted-but-failed frames."""
    import jax.numpy as jnp
    from vhr_tpu.ops import roi as vroi

    T, hold = 12, 2
    box = np.zeros((T, 4), np.int32)
    box[0] = [10, 10, 20, 20]
    valid = np.zeros((T,), bool)
    valid[0] = True
    # Cadence 4: frames 0, 4, 8 attempted; detection fails on 4 and 8.
    attempted = np.zeros((T,), bool)
    attempted[::4] = True

    tr = vroi.holdover(jnp.asarray(box), jnp.asarray(valid), hold,
                       attempted=jnp.asarray(attempted))
    v = np.asarray(tr.valid)
    # Frames 1-3 track (not attempted); 4 fails -> budget 2->1 reuse ok;
    # 5-7 track; 8 fails -> budget 1->0 reuse ok; 9-11 still track (budget
    # drains only on attempted failures).
    assert v.all(), v
    np.testing.assert_array_equal(np.asarray(tr.box),
                                  np.broadcast_to(box[0], (T, 4)))

    # Same inputs with every frame attempted: budget (2) exhausts after
    # frames 1-2, so frames 3+ are invalid — the mask genuinely changes
    # the semantics rather than being a no-op.
    tr_all = vroi.holdover(jnp.asarray(box), jnp.asarray(valid), hold)
    v_all = np.asarray(tr_all.valid)
    assert v_all[:3].all() and not v_all[3:].any(), v_all


def test_extract_signals_detect_every_pluggable():
    """``extract_signals(detect_every=N)`` with a pluggable detector runs
    the detector on ceil(T/N) frames only and tracks identically to
    cadence 1 when detection is stable."""
    import jax
    import jax.numpy as jnp
    from vhr_tpu.pipeline import offline

    T, H, W = 13, 24, 32
    rng = np.random.default_rng(0)
    frames = jnp.asarray(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    box = jnp.asarray([4, 4, 28, 20], jnp.int32)

    calls = {}

    def det(fr):
        calls["n"] = fr.shape[0]
        return (jnp.broadcast_to(box, (fr.shape[0], 4)),
                jnp.ones((fr.shape[0],), bool))

    t1 = offline.extract_signals(frames, detector=det)
    t4 = offline.extract_signals(frames, detector=det, detect_every=4)
    assert calls["n"] == 4                      # ceil(13/4) frames detected
    np.testing.assert_array_equal(np.asarray(t4.valid),
                                  np.asarray(t1.valid))
    np.testing.assert_array_equal(np.asarray(t4.boxes),
                                  np.asarray(t1.boxes))
    np.testing.assert_allclose(np.asarray(t4.bgr), np.asarray(t1.bgr),
                               rtol=0, atol=1e-5)


def test_extract_signals_multi_detect_every_pluggable():
    """Multi-face detection cadence: the K-face detector runs on every
    N-th frame and the identity-matched holdover tracks through the rest
    without draining budgets — stable detections give cadence-4 output
    identical to cadence-1."""
    import jax.numpy as jnp
    from vhr_tpu.pipeline import offline

    T, H, W, K = 13, 24, 32, 2
    rng = np.random.default_rng(1)
    frames = jnp.asarray(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    boxes = jnp.asarray([[2, 4, 12, 18], [18, 5, 30, 19]], jnp.int32)

    calls = {}

    def det(fr):
        calls["n"] = fr.shape[0]
        return (jnp.broadcast_to(boxes, (fr.shape[0], K, 4)),
                jnp.ones((fr.shape[0], K), bool))

    t1 = offline.extract_signals_multi(frames, K, detector=det)
    t4 = offline.extract_signals_multi(frames, K, detector=det,
                                       detect_every=4)
    assert calls["n"] == 4
    np.testing.assert_array_equal(np.asarray(t4.valid), np.asarray(t1.valid))
    np.testing.assert_array_equal(np.asarray(t4.boxes), np.asarray(t1.boxes))
    np.testing.assert_allclose(np.asarray(t4.bgr), np.asarray(t1.bgr),
                               rtol=0, atol=1e-5)


def test_streaming_detect_every_matches_whole_video():
    """Chunked streaming with detection cadence equals the whole-video
    cadence pass across chunk boundaries (chunk starts stay on the global
    detection phase because detect_every divides chunk_frames)."""
    import cv2
    import tempfile
    import jax.numpy as jnp
    from vhr_tpu.pipeline import offline
    from vhr_tpu.utils.synth import SynthSpec, synthesize

    v = synthesize(SynthSpec(duration_s=3.0, height=48, width=64, bpm=75.0))
    path = tempfile.mktemp(suffix=".avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), v.fps,
                        (64, 48))
    for f in v.frames:
        w.write(f)
    w.release()

    from vhr_tpu.io import video as vio
    frames, fps = vio.read_video(path)
    whole = offline.extract_signals(jnp.asarray(frames), detect_every=4)
    bgr, valid, _ = offline.extract_signals_streaming(
        path, chunk_frames=8, detect_every=4)
    np.testing.assert_array_equal(valid, np.asarray(whole.valid))
    np.testing.assert_allclose(bgr, np.asarray(whole.bgr), rtol=0, atol=2e-4)

    import pytest as _pytest
    with _pytest.raises(ValueError):
        offline.extract_signals_streaming(path, chunk_frames=10,
                                          detect_every=4)


def test_landmark_roi_detect_every_cadence():
    """The pose-robust (boxes, rois, valid) path honors detect_every with
    cadence-4 output equal to cadence-1 under stable detection."""
    import jax.numpy as jnp
    from vhr_tpu.pipeline import offline

    T, H, W = 13, 24, 32
    rng = np.random.default_rng(6)
    frames = jnp.asarray(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    box = jnp.asarray([4, 4, 28, 20], jnp.int32)
    roi = jnp.asarray([8, 8, 24, 16], jnp.int32)

    calls = {}

    def det(fr):
        calls["n"] = fr.shape[0]
        n = fr.shape[0]
        return (jnp.broadcast_to(box, (n, 4)),
                jnp.broadcast_to(roi, (n, 4)), jnp.ones((n,), bool))

    t1 = offline.extract_signals_landmark_roi(frames, det)
    t4 = offline.extract_signals_landmark_roi(frames, det, detect_every=4)
    assert calls["n"] == 4
    np.testing.assert_array_equal(np.asarray(t4.valid), np.asarray(t1.valid))
    np.testing.assert_array_equal(np.asarray(t4.rois), np.asarray(t1.rois))
    np.testing.assert_allclose(np.asarray(t4.bgr), np.asarray(t1.bgr),
                               rtol=0, atol=1e-5)
