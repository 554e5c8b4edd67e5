"""Live streaming driver tests: causal filtering, ring Welch, holdover."""

import numpy as np
import pytest
import scipy.signal as sp
import jax
import jax.numpy as jnp

from vhr_tpu.config import HRBand
from vhr_tpu.dsp import design
from vhr_tpu.pipeline import live
from vhr_tpu.utils.synth import SynthSpec, synthesize


@pytest.fixture(scope="module")
def clip():
    return synthesize(SynthSpec(duration_s=25.0, bpm=72.0, height=48,
                                width=64, fps=30.0, noise_std=0.5))


def test_live_stream_recovers_bpm(clip):
    cfg = live.LiveConfig(fps=clip.fps)
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    outs = []
    for f in clip.frames:
        st, out = stp(st, jnp.asarray(f))
        outs.append(out)
    bpms = np.array([float(o.bpm) for o in outs])
    valid = np.array([bool(o.bpm_valid) for o in outs])
    # Welch needs a full 9 s segment (270 samples at 30 fps).
    assert not valid[:269].any()
    assert valid[280:].all()
    err = np.abs(bpms[valid] - 72.0)
    assert np.median(err) <= 7.0  # welch bin resolution ~6.7 BPM


def test_live_filter_matches_scipy_streaming(clip):
    """green_filtered must equal scipy sosfilt with carried zi on the same
    raw greens (rppg_LIVESTREAM.py:245-251 semantics)."""
    cfg = live.LiveConfig(fps=clip.fps)
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    raws, filts = [], []
    for f in clip.frames[:90]:
        st, out = stp(st, jnp.asarray(f))
        raws.append(float(out.green_raw))
        filts.append(float(out.green_filtered))
    sos = design.sos_design("butterworth", cfg.fps, cfg.band.low_hz,
                            cfg.band.high_hz, cfg.filter_order)
    ref, _ = sp.sosfilt(sos, np.asarray(raws),
                        zi=np.zeros((sos.shape[0], 2)))
    np.testing.assert_allclose(np.asarray(filts), ref, rtol=1e-4, atol=1e-4)


def test_live_holdover_on_dropout():
    v = synthesize(SynthSpec(duration_s=3.0, height=48, width=64,
                             dropout_frames=tuple(range(30, 36))))
    cfg = live.LiveConfig(fps=v.fps)
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    face_valid = []
    for f in v.frames:
        st, out = stp(st, jnp.asarray(f))
        face_valid.append(bool(out.face_valid))
    # 6-frame dropout bridged by the 15-frame holdover.
    assert all(face_valid[30:36])


def test_live_state_is_a_fixed_pytree(clip):
    """State never changes structure/shape -> one compilation, no leaks."""
    cfg = live.LiveConfig(fps=clip.fps)
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    st1, _ = stp(st, jnp.asarray(clip.frames[0]))
    assert jax.tree.structure(st) == jax.tree.structure(st1)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st1)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_live_ring_fill_welch_matches_reference_port(clip):
    """Pin the ring-FILL transient against a port of the reference's per-frame
    Welch (``rppg_LIVESTREAM.py:347`` -> ``estimate_bpm_welch``): once one
    full 9 s segment of valid data exists and until the ring wraps, the live
    step's BPM must equal scipy Welch on the growing deque contents.  Before
    that, the reference would emit small-nperseg estimates; the live step
    deliberately reports invalid (acquisition semantics) — also pinned."""
    cfg = live.LiveConfig(fps=clip.fps, ring_len=400)
    nperseg = int(cfg.welch_segment_seconds * cfg.fps)      # 270
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    deque_filt = []
    T = 380                                                  # < ring_len
    for i, f in enumerate(clip.frames[:T]):
        st, out = stp(st, jnp.asarray(f))
        deque_filt.append(float(out.green_filtered))
        if i < nperseg - 1:
            assert not bool(out.bpm_valid)                   # acquiring
            continue
        assert bool(out.bpm_valid)
        x = np.asarray(deque_filt)
        freqs, psd = sp.welch(x - x.mean(), fs=cfg.fps, window="hann",
                              nperseg=nperseg, noverlap=nperseg // 2,
                              detrend="constant", scaling="density",
                              average="mean")
        band = (freqs >= cfg.band.low_hz) & (freqs <= cfg.band.high_hz)
        ref_bpm = freqs[band][np.argmax(psd[band])] * 60.0
        assert float(out.bpm) == pytest.approx(ref_bpm, abs=1e-3), i


def test_live_multi_matches_offline_tracking():
    """step_multi's K-track identity handling is bit-identical to the
    offline scan (both run ops.roi.holdover_multi_step)."""
    from vhr_tpu.models.multiface import detect_faces_multi
    from vhr_tpu.ops import roi as vroi
    from vhr_tpu.utils.synth import FaceSpec, synthesize_multi

    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=66.0,
                  dropout_frames=tuple(range(40, 50))),
         FaceSpec(center=(0.72, 0.5), bpm=90.0)),
        duration_s=4.0)
    frames = jnp.asarray(duo.frames)
    cand, cval = detect_faces_multi(frames, k_faces=2)
    track = vroi.holdover_multi(cand, cval)

    cfg = live.LiveConfig(fps=duo.fps)
    st = live.init_state_multi(cfg, 2)
    stp = live.make_step_multi(cfg, 2, donate=False)
    boxes, valid = [], []
    for f in duo.frames:
        st, out = stp(st, jnp.asarray(f))
        boxes.append(np.asarray(out.box))
        valid.append(np.asarray(out.face_valid))
    np.testing.assert_array_equal(np.stack(boxes), np.asarray(track.box))
    np.testing.assert_array_equal(np.stack(valid), np.asarray(track.valid))


def test_live_multi_two_bpms():
    """K-subject live monitoring: both subjects' BPMs from one stream of
    frames (the reference's num_faces=2 surface, rppg_LIVESTREAM.py:308,
    which it never actually delivers — it reads face_landmarks[0] only)."""
    from vhr_tpu.utils.synth import FaceSpec, synthesize_multi

    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=60.0),
         FaceSpec(center=(0.72, 0.5), bpm=96.0)),
        height=144, width=256, duration_s=22.0, noise_std=1.0)
    cfg = live.LiveConfig(fps=duo.fps)
    st = live.init_state_multi(cfg, 2)
    stp = live.make_step_multi(cfg, 2, donate=False)
    bpms, valids = [], []
    for f in duo.frames:
        st, out = stp(st, jnp.asarray(f))
        bpms.append(np.asarray(out.bpm))
        valids.append(np.asarray(out.bpm_valid))
    bpms, valids = np.stack(bpms), np.stack(valids)
    assert not valids[:269].any()
    assert valids[280:].all()
    # Evaluate after the causal SOS startup transient (zero zi on a ~135
    # DC input — reference-parity semantics, live_sos_init) has mostly
    # left the Welch segments.
    err = np.abs(bpms[-100:] - np.array([60.0, 96.0])[None, :])
    assert np.median(err[:, 0]) <= 7.0      # welch bin ~6.7 BPM
    assert np.median(err[:, 1]) <= 7.0


def test_live_step_learned_detector():
    """Single-face live step with the learned landmarker (the reference's
    live mode IS MediaPipe): weights ride as call-time args, and the live
    tracking matches the offline holdover frame-for-frame."""
    from pathlib import Path
    CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "landmarker"
    if not CKPT.exists():
        pytest.skip("no trained checkpoint")
    from vhr_tpu.models.landmarker import load_default_detector
    from vhr_tpu.ops import roi as vroi
    from vhr_tpu.pipeline import offline

    det = load_default_detector()
    clip = synthesize(SynthSpec(duration_s=2.0, bpm=72.0, height=64,
                                width=80, noise_std=0.5))
    frames = jnp.asarray(clip.frames)
    det_fn, det_args = offline._split_detector(det)
    raw_b, raw_v = det_fn(*det_args, frames)
    track = vroi.holdover(raw_b, raw_v)

    cfg = live.LiveConfig(fps=clip.fps)
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False, detector=det)
    boxes, valid = [], []
    for f in clip.frames:
        st, out = stp(st, jnp.asarray(f))
        boxes.append(np.asarray(out.box))
        valid.append(bool(out.face_valid))
    np.testing.assert_array_equal(np.stack(boxes), np.asarray(track.box))
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(track.valid))


def test_live_pipeline_matches_sequential(clip):
    """LivePipeline's 1-deep pipelining returns exactly the sequential
    outputs, shifted by one frame (VERDICT r2 #3)."""
    cfg = live.LiveConfig(fps=clip.fps)
    n = 40

    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    seq = []
    for f in clip.frames[:n]:
        st, out = stp(st, jnp.asarray(f))
        seq.append(np.asarray(out.green_raw))

    pipe = live.LivePipeline(cfg, donate=False)
    got = []
    for f in clip.frames[:n]:
        out = pipe.submit(jnp.asarray(f))
        if out is not None:
            got.append(np.asarray(out.green_raw))
    assert pipe.submit(jnp.asarray(clip.frames[0])) is not None
    last = pipe.flush()
    assert last is not None and pipe.flush() is None
    # first submit returns None; outputs then stream in order
    np.testing.assert_allclose(np.asarray(got), np.asarray(seq[:n - 1]))


def test_live_detect_every_cadence_pluggable():
    """``LiveConfig(detect_every=N)`` with a pluggable detector: detection
    runs on wall frames 0, N, 2N, ... only (counted via a host callback on
    the cond branch being traced is NOT possible — count actual detector
    *validity* effects instead), skipped frames track without draining the
    holdover budget, and output equals cadence 1 under stable detection."""
    import jax.numpy as jnp

    T, H, W = 13, 24, 32
    rng = np.random.default_rng(2)
    frames = [jnp.asarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
              for _ in range(T)]
    box = jnp.asarray([4, 4, 28, 20], jnp.int32)

    def det(fr):
        return (jnp.broadcast_to(box, (fr.shape[0], 4)),
                jnp.ones((fr.shape[0],), bool))

    outs = {}
    for every in (1, 4):
        cfg = live.LiveConfig(fps=10.0, detect_every=every)
        st = live.init_state(cfg)
        rows = []
        for f in frames:
            st, out = live.step(st, f, cfg, detector=det)
            rows.append((bool(out.face_valid), float(out.green_raw),
                         np.asarray(out.box).tolist()))
        outs[every] = rows
    assert outs[1] == outs[4]

    # Budget semantics: a detector that NEVER fires after frame 0 keeps
    # tracking on skipped frames; only attempted failures drain budget.
    hold = live.LiveConfig(fps=10.0, detect_every=4).roi.landmark_hold_frames
    fire = {"on": True}

    def det_once(fr):
        ok = jnp.asarray([fire["on"]])
        return jnp.broadcast_to(box, (fr.shape[0], 4)), ok

    cfg = live.LiveConfig(fps=10.0, detect_every=4)
    st = live.init_state(cfg)
    st, out0 = live.step(st, frames[0], cfg, detector=det_once)
    assert bool(out0.face_valid)
    fire["on"] = False
    valid = []
    for f in frames[1:]:
        st, out = live.step(st, f, cfg, detector=det_once)
        valid.append(bool(out.face_valid))
    # Attempted failures at wall frames 4, 8, 12 -> budget 15 drains by 3;
    # all 12 following frames remain valid (tracked or reused).
    assert all(valid), valid
    assert int(st.hold_budget) == hold - 3


def test_live_multi_detect_every_cadence():
    """Multi-face live cadence: cadence-4 output equals cadence-1 under
    stable detection, and tracks hold without budget drain on skipped
    frames."""
    import jax.numpy as jnp

    T, H, W, K = 13, 24, 32, 2
    rng = np.random.default_rng(4)
    frames = [jnp.asarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
              for _ in range(T)]
    boxes = jnp.asarray([[2, 4, 12, 18], [18, 5, 30, 19]], jnp.int32)

    def det(fr):
        return (jnp.broadcast_to(boxes, (fr.shape[0], K, 4)),
                jnp.ones((fr.shape[0], K), bool))

    outs = {}
    for every in (1, 4):
        cfg = live.LiveConfig(fps=10.0, detect_every=every)
        st = live.init_state_multi(cfg, k_faces=K)
        rows = []
        for f in frames:
            st, out = live.step_multi(st, f, cfg, K, detector=det)
            rows.append((np.asarray(out.face_valid).tolist(),
                         np.asarray(out.green_raw).round(5).tolist(),
                         np.asarray(out.box).tolist()))
        outs[every] = rows
    assert outs[1] == outs[4]


def test_live_i420_transfer_matches_bgr(clip):
    """transfer="i420" (host ships planar YUV 4:2:0, device reconstructs
    BGR bit-exactly vs OpenCV) tracks identically to BGR staging; the green
    means differ only by the 4:2:0 chroma-subsample loss."""
    cv2 = pytest.importorskip("cv2")
    cfg = live.LiveConfig(fps=clip.fps, ring_len=64)
    n = 30

    sb = live.make_step(cfg, donate=False)
    si = live.make_step(cfg, donate=False, transfer="i420")
    stb, sti = live.init_state(cfg), live.init_state(cfg)
    gb, gi = [], []
    for f in clip.frames[:n]:
        stb, ob = sb(stb, jnp.asarray(f))
        sti, oi = si(sti, jnp.asarray(live.bgr_to_i420_host(f)))
        assert bool(ob.face_valid) == bool(oi.face_valid)
        gb.append(float(ob.green_raw))
        gi.append(float(oi.green_raw))
    assert float(np.abs(np.array(gb) - np.array(gi)).max()) < 1.5

    # the pipelined loop accepts the same planar frames
    pipe = live.LivePipeline(cfg, donate=False, transfer="i420")
    outs = []
    for f in clip.frames[:n]:
        out = pipe.submit(jnp.asarray(live.bgr_to_i420_host(f)))
        if out is not None:
            outs.append(float(out.green_raw))
    np.testing.assert_allclose(np.asarray(outs), np.asarray(gi[:n - 1]),
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(6, 10), (48, 64), (720, 1280)])
def test_bgr_to_i420_host_bitexact_vs_opencv(shape):
    """The numpy host conversion equals cv2.COLOR_BGR2YUV_I420 exactly."""
    cv2 = pytest.importorskip("cv2")
    f = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(live.bgr_to_i420_host(f),
                                  cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420))


def test_live_ingest_downsample_bpm_parity():
    """The low-bandwidth ingest mode (host INTER_AREA 4x + i420, 32x fewer
    wire bytes) recovers the same steady BPM as full-resolution frames:
    INTER_AREA is exact 4x4 block means, which commutes (to block-boundary
    effects) with the ROI's own spatial mean."""
    cv2 = pytest.importorskip("cv2")
    clip4 = synthesize(SynthSpec(duration_s=12.0, bpm=84.0, height=96,
                                 width=128, fps=30.0, noise_std=0.5))
    cfg = live.LiveConfig(fps=clip4.fps, ring_len=256)

    def bpm_trace(feed_fn, transfer):
        st = live.init_state(cfg)
        stp = live.make_step(cfg, donate=False, transfer=transfer)
        bpms = []
        for f in clip4.frames:
            st, out = stp(st, feed_fn(f))
            if bool(out.bpm_valid):
                bpms.append(float(out.bpm))
        return np.asarray(bpms)

    full = bpm_trace(lambda f: jnp.asarray(f), "bgr")

    def ds4_i420(f):
        small = cv2.resize(f, (f.shape[1] // 4, f.shape[0] // 4),
                           interpolation=cv2.INTER_AREA)
        return jnp.asarray(live.bgr_to_i420_host(small))

    low = bpm_trace(ds4_i420, "i420")
    assert full.size and low.size
    # Same steady estimate (the synthetic pulse sits on an exact FFT bin).
    assert abs(np.median(full[full.size // 2:])
               - np.median(low[low.size // 2:])) < 2.0


def test_live_pipeline_fetch_every_batches(clip):
    """fetch_every=N returns the same outputs as the 1-deep pipeline, in
    order, batched N at a time via one stacked device fetch."""
    cfg = live.LiveConfig(fps=clip.fps)
    n = 25

    ref_pipe = live.LivePipeline(cfg, donate=False)
    ref = []
    for f in clip.frames[:n]:
        out = ref_pipe.submit(jnp.asarray(f))
        if out is not None:
            ref.append(float(out.green_raw))
    last = ref_pipe.flush()
    ref.append(float(last.green_raw))

    pipe = live.LivePipeline(cfg, donate=False, fetch_every=3)
    got = []
    for f in clip.frames[:n]:
        outs = pipe.submit(jnp.asarray(f))
        if outs is not None:
            assert isinstance(outs, list) and len(outs) == 3
            got.extend(float(o.green_raw) for o in outs)
    tail = pipe.flush()
    assert isinstance(tail, list)
    got.extend(float(o.green_raw) for o in tail)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref))


def test_live_pipeline_frames_per_call(clip):
    """frames_per_call=M (one upload, one M-step scan, one fetch per M
    frames) reproduces the sequential outputs exactly, including a partial
    tail drained by flush; composes with i420 transfer."""
    cfg = live.LiveConfig(fps=clip.fps, ring_len=64)
    n = 23                                    # not a multiple of M=4

    ref_pipe = live.LivePipeline(cfg, donate=False)
    ref = []
    for f in clip.frames[:n]:
        out = ref_pipe.submit(f)
        if out is not None:
            ref.append(float(out.green_raw))
    ref.append(float(ref_pipe.flush().green_raw))

    pipe = live.LivePipeline(cfg, donate=False, frames_per_call=4)
    got = []
    for f in clip.frames[:n]:
        outs = pipe.submit(f)
        if outs:
            assert len(outs) == 4
            got.extend(float(o.green_raw) for o in outs)
    got.extend(float(o.green_raw) for o in pipe.flush())
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)

    with pytest.raises(ValueError):
        live.LivePipeline(cfg, fetch_every=2, frames_per_call=2)


# --- motion-robust methods on the live surface (LiveConfig.method) ---------


def test_live_projection_methods_recover_bpm():
    """chrom/pos/omit/adaptive live steps all resolve the injected rate on
    a clean clip (the live counterparts of offline.measure_projection /
    measure_adaptive; the reference's streaming mode has only green,
    rppg_LIVESTREAM.py:245-251)."""
    c = synthesize(SynthSpec(duration_s=14.0, bpm=84.0, height=48, width=64,
                             fps=10.0, noise_std=0.5))
    for method in ("chrom", "pos", "omit", "adaptive"):
        cfg = live.LiveConfig(fps=c.fps, ring_len=120, method=method)
        st = live.init_state(cfg)
        stp = live.make_step(cfg, donate=False)
        for f in c.frames:
            st, out = stp(st, jnp.asarray(f))
        assert bool(out.bpm_valid), method
        assert abs(float(out.bpm) - 84.0) <= 8.0, method


def test_live_method_green_unchanged():
    """method='green' is bit-identical to the pre-method live step (the
    ring_bgr addition must not perturb the reference-parity path)."""
    c = synthesize(SynthSpec(duration_s=12.0, bpm=78.0, height=48, width=64,
                             fps=10.0, noise_std=0.4, seed=3))
    cfg = live.LiveConfig(fps=c.fps, ring_len=120)       # default green
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    outs = []
    for f in c.frames:
        st, o = stp(st, jnp.asarray(f))
        outs.append(o)
    # The green path Welches the SOS-filtered ring; recompute from the
    # emitted filtered samples (all frames valid on this clip).
    assert all(bool(o.face_valid) for o in outs)
    x = np.array([float(o.green_filtered) for o in outs])
    nperseg = int(cfg.welch_segment_seconds * cfg.fps)
    freqs, psd = sp.welch(x - x.mean(), fs=cfg.fps, window="hann",
                          nperseg=nperseg, noverlap=nperseg // 2,
                          detrend="constant", average="mean")
    band = (freqs >= cfg.band.low_hz) & (freqs <= cfg.band.high_hz)
    ref_bpm = freqs[band][np.argmax(psd[band])] * 60.0
    assert float(outs[-1].bpm) == pytest.approx(ref_bpm, abs=1e-3)
    assert int(outs[-1].choice) == 0


def test_live_method_steady_state_matches_offline_pulse():
    """Once the ring is full, a projection method's live BPM equals the
    OFFLINE pulse construction (dsp.projections) applied to the trailing
    ring_len BGR means + the masked Welch — streaming == offline, through
    the step's carried ring/rotation bookkeeping."""
    from vhr_tpu.dsp import projections as proj
    from vhr_tpu.pipeline import offline

    c = synthesize(SynthSpec(duration_s=18.0, bpm=84.0, height=48, width=64,
                             fps=10.0, noise_std=0.5, seed=5))
    N = 120
    trace = offline.extract_signals(jnp.asarray(c.frames),
                                    offline.PipelineConfig())
    assert bool(np.asarray(trace.valid).all())
    for method, fn in (("chrom", proj.chrom_pulse),
                       ("pos", proj.pos_pulse),
                       ("omit", proj.omit_pulse)):
        cfg = live.LiveConfig(fps=c.fps, ring_len=N, method=method)
        st = live.init_state(cfg)
        stp = live.make_step(cfg, donate=False)
        for f in c.frames:
            st, out = stp(st, jnp.asarray(f))
        tail = jnp.asarray(np.asarray(trace.bgr)[-N:])       # (N, 3)
        pulse = fn(tail, jnp.ones((N,), bool), c.fps)
        exp_bpm, exp_valid = live._masked_welch_bpm(
            pulse, jnp.int32(N), cfg.fps, cfg.band,
            cfg.welch_segment_seconds)
        assert bool(out.bpm_valid) == bool(exp_valid), method
        assert float(out.bpm) == pytest.approx(float(exp_bpm),
                                               abs=1e-4), method


def test_live_adaptive_rejects_flicker_green_does_not():
    """In-band common-mode illumination flicker captures the green live
    path (it locks to the flicker frequency); the adaptive selector routes
    to a projection and recovers the true pulse — the offline
    test_adaptive scenario on the LIVE surface."""
    c = synthesize(SynthSpec(duration_s=16.0, bpm=72.0, height=48, width=64,
                             fps=10.0, noise_std=0.3,
                             flicker_bpm=120.0, flicker_amp=0.15))
    outs = {}
    for method in ("green", "adaptive"):
        cfg = live.LiveConfig(fps=c.fps, ring_len=120, method=method)
        st = live.init_state(cfg)
        stp = live.make_step(cfg, donate=False)
        for f in c.frames:
            st, out = stp(st, jnp.asarray(f))
        outs[method] = out
    assert bool(outs["green"].bpm_valid)
    assert abs(float(outs["green"].bpm) - 120.0) <= 6.0      # fooled
    assert bool(outs["adaptive"].bpm_valid)
    assert abs(float(outs["adaptive"].bpm) - 72.0) <= 6.0    # not fooled
    assert int(outs["adaptive"].choice) != 0                 # a projection


def test_live_multi_method_projection():
    """K-subject live steps honor LiveConfig.method (vmapped per-face
    ring recompute)."""
    from vhr_tpu.utils.synth import FaceSpec, synthesize_multi

    duo = synthesize_multi(
        (FaceSpec(center=(0.28, 0.45), bpm=84.0),
         FaceSpec(center=(0.72, 0.45), bpm=66.0)),
        height=64, width=96, fps=10.0, duration_s=14.0, noise_std=0.5)
    cfg = live.LiveConfig(fps=duo.fps, ring_len=120, method="pos")
    st = live.init_state_multi(cfg, k_faces=2)
    stp = live.make_step_multi(cfg, k_faces=2, donate=False)
    for f in duo.frames:
        st, out = stp(st, jnp.asarray(f))
    bpms = sorted(float(b) for b in np.asarray(out.bpm))
    assert all(bool(v) for v in np.asarray(out.bpm_valid))
    assert abs(bpms[0] - 66.0) <= 8.0 and abs(bpms[1] - 84.0) <= 8.0
