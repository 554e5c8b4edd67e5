"""DSP contractions run in exact float32 (precision HIGHEST).

On an NVIDIA GPU a float32 contraction at default precision may run in
TF32 (about 11 significant bits).  Every contraction that carries pixel
sums or filter state asks for HIGHEST; these tests read that request out
of the traced program (it is what the GPU compiler sees) and check the
values against float64 numpy at 1080p-scale sums.
"""

import numpy as np
import pytest
import jax
import jax.extend
import jax.numpy as jnp

from vhr_tpu.config import BAND_ANALYSIS, BAND_LIVE

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(fn, *args):
    """Precision of every dot_general in ``fn``'s jaxpr, sub-jaxprs
    included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _all_highest(precs):
    assert precs, "no contraction traced"
    for p in precs:
        assert p is not None and all(q == HIGHEST for q in p), p


def _frame_1080p(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (1, 1080, 1920, 3), dtype=np.uint8)


def test_roi_means_1080p_full_frame():
    from vhr_tpu.ops import reduce as vreduce

    fr = _frame_1080p()
    rois = np.array([[0, 0, 1920, 1080]], np.int32)
    args = (jnp.asarray(fr), jnp.asarray(rois))
    _all_highest(_dot_precisions(vreduce.roi_channel_means, *args))
    m, _ = vreduce.roi_channel_means(*args)
    ref = fr[0].reshape(-1, 3).astype(np.float64).mean(0)
    np.testing.assert_allclose(np.asarray(m)[0], ref, rtol=0, atol=1e-3)


def test_roi_means_multi_1080p():
    from vhr_tpu.ops import reduce as vreduce

    fr = _frame_1080p(1)
    rois = np.array([[[0, 0, 1920, 1080], [100, 200, 900, 700]]], np.int32)
    args = (jnp.asarray(fr), jnp.asarray(rois))
    _all_highest(_dot_precisions(vreduce.roi_channel_means_multi, *args))
    m, _ = vreduce.roi_channel_means_multi(*args)
    for k, (x1, y1, x2, y2) in enumerate(rois[0]):
        ref = fr[0, y1:y2, x1:x2].reshape(-1, 3).astype(np.float64).mean(0)
        np.testing.assert_allclose(np.asarray(m)[0, k], ref, atol=1e-3)


def test_i420_roi_means_1080p():
    from vhr_tpu.ops import color

    H, W = 1080, 1920
    rng = np.random.default_rng(2)
    raw = rng.integers(16, 236, (1, H * W * 3 // 2), dtype=np.uint8)
    rois = np.array([[0, 0, W, H]], np.int32)
    args = (jnp.asarray(raw), jnp.asarray(rois))
    fn = lambda r, b: color.i420_roi_means(r, b, H, W)
    _all_highest(_dot_precisions(fn, *args))
    m, _ = fn(*args)
    y = raw[0, :H * W].astype(np.float64)
    u = raw[0, H * W:H * W * 5 // 4].astype(np.float64)
    ym = np.maximum(y - 16.0, 0).mean()
    b = (1220542 * ym + 2116026 * (u.mean() - 128.0)) / 2 ** 20
    np.testing.assert_allclose(float(m[0, 0]), b, atol=1e-3)


def test_parallel_iir_matches_scipy():
    import scipy.signal as sps

    from vhr_tpu.dsp import design, filters

    fps = 30.0
    sos = design.sos_design("butterworth", fps, 0.7, 4.0, 4)
    t = np.arange(4096) / fps
    x = 120.0 + 2.0 * np.sin(2 * np.pi * 1.2 * t) + np.random.default_rng(
        3).normal(0, 0.5, t.size)
    xj = jnp.asarray(x, jnp.float32)
    _all_highest(_dot_precisions(
        lambda v: filters.sosfilt_parallel(sos, v)[0], xj))
    y, _ = filters.sosfilt_parallel(sos, xj)
    ref = sps.sosfilt(sos, x)
    np.testing.assert_allclose(np.asarray(y), ref, atol=2e-3)


def test_dft_ramp_matches_numpy():
    from vhr_tpu.dsp import spectral

    fps, T = 30.0, 900
    t = np.arange(T) / fps
    sig = np.stack([np.sin(2 * np.pi * 1.3 * t), np.cos(2 * np.pi * 0.9 * t)],
                   -1) * 200.0
    args = (jnp.asarray(sig, jnp.float32), 700)
    fn = lambda s, n: spectral.estimate_bpm_multichannel_exact(
        s, n, fps, BAND_ANALYSIS).bpm
    _all_highest(_dot_precisions(fn, *args))
    got = float(fn(*args))
    freqs = np.fft.fftfreq(700, 1 / fps)
    mags = np.abs(np.fft.fft(sig[:700], axis=0))
    band = (freqs >= BAND_ANALYSIS.low_hz) & (freqs <= BAND_ANALYSIS.high_hz)
    ch = np.argmax(mags[band].max(0))
    assert got == pytest.approx(freqs[band][np.argmax(mags[band, ch])] * 60,
                                abs=1e-3)


def test_live_banded_welch_contractions():
    from vhr_tpu.pipeline import live

    N = 500
    x = jnp.asarray(150.0 + np.sin(2 * np.pi * 1.2 * np.arange(N) / 30.0),
                    jnp.float32)
    fn = lambda v: live._masked_welch_bpm(v, jnp.int32(N), 30.0, BAND_LIVE,
                                          9.0)[0]
    _all_highest(_dot_precisions(fn, x))
    assert float(fn(x)) == pytest.approx(73.3333, abs=1e-3)


def test_fastica_contractions():
    from vhr_tpu.dsp import ica

    rng = np.random.default_rng(4)
    X = jnp.asarray(rng.normal(size=(300, 3)), jnp.float32)
    w = ica.default_w_init(3, 0)
    _all_highest(_dot_precisions(lambda a: ica.fastica(a, w).sources, X))


def test_projection_contractions():
    from vhr_tpu.dsp import projections

    rng = np.random.default_rng(5)
    bgr = jnp.asarray(120.0 + rng.normal(size=(200, 3)), jnp.float32)
    valid = jnp.ones((200,), bool)
    _all_highest(_dot_precisions(
        lambda b: projections.omit_pulse(b, valid, 30.0), bgr))


@pytest.mark.gpu
def test_roi_means_exact_on_gpu(gpu_backend):
    """On the card, where a default-precision float32 contraction may run in
    TF32, the 1080p full-frame means still match float64 numpy."""
    from vhr_tpu.ops import reduce as vreduce

    fr = _frame_1080p(6)
    rois = np.array([[0, 0, 1920, 1080]], np.int32)
    m, _ = jax.jit(vreduce.roi_channel_means)(
        jax.device_put(fr, gpu_backend), jax.device_put(rois, gpu_backend))
    ref = fr[0].reshape(-1, 3).astype(np.float64).mean(0)
    np.testing.assert_allclose(np.asarray(m)[0], ref, rtol=0, atol=1e-3)
