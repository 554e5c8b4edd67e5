"""EVM color magnification tests."""

import colorsys

import numpy as np
import pytest
import jax.numpy as jnp

from vhr_tpu.config import EVMConfig, HRBand
from vhr_tpu.ops import color
from vhr_tpu.pipeline import evm
from vhr_tpu.utils.synth import SynthSpec, synthesize


def test_yiq_roundtrip_matches_colorsys():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (50, 3))
    ours = np.asarray(color.rgb_to_yiq(jnp.asarray(rgb)))
    for i in range(50):
        ref = colorsys.rgb_to_yiq(*rgb[i])
        np.testing.assert_allclose(ours[i], ref, atol=1e-6)
    back = np.asarray(color.yiq_to_rgb(jnp.asarray(ours)))
    np.testing.assert_allclose(back, rgb, atol=1e-5)


def test_bgr_u8_roundtrip():
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (4, 8, 8, 3), np.uint8)
    yiq = color.bgr_u8_to_yiq(jnp.asarray(frames))
    back = np.asarray(color.yiq_to_bgr_u8(yiq))
    assert np.abs(back.astype(int) - frames.astype(int)).max() <= 1


def test_gaussian_downsample_halves_and_smooths():
    x = jnp.asarray(np.random.default_rng(2).normal(size=(2, 32, 48, 3)),
                    jnp.float32)
    y = evm.gaussian_downsample(x)
    assert y.shape == (2, 16, 24, 3)
    assert float(jnp.var(y)) < float(jnp.var(x))  # low-pass


def test_temporal_bandpass_isolates_band():
    fps = 30.0
    t = np.arange(300) / fps
    x = (np.sin(2 * np.pi * 1.0 * t) + np.sin(2 * np.pi * 5.0 * t)
         + 3.0)[:, None, None, None].astype(np.float32)
    y = np.asarray(evm.temporal_ideal_bandpass(
        jnp.asarray(x), fps, HRBand(0.8, 1.2)))[:, 0, 0, 0]
    # The 1 Hz component survives; DC and 5 Hz vanish.
    spec = np.abs(np.fft.rfft(y))
    freqs = np.fft.rfftfreq(300, 1 / fps)
    assert spec[np.argmin(np.abs(freqs - 1.0))] > 100.0
    assert spec[0] < 1e-3
    assert spec[np.argmin(np.abs(freqs - 5.0))] < 1e-3


def test_magnify_amplifies_pulse():
    spec = SynthSpec(duration_s=10.0, bpm=60.0, height=64, width=64,
                     pulse_amplitude=1.0, noise_std=0.0)
    clip = synthesize(spec)
    cfg = EVMConfig(pyramid_levels=2, amplification=20.0,
                    band=HRBand(0.8, 1.2))
    out = np.asarray(evm.magnify(jnp.asarray(clip.frames), clip.fps, cfg))
    assert out.shape == clip.frames.shape and out.dtype == np.uint8

    def pulse_amplitude(frames):
        g = frames[:, 24:40, 24:40, 1].astype(np.float64).mean(axis=(1, 2))
        spec = np.abs(np.fft.rfft(g - g.mean()))
        freqs = np.fft.rfftfreq(len(g), 1 / clip.fps)
        return spec[np.argmin(np.abs(freqs - 1.0))]

    amp_in = pulse_amplitude(clip.frames)
    amp_out = pulse_amplitude(out)
    assert amp_out > 5.0 * amp_in, (amp_in, amp_out)


def test_magnified_pulse_recovers_bpm():
    clip = synthesize(SynthSpec(duration_s=20.0, bpm=90.0, height=64,
                                width=64, pulse_amplitude=1.5, noise_std=0.3))
    sig = np.asarray(evm.magnified_pulse(jnp.asarray(clip.frames), clip.fps,
                                         HRBand(0.7, 3.0), levels=2))
    from vhr_tpu.dsp import spectral
    from vhr_tpu.config import BAND_ANALYSIS
    est = spectral.estimate_bpm_multichannel(jnp.asarray(sig), clip.fps,
                                             BAND_ANALYSIS)
    assert abs(float(est.bpm) - 90.0) <= 4.0

