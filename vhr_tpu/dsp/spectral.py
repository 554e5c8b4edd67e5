"""Spectral BPM estimation: FFT peak picking and Welch PSD.

A batched re-design of the reference's three estimators:

* ``analysis/utils/estimate_bpm.py:12-82`` — multichannel FFT peak in a
  physiological band, best channel wins;
* ``rppg_VIDEO.py:129-168`` — single-channel FFT variant;
* ``rppg_VIDEO.py:172-235`` / ``rppg_LIVESTREAM.py:133-196`` — Welch PSD
  (9 s Hann segments, 50% overlap, constant detrend, density scaling, mean
  average).

Everything here is pure, statically-shaped, and batched: the reference's
``None`` returns become a ``valid`` mask so the functions compose under
``jit``/``vmap``/``shard_map``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HRBand

# The explicit DFT ramp multiplies unit-scale trig rows into pixel-scale
# signals; TF32 would keep only ~11 bits of each product, so it is exact f32.
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "BPMEstimate",
    "estimate_bpm",
    "estimate_bpm_multichannel",
    "welch_psd",
    "estimate_bpm_welch",
    "bpm_peak_from_spectrum",
    "band_snr",
]


class BPMEstimate(NamedTuple):
    """Batched BPM result; ``valid`` is False where the reference returns None."""

    bpm: jnp.ndarray
    valid: jnp.ndarray
    peak_power: jnp.ndarray


def _band_freqs(n: int, fs: float, band: HRBand) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side positive FFT frequencies and in-band mask (static shapes).

    The reference masks ``np.fft.fftfreq`` frequencies, where the Nyquist bin
    of an even-length FFT is stored as ``-fs/2`` and therefore never passes a
    positive band mask (``estimate_bpm.py:38-44``).  ``rfftfreq`` returns it
    as ``+fs/2``, so drop the last bin for even ``n`` to match — this bites
    whenever ``fs <= 2*high_hz`` (e.g. the 5 fps temporal-resolution preset).
    """
    freqs = np.fft.rfftfreq(n, d=1.0 / fs)
    mask = (freqs >= band.low_hz) & (freqs <= band.high_hz)
    mask &= np.arange(freqs.shape[0]) <= (n - 1) // 2
    return freqs, mask


def bpm_peak_from_spectrum(power: jnp.ndarray, freqs: np.ndarray,
                           mask: np.ndarray) -> BPMEstimate:
    """Pick the dominant in-band frequency from a ``(..., F)`` power array."""
    freqs_j = jnp.asarray(freqs, dtype=power.dtype)
    mask_j = jnp.asarray(mask)
    neg = jnp.asarray(-jnp.inf, dtype=power.dtype)
    banded = jnp.where(mask_j, power, neg)
    idx = jnp.argmax(banded, axis=-1)
    peak = jnp.take_along_axis(banded, idx[..., None], axis=-1)[..., 0]
    bpm = freqs_j[idx] * 60.0
    valid = jnp.full(bpm.shape, bool(mask.any()))
    return BPMEstimate(bpm=bpm, valid=valid, peak_power=peak)


def estimate_bpm(signal: jnp.ndarray, fs: float, band: HRBand) -> BPMEstimate:
    """Single-channel FFT peak pick over axis -1.

    Mirrors ``estimate_bpm`` (``rppg_VIDEO.py:129-168``) for ``(..., T)``
    batches.  The reference masks ``freqs >= low & freqs <= high`` over the
    full-FFT frequencies; positive rfft frequencies give the identical band.
    """
    n = signal.shape[-1]
    freqs, mask = _band_freqs(n, fs, band)
    spectrum = jnp.abs(jnp.fft.rfft(signal, axis=-1))
    est = bpm_peak_from_spectrum(spectrum, freqs, mask)
    if n < 8:  # reference: analysis/utils/estimate_bpm.py:31
        est = est._replace(valid=jnp.zeros_like(est.valid))
    return est


def band_snr(signal: jnp.ndarray, fs: float, band: HRBand,
             guard_bins: int = 1,
             target_bpm: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """In-band spectral SNR of ``(..., T)`` windows (power ratio, not dB).

    Signal quality in the classic rPPG sense (de Haan & Jeanne 2013 sec.
    IV): power in a peak neighborhood (± ``guard_bins`` bins) over the
    remaining in-band power.  With ``target_bpm=None`` the neighborhood
    centers on the window's own dominant in-band bin; passing a
    ``target_bpm`` (broadcastable to the leading shape) scores the
    neighborhood of *that* frequency instead — how much of the window's
    band energy backs a given hypothesis.  The self-peak form rewards any
    strong periodicity (a clean flicker scores high); the targeted form is
    what the adaptive selector uses, anchored to the cross-method
    consensus (``pipeline.offline.adaptive_pulse_select``).  No reference
    counterpart (the reference never scores its signals,
    ``analysis/utils/estimate_bpm.py``).
    """
    n = signal.shape[-1]
    freqs, mask = _band_freqs(n, fs, band)
    mask_j = jnp.asarray(mask)
    x = signal - jnp.mean(signal, axis=-1, keepdims=True)
    power = jnp.abs(jnp.fft.rfft(x, axis=-1)) ** 2
    banded = jnp.where(mask_j, power, 0.0)
    if target_bpm is None:
        idx = jnp.argmax(jnp.where(mask_j, power, -jnp.inf), axis=-1)
    else:
        # Nearest rfft bin to the hypothesis frequency: k = f * n / fs.
        idx = jnp.clip(jnp.round(target_bpm / 60.0 * n / fs),
                       0, power.shape[-1] - 1).astype(jnp.int32)
    bins = jnp.arange(power.shape[-1])
    near = jnp.abs(bins - idx[..., None]) <= guard_bins
    peak = jnp.sum(jnp.where(near, banded, 0.0), axis=-1)
    rest = jnp.sum(banded, axis=-1) - peak
    return peak / jnp.maximum(rest, 1e-12)


def estimate_bpm_multichannel(signal: jnp.ndarray, fs: float,
                              band: HRBand) -> BPMEstimate:
    """Multichannel FFT peak: per-channel peak, best channel wins.

    Mirrors ``analysis/utils/estimate_bpm.py:12-82`` for ``(..., T, C)``
    input: FFT along time, positive freqs only (strictly > 0), band mask,
    per-channel argmax, then the channel with the largest peak decides the
    BPM.
    """
    T = signal.shape[-2]
    freqs, mask = _band_freqs(T, fs, band)
    # The reference uses `freqs > 0` before the band mask; rfft includes the
    # DC bin, which the band mask already excludes for any low_hz > 0.
    mags = jnp.abs(jnp.fft.rfft(signal, axis=-2))          # (..., F, C)
    per_chan = bpm_peak_from_spectrum(
        jnp.moveaxis(mags, -2, -1), freqs, mask)            # (..., C)
    best = jnp.argmax(per_chan.peak_power, axis=-1)
    bpm = jnp.take_along_axis(per_chan.bpm, best[..., None], axis=-1)[..., 0]
    peak = jnp.take_along_axis(per_chan.peak_power, best[..., None], axis=-1)[..., 0]
    valid = jnp.full(bpm.shape, bool(mask.any()) and T >= 8)
    return BPMEstimate(bpm=bpm, valid=valid, peak_power=peak)


def estimate_bpm_multichannel_exact(signal: jnp.ndarray, n_valid,
                                    fs: float, band: HRBand) -> BPMEstimate:
    """Multichannel FFT peak on a zero-padded ``(T_pad, C)`` signal whose true
    length is the (possibly traced) scalar ``n_valid``.

    Evaluates the DFT on the *true* length-N frequency grid ``k*fs/N``
    explicitly, so one compiled program reproduces
    ``analysis/utils/estimate_bpm.py`` for every window length — the
    acquisition-ramp companion of :func:`estimate_bpm_multichannel`.
    Padded rows must be zero and the signal zero-mean over its valid rows
    (true for ICA sources).
    """
    T = signal.shape[-2]
    N = jnp.asarray(n_valid, signal.dtype)
    n = jnp.arange(T, dtype=signal.dtype)
    k_max = int(np.floor(band.high_hz * T / fs))
    k = jnp.arange(k_max + 1, dtype=signal.dtype)

    ang = (-2.0 * jnp.pi / N) * k[:, None] * n[None, :]     # (K, T)
    re = jnp.matmul(jnp.cos(ang), signal, precision=_HIGHEST)  # (K, C)
    im = jnp.matmul(jnp.sin(ang), signal, precision=_HIGHEST)
    mags = jnp.sqrt(re * re + im * im)

    freq = k * (fs / N)
    half = jnp.floor((N - 1.0) / 2.0)
    mask = ((freq >= band.low_hz) & (freq <= band.high_hz)
            & (k >= 1.0) & (k <= half))                     # (K,)
    neg = jnp.asarray(-jnp.inf, mags.dtype)
    banded = jnp.where(mask[:, None], mags, neg)            # (K, C)
    peak_idx = jnp.argmax(banded, axis=0)                   # (C,)
    peak_mag = jnp.take_along_axis(banded, peak_idx[None, :], axis=0)[0]
    best = jnp.argmax(peak_mag)
    bpm = freq[peak_idx[best]] * 60.0
    valid = jnp.logical_and(jnp.any(mask), N >= 8)
    return BPMEstimate(bpm=bpm, valid=valid, peak_power=peak_mag[best])


def _hann(n: int) -> np.ndarray:
    """Symmetric Hann window (scipy ``get_window('hann', n)`` is periodic —
    scipy.signal.welch uses ``sym=False``)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def welch_psd(x: jnp.ndarray, fs: float, nperseg: int,
              noverlap: Optional[int] = None,
              average: str = "mean"
              ) -> Tuple[np.ndarray, jnp.ndarray]:
    """Welch power spectral density over axis -1 for ``(..., T)`` batches.

    Matches ``scipy.signal.welch(x, fs, window='hann', nperseg, noverlap,
    detrend='constant', scaling='density', average=...)`` as called at
    ``rppg_VIDEO.py:190-193``.  ``average='median'`` is the reference's
    suggested noisy-signal alternative (comment at ``rppg_VIDEO.py:192``),
    with scipy's bias correction.  Implemented as framed+windowed ``rfft`` —
    one fused XLA program, no per-segment Python loop.

    Returns ``(freqs, psd)`` with host-side ``freqs``.
    """
    T = x.shape[-1]
    nperseg = int(min(nperseg, T))
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    n_segments = (T - noverlap) // step

    win = _hann(nperseg)
    win_j = jnp.asarray(win, dtype=x.dtype)

    # Frame: (..., n_segments, nperseg) via a static gather.
    starts = np.arange(n_segments) * step
    idx = starts[:, None] + np.arange(nperseg)[None, :]
    segs = x[..., idx]

    # detrend='constant': subtract per-segment mean.
    segs = segs - jnp.mean(segs, axis=-1, keepdims=True)
    segs = segs * win_j

    spec = jnp.fft.rfft(segs, axis=-1)
    psd = (spec.real**2 + spec.imag**2)

    scale = 1.0 / (fs * float(np.sum(win * win)))
    psd = psd * jnp.asarray(scale, dtype=x.dtype)
    # One-sided doubling (all bins except DC; Nyquist bin only if nperseg odd).
    nfreq = psd.shape[-1]
    doubling = np.ones(nfreq)
    if nperseg % 2 == 0:
        doubling[1:-1] = 2.0
    else:
        doubling[1:] = 2.0
    psd = psd * jnp.asarray(doubling, dtype=x.dtype)

    if average == "median":
        # scipy's median average with its bias correction
        # (_median_bias: 1 + sum over odd k < n of (-1)^(k+1)/k... for odd
        # counts; even counts use the two middle values).
        n_seg = psd.shape[-2]
        med = jnp.median(psd, axis=-2)
        ii = np.arange(1, (n_seg - 1) // 2 + 1)
        bias = 1.0 + np.sum(1.0 / (2 * ii + 1) - 1.0 / (2 * ii))
        psd = med / bias
    else:
        psd = jnp.mean(psd, axis=-2)  # average='mean' over segments
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / fs)
    return freqs, psd


def estimate_bpm_welch(signal: jnp.ndarray, fs: float, band: HRBand,
                       segment_seconds: float = 9.0) -> BPMEstimate:
    """Welch-PSD BPM estimate over axis -1 for ``(..., T)`` batches.

    Mirrors ``estimate_bpm_welch`` (``rppg_VIDEO.py:172-235``): demean, 9 s
    Hann segments with 50% overlap, in-band peak pick.
    """
    T = signal.shape[-1]
    x = signal - jnp.mean(signal, axis=-1, keepdims=True)
    nperseg = int(min(T, fs * segment_seconds))
    freqs, psd = welch_psd(x, fs, nperseg)
    mask = (freqs >= band.low_hz) & (freqs <= band.high_hz)
    return bpm_peak_from_spectrum(psd, freqs, mask)
