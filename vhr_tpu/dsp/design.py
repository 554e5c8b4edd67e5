"""First-party digital filter *design* in pure NumPy.

The reference delegates filter design to ``scipy.signal`` (``sp.butter`` /
``sp.cheby2`` / ``sp.firwin`` at ``rppg_VIDEO.py:252,266,284`` and
``rppg_LIVESTREAM.py:218``).  Design is a tiny one-time host computation, so
we implement it from first principles here (analog prototype -> band
transform -> bilinear transform -> second-order sections) and golden-test the
results against scipy.  Filter *application* runs on the device (see
``vhr_tpu.dsp.filters``).

All frequencies below are normalized to the Nyquist frequency (as in the
reference: ``low = freq_lo / (0.5 * fps)``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "butter_bandpass_sos",
    "cheby2_bandpass_sos",
    "firwin_bandpass",
    "sos_design",
    "lfilter_zi",
    "sosfilt_zi",
    "filtfilt_padlen",
    "sosfiltfilt_padlen",
]


# ---------------------------------------------------------------------------
# Analog prototypes (zeros, poles, gain)
# ---------------------------------------------------------------------------

def _buttap(order: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Analog Butterworth lowpass prototype (wc = 1 rad/s)."""
    m = np.arange(-order + 1, order, 2)
    poles = -np.exp(1j * np.pi * m / (2 * order))
    zeros = np.array([], dtype=complex)
    return zeros, poles, 1.0


def _cheb2ap(order: int, rs_db: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Analog Chebyshev type-II lowpass prototype (stopband edge = 1 rad/s)."""
    de = 1.0 / np.sqrt(10 ** (0.1 * rs_db) - 1)
    mu = np.arcsinh(1.0 / de) / order

    if order % 2:
        m = np.concatenate((np.arange(-order + 1, 0, 2), np.arange(2, order, 2)))
    else:
        m = np.arange(-order + 1, order, 2)
    zeros = -np.conjugate(1j / np.sin(m * np.pi / (2.0 * order)))

    p = -np.exp(1j * np.pi * np.arange(-order + 1, order, 2) / (2.0 * order))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    poles = 1.0 / p

    k = (np.prod(-poles) / np.prod(-zeros)).real
    return zeros, poles, k


# ---------------------------------------------------------------------------
# Frequency transforms
# ---------------------------------------------------------------------------

def _lp2bp_zpk(zeros, poles, gain, wo: float, bw: float):
    """Lowpass (wc=1) -> bandpass (center wo, bandwidth bw), analog domain."""
    degree = len(poles) - len(zeros)
    z_lp = zeros * bw / 2.0
    p_lp = poles * bw / 2.0

    z_bp = np.concatenate(
        (z_lp + np.sqrt(z_lp**2 - wo**2), z_lp - np.sqrt(z_lp**2 - wo**2))
    )
    p_bp = np.concatenate(
        (p_lp + np.sqrt(p_lp**2 - wo**2), p_lp - np.sqrt(p_lp**2 - wo**2))
    )
    z_bp = np.append(z_bp, np.zeros(degree))
    k_bp = gain * bw**degree
    return z_bp, p_bp, k_bp


def _bilinear_zpk(zeros, poles, gain, fs: float):
    """Analog -> digital via the bilinear transform."""
    degree = len(poles) - len(zeros)
    fs2 = 2.0 * fs
    z_z = (fs2 + zeros) / (fs2 - zeros)
    p_z = (fs2 + poles) / (fs2 - poles)
    z_z = np.append(z_z, -np.ones(degree))
    k_z = gain * np.real(np.prod(fs2 - zeros) / np.prod(fs2 - poles))
    return z_z, p_z, k_z


# ---------------------------------------------------------------------------
# zpk -> second-order sections
# ---------------------------------------------------------------------------

def _poly_from_roots(roots: np.ndarray) -> np.ndarray:
    p = np.array([1.0 + 0j])
    for r in roots:
        p = np.convolve(p, np.array([1.0, -r]))
    return p


def _pop_nearest(pool: list, target: complex) -> complex:
    idx = int(np.argmin([abs(c - target) for c in pool]))
    return pool.pop(idx)


def _pop_conjugate(pool: list, value: complex) -> complex:
    idx = int(np.argmin([abs(c - np.conj(value)) for c in pool]))
    return pool.pop(idx)


def _is_real(c: complex, tol: float = 1e-10) -> bool:
    return abs(c.imag) <= tol * max(1.0, abs(c))


def zpk2sos(zeros, poles, gain) -> np.ndarray:
    """Convert zeros/poles/gain to cascaded biquads (``(S, 6)`` array).

    Nearest-pairing heuristic in the spirit of scipy's ``zpk2sos``: sections
    are built starting from the pole pair closest to the unit circle, each
    paired with its nearest zeros; sections are returned so the best-damped
    section comes first and the overall gain is folded into the first
    section.  Requires an even number of poles with ``len(z) <= len(p)``
    (always true for the bandpass designs this framework uses).
    """
    z_pool = list(np.asarray(zeros, dtype=complex))
    p_pool = list(np.asarray(poles, dtype=complex))
    if len(z_pool) > len(p_pool):
        raise ValueError("more zeros than poles is unsupported")
    if len(p_pool) % 2:
        raise ValueError("odd number of poles is unsupported")

    sections = []
    while p_pool:
        # Pole (pair) closest to the unit circle -> handled in the *last*
        # applied section for numerical robustness.
        idx = int(np.argmin([abs(1.0 - abs(c)) for c in p_pool]))
        p1 = p_pool.pop(idx)
        if _is_real(p1):
            # Pair with the nearest remaining real pole.
            reals = [c for c in p_pool if _is_real(c)]
            if not reals:
                raise ValueError("unpaired real pole")
            p2 = _pop_nearest(p_pool, p1.real)
        else:
            p2 = _pop_conjugate(p_pool, p1)

        sec_z = []
        for _ in range(2):
            if not z_pool:
                break
            if sec_z and not _is_real(sec_z[0]):
                sec_z.append(_pop_conjugate(z_pool, sec_z[0]))
            else:
                z1 = _pop_nearest(z_pool, p1)
                sec_z.append(z1)
                if not _is_real(z1):
                    sec_z.append(_pop_conjugate(z_pool, z1))
                    break

        b = _poly_from_roots(np.array(sec_z)).real
        a = _poly_from_roots(np.array([p1, p2])).real
        b = np.pad(b, (0, 3 - len(b)))
        a = np.pad(a, (0, 3 - len(a)))
        sections.append(np.concatenate([b, a]))

    sos = np.array(sections[::-1], dtype=np.float64)
    sos[0, :3] *= gain
    return sos


# ---------------------------------------------------------------------------
# Public designers
# ---------------------------------------------------------------------------

def _warp_band(low: float, high: float) -> Tuple[float, float]:
    """Pre-warp normalized (0..1) band edges for the bilinear transform."""
    if not (0.0 < low < high < 1.0):
        raise ValueError(f"band edges must satisfy 0 < low < high < 1, got {low}, {high}")
    fs = 2.0
    w1 = 2.0 * fs * np.tan(np.pi * low / fs)
    w2 = 2.0 * fs * np.tan(np.pi * high / fs)
    return w1, w2


def butter_bandpass_sos(order: int, low: float, high: float) -> np.ndarray:
    """Digital Butterworth bandpass in SOS form.

    Equivalent to ``scipy.signal.butter(order, [low, high], btype='band',
    output='sos')`` as used at ``rppg_VIDEO.py:252``.
    """
    w1, w2 = _warp_band(low, high)
    z, p, k = _buttap(order)
    z, p, k = _lp2bp_zpk(z, p, k, wo=np.sqrt(w1 * w2), bw=w2 - w1)
    z, p, k = _bilinear_zpk(z, p, k, fs=2.0)
    return zpk2sos(z, p, k)


def cheby2_bandpass_sos(order: int, rs_db: float, low: float, high: float) -> np.ndarray:
    """Digital Chebyshev-II bandpass in SOS form (``rppg_VIDEO.py:284``)."""
    w1, w2 = _warp_band(low, high)
    z, p, k = _cheb2ap(order, rs_db)
    z, p, k = _lp2bp_zpk(z, p, k, wo=np.sqrt(w1 * w2), bw=w2 - w1)
    z, p, k = _bilinear_zpk(z, p, k, fs=2.0)
    return zpk2sos(z, p, k)


def firwin_bandpass(numtaps: int, low: float, high: float) -> np.ndarray:
    """Hamming-windowed FIR bandpass taps.

    Equivalent to ``scipy.signal.firwin(numtaps, [low, high],
    pass_zero=False, window='hamming')`` as used at ``rppg_VIDEO.py:266``.
    """
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = high * np.sinc(high * m) - low * np.sinc(low * m)

    n = np.arange(numtaps, dtype=np.float64)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (numtaps - 1))
    h *= win

    # Normalize unit gain at the passband center (pass_zero=False branch of
    # scipy's scaling rule).
    f_scale = (low + high) / 2.0
    c = np.cos(np.pi * m * f_scale)
    h /= np.sum(h * c)
    return h


def sos_design(kind: str, fps: float, low_hz: float, high_hz: float,
               order: int, rs_db: float = 40.0) -> np.ndarray:
    """Convenience wrapper: physical Hz in, SOS out."""
    nyq = 0.5 * fps
    low, high = low_hz / nyq, high_hz / nyq
    if kind == "butterworth":
        return butter_bandpass_sos(order, low, high)
    if kind == "cheby2":
        return cheby2_bandpass_sos(order, rs_db, low, high)
    raise ValueError(f"unknown IIR kind: {kind!r}")


# ---------------------------------------------------------------------------
# Initial conditions for zero-phase filtering
# ---------------------------------------------------------------------------

def _companion(a: np.ndarray) -> np.ndarray:
    n = len(a)
    c = np.zeros((n - 1, n - 1), dtype=np.float64)
    c[0, :] = -a[1:] / a[0]
    c[np.arange(1, n - 1), np.arange(0, n - 2)] = 1.0
    return c


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions for a step input (scipy semantics)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    IminusA = np.eye(n - 1) - _companion(a).T
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(IminusA, B)


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Per-section steady-state initial conditions, shape ``(S, 2)``."""
    sos = np.asarray(sos, dtype=np.float64)
    zi = np.empty((sos.shape[0], 2), dtype=np.float64)
    scale = 1.0
    for s in range(sos.shape[0]):
        b, a = sos[s, :3], sos[s, 3:]
        zi[s] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def filtfilt_padlen(b: np.ndarray, a: np.ndarray) -> int:
    """Default edge padding of ``scipy.signal.filtfilt``."""
    return 3 * max(len(np.atleast_1d(a)), len(np.atleast_1d(b)))


def sosfiltfilt_padlen(sos: np.ndarray) -> int:
    """Default edge padding of ``scipy.signal.sosfiltfilt``."""
    sos = np.asarray(sos)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return int(3 * ntaps)
