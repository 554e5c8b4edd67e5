"""Eulerian color magnification (EVM) — the working version of the
reference's dead stub.

The reference planned but never implemented this path (broken ``bgr2yiq``
stub at ``rppg_VIDEO.py:120-124``, README mention).  Classic Wu et al. color
magnification as one array program:

  uint8 BGR -> YIQ -> Gaussian pyramid (separable binomial convs, stride
  2) -> ideal temporal bandpass on the coarsest level (one
  ``rfft``/``irfft`` over the whole time axis — no per-frame IIR state) ->
  amplify (chroma-attenuated) -> upsample -> add -> uint8 BGR.

Everything is a single jitted program over the ``(T, H, W, 3)`` tensor.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EVMConfig, HRBand
from ..ops import color

__all__ = ["gaussian_downsample", "gaussian_pyramid_level",
           "temporal_ideal_bandpass", "magnify", "magnified_pulse"]

_BINOMIAL = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _sep_conv(x: jnp.ndarray, axis: int, stride: int) -> jnp.ndarray:
    """Binomial 5-tap filter along ``axis`` of ``(T, H, W, C)``, edge-padded."""
    k = jnp.asarray(_BINOMIAL, x.dtype)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (2, 2)
    xp = jnp.pad(x, pad, mode="edge")
    # conv via gather-free shifted adds (5 taps): cheaper to express than
    # conv_general for this tiny separable kernel, and XLA fuses the adds.
    idx = [slice(None)] * x.ndim
    out = None
    for tap in range(5):
        sl = list(idx)
        sl[axis] = slice(tap, tap + x.shape[axis])
        term = k[tap] * xp[tuple(sl)]
        out = term if out is None else out + term
    if stride > 1:
        sl = list(idx)
        sl[axis] = slice(0, None, stride)
        out = out[tuple(sl)]
    return out


def gaussian_downsample(x: jnp.ndarray) -> jnp.ndarray:
    """One pyramid level: blur + 2x decimate in H and W of ``(T, H, W, C)``."""
    return _sep_conv(_sep_conv(x, axis=1, stride=2), axis=2, stride=2)


def gaussian_pyramid_level(x: jnp.ndarray, levels: int) -> jnp.ndarray:
    for _ in range(levels):
        x = gaussian_downsample(x)
    return x


def temporal_ideal_bandpass(x: jnp.ndarray, fps: float, band: HRBand
                            ) -> jnp.ndarray:
    """Zero out temporal-frequency content outside ``band`` (axis 0)."""
    T = x.shape[0]
    freqs = np.fft.rfftfreq(T, d=1.0 / fps)
    keep = jnp.asarray(((freqs >= band.low_hz) & (freqs <= band.high_hz))
                       .astype(np.float32))
    X = jnp.fft.rfft(x, axis=0)
    shape = (len(freqs),) + (1,) * (x.ndim - 1)
    X = X * keep.reshape(shape)
    return jnp.fft.irfft(X, n=T, axis=0).astype(x.dtype)


@functools.partial(jax.jit, static_argnames=("fps", "cfg"))
def magnify(frames: jnp.ndarray, fps: float,
            cfg: EVMConfig = EVMConfig()) -> jnp.ndarray:
    """Amplify subtle color oscillations in the EVM band.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
    Returns:
      magnified ``(T, H, W, 3)`` uint8 BGR.
    """
    T, H, W, _ = frames.shape
    gains = jnp.asarray([cfg.amplification,
                         cfg.amplification * cfg.attenuate_chroma,
                         cfg.amplification * cfg.attenuate_chroma],
                        jnp.float32)
    yiq = color.bgr_u8_to_yiq(frames)
    low = gaussian_pyramid_level(yiq, cfg.pyramid_levels)
    band = temporal_ideal_bandpass(low, fps, cfg.band)
    band = band * gains
    up = jax.image.resize(band, (T, H, W, 3), "linear")
    return color.yiq_to_bgr_u8(yiq + up)


def magnified_pulse(frames: jnp.ndarray, fps: float, band: HRBand,
                    levels: int = 4) -> jnp.ndarray:
    """The EVM analysis signal: spatial mean of the band-passed coarse level's
    luminance+chroma per frame, shape ``(T, 3)`` — a pulse trace that needs
    no face detection (whole-frame Eulerian pooling).
    """
    yiq = color.bgr_u8_to_yiq(frames)
    low = gaussian_pyramid_level(yiq, levels)
    bp = temporal_ideal_bandpass(low, fps, band)
    return jnp.mean(bp, axis=(1, 2))
