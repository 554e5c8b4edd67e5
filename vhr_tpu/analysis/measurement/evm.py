"""EVM measurement: detection-free Eulerian pulse extraction.

The reference only sketched this path (``README.md`` EVM mention + the dead
``bgr2yiq`` stub); here it is a working measurement plugin: Gaussian-pyramid
coarse level, temporal ideal bandpass, whole-frame pooled YIQ pulse, rolling
multichannel FFT peak — no face detector anywhere in the loop.
"""

from __future__ import annotations

import numpy as np

from ...config import BAND_ANALYSIS, HRBand, PipelineConfig
from ...io import video as vio
from ...pipeline import evm, offline

WINDOW_SIZE = 30.0
ACQUISITION_TIME = 10.0
LEVELS = 3


def measure(video_path: str) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from ...dsp import spectral
    from ...ops import windows as vwin

    frames, fps = vio.read_video(video_path)
    T = frames.shape[0]
    if T == 0:
        return np.empty((0, 2))
    sig = evm.magnified_pulse(jnp.asarray(frames), fps,
                              HRBand(0.65, 3.4), levels=LEVELS)  # (T, 3)

    window_len = int(WINDOW_SIZE * fps)
    acq_len = int(ACQUISITION_TIME * fps)
    wins_start = min(window_len, T)
    ts = np.arange(T) / fps
    bpm = np.zeros(T, np.float32)
    valid = np.zeros(T, bool)

    # Rolling multichannel estimate over the pulse trace (steady windows as
    # one batch; ramp windows via the exact masked DFT).
    first = acq_len - 1
    if first >= T:
        return np.empty((0, 2))
    ramp_end = min(window_len - 1, T - 1)
    if ramp_end >= first:
        lengths = jnp.arange(first + 1, ramp_end + 2)
        prefix = sig[: ramp_end + 1]
        est = jax.vmap(lambda nv: spectral.estimate_bpm_multichannel_exact(
            jnp.where((jnp.arange(prefix.shape[0]) < nv)[:, None], prefix,
                      0.0),
            nv, fps, BAND_ANALYSIS))(lengths)
        bpm[first:ramp_end + 1] = np.asarray(est.bpm)
        valid[first:ramp_end + 1] = np.asarray(est.valid)
    if T >= window_len:
        wins = vwin.sliding_windows(sig, window_len)          # (N, W, 3)
        est = spectral.estimate_bpm_multichannel(wins, fps, BAND_ANALYSIS)
        bpm[window_len - 1:] = np.asarray(est.bpm)
        valid[window_len - 1:] = np.asarray(est.valid)

    return offline.to_measurement_array(ts, bpm, valid)
