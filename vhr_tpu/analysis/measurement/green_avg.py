"""Canonical measurement: cheek-ROI green mean -> rolling FFT BPM.

Contract parity with ``analysis/measurement/green_avg.py`` (30 s rolling
window, 10 s acquisition, per-frame timestamps, (N, 2) result), executed as
the batched JAX pipeline (``vhr_tpu.pipeline.offline.measure_green_avg``).
"""

from __future__ import annotations

import numpy as np

from ...config import PipelineConfig
from ...io import video as vio
from ...pipeline import offline

WINDOW_SIZE = 30.0
ACQUISITION_TIME = 10.0


def measure(video_path: str) -> np.ndarray:
    import jax.numpy as jnp
    frames, fps = vio.read_video(video_path)
    if frames.shape[0] == 0:
        return np.empty((0, 2))
    cfg = PipelineConfig(window_seconds=WINDOW_SIZE,
                         acquisition_seconds=ACQUISITION_TIME)
    from .. import context
    ts, bpm, valid = offline.measure_green_avg(
        jnp.asarray(frames), fps, cfg,
        detector=context.current_detector(),
        detect_every=context.current_detect_every())
    return offline.to_measurement_array(ts, bpm, valid)
