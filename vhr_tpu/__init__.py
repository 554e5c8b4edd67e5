"""vhr_tpu — a remote-photoplethysmography (rPPG) framework in JAX.

The package name is historical; it runs wherever JAX does and is measured
on NVIDIA GPUs (``chip_smoke.py``).  A ground-up JAX/XLA re-design of the capabilities of
AngaBlue/video-heart-rate: video in, heart-rate (BPM) trace out.  Where the
reference is a frame-at-a-time Python loop over MediaPipe + OpenCV + scipy,
this framework treats video as a ``(streams, T, H, W, 3)`` array program:
batched face localization, a masked ROI reduction, scanned temporal
bandpass filters, and windowed FFT/Welch peak picking — all under ``jit``,
scaled over device meshes with ``shard_map``.  A serving layer
(``vhr_tpu.serving``) multiplexes many live TCP camera clients onto one
batched device dispatch per tick.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import (  # noqa: F401
    BAND_ANALYSIS,
    BAND_LIVE,
    BAND_VIDEO,
    DEFAULT_CONFIG,
    EVMConfig,
    FilterConfig,
    HRBand,
    ICAConfig,
    PipelineConfig,
    ROIConfig,
    WelchConfig,
)
