"""Single configuration surface for the whole framework.

The reference scatters its knobs across module-level constants with three
*different* heart-rate bands (``rppg_VIDEO.py:33-34`` = 0.7-2.0 Hz,
``rppg_LIVESTREAM.py:34-35`` = 0.667-2.5 Hz,
``analysis/utils/estimate_bpm.py:6-7`` = 0.667-3.333 Hz), two window
configurations (``analysis/measurement/green_avg.py:7-8`` = 30 s window /
10 s acquisition; ``analysis/measurement/ica.py:10-11`` = 10 s / 5 s) and
hard-coded ROI ratios (``analysis/utils/roi.py:13-15``,
``rppg_VIDEO.py:102-103``).  Here every knob lives in one frozen dataclass
tree so a pipeline is fully described by a single hashable value that can be
closed over by ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HRBand:
    """Physiological heart-rate passband in Hz."""

    low_hz: float
    high_hz: float

    @property
    def low_bpm(self) -> float:
        return self.low_hz * 60.0

    @property
    def high_bpm(self) -> float:
        return self.high_hz * 60.0


# The reference's three band choices (see module docstring).
BAND_VIDEO = HRBand(0.7, 2.0)            # rppg_VIDEO.py:33-34
BAND_LIVE = HRBand(40.0 / 60.0, 150.0 / 60.0)   # rppg_LIVESTREAM.py:34-35
BAND_ANALYSIS = HRBand(40.0 / 60.0, 200.0 / 60.0)  # estimate_bpm.py:6-7


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """ROI sub-rectangle ratios inside the face bounding box.

    Mirrors ``analysis/utils/roi.py:13-15`` (cheek) and
    ``rppg_VIDEO.py:102-103`` (forehead + cheek).
    """

    cheek_horizontal: float = 0.15
    cheek_top: float = 0.40
    cheek_bottom: float = 0.65
    forehead_horizontal: float = 0.25
    forehead_top: float = 0.00
    forehead_bottom: float = 0.25
    # If detection drops, reuse the last landmarks for this many frames
    # (analysis/utils/roi.py:10).
    landmark_hold_frames: int = 15


@dataclasses.dataclass(frozen=True)
class WelchConfig:
    """Welch PSD estimator settings (rppg_VIDEO.py:186-187)."""

    segment_seconds: float = 9.0
    overlap_fraction: float = 0.5


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Temporal bandpass filter settings (rppg_VIDEO.py:241-289)."""

    kind: str = "butterworth"  # butterworth | cheby2 | fir
    order: int = 2
    fir_numtaps: int = 41
    cheby2_stop_atten_db: float = 40.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full rPPG pipeline configuration."""

    band: HRBand = BAND_ANALYSIS
    window_seconds: float = 30.0        # green_avg.py:7
    acquisition_seconds: float = 10.0   # green_avg.py:8
    welch: WelchConfig = WelchConfig()
    filter: FilterConfig = FilterConfig()
    roi: ROIConfig = ROIConfig()
    # Spectral estimator for the BPM peak pick: "fft" | "welch".
    estimator: str = "fft"
    # Channel used for the scalar pulse signal (BGR index 1 = green,
    # rppg_VIDEO.py:110).
    channel: int = 1
    # Measurement site inside the face box: "cheek" (the reference's
    # measured ROI, analysis/utils/roi.py:53-59) or "forehead" (the second
    # ROI rppg_VIDEO.py:102 draws but never measures).
    roi_site: str = "cheek"

    def window_len(self, fps: float) -> int:
        return int(self.window_seconds * fps)

    def acquisition_len(self, fps: float) -> int:
        return int(self.acquisition_seconds * fps)


@dataclasses.dataclass(frozen=True)
class ICAConfig:
    """FastICA settings mirroring ``analysis/measurement/ica.py:36-44``."""

    n_components: int = 3
    max_iter: int = 300
    tol: float = 1e-6
    window_seconds: float = 10.0        # ica.py:10
    acquisition_seconds: float = 5.0    # ica.py:11
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EVMConfig:
    """Eulerian color magnification settings.

    The reference only has a dead stub of this path (``rppg_VIDEO.py:120-124``
    + README mention); these defaults follow the classic Wu et al. color
    magnification recipe.
    """

    pyramid_levels: int = 4
    amplification: float = 50.0
    band: HRBand = HRBand(0.83, 1.0)
    attenuate_chroma: float = 1.0


DEFAULT_CONFIG = PipelineConfig()
