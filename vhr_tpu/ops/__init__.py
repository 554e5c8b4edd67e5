"""Batched image/ROI ops: geometry, reductions, color, windowed BPM."""

from . import reduce, roi  # noqa: F401
