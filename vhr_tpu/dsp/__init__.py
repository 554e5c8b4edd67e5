"""DSP core: filter design (host numpy) + filtering/spectral/ICA on device."""

from . import design, filters, ica, projections, spectral  # noqa: F401
