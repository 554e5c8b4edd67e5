"""Offline analysis harness: degradation x measurement sweeps + metrics.

Parity surface for the reference's ``analysis/`` package and its three
plugin contracts (``analysis/README.md``):

* degradation: ``apply(video_path) -> iterator of (degraded_path, label)``
* measurement: ``measure(video_path) -> np.ndarray (N, 2) [t_sec, bpm]``
* metric: ``plot(truth, results, x_label, output_dir)``

with a proper registry (``vhr_tpu.analysis.registry``) instead of
``sys.path`` tricks, pixel-domain degradations running batched on the device, and
measurements backed by the jitted pipelines.
"""

from . import registry  # noqa: F401
