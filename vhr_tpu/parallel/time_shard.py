"""Time-axis (sequence) parallelism with halo exchange for long recordings.

The reference's long-context limiter is eager whole-video RAM
(``analysis/utils/video_io.py:26-31``); its longest signal is a 1000-sample
deque.  For hour-scale recordings this module shards the *time* axis across
chips: zero-phase IIR filtering has a global sequential dependency, but its
influence decays exponentially, so each shard filters its chunk extended by
``halo`` neighbor samples (exchanged with ``ppermute``) and keeps
the interior — embarrassingly parallel after one neighbor exchange, with
error below float tolerance once ``halo`` covers the filter's effective
impulse response (SURVEY.md §5 long-context plan).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..dsp import filters

__all__ = ["halo_sosfiltfilt", "default_halo"]


def default_halo(sos: np.ndarray, attenuation_db: float = 180.0) -> int:
    """Halo length covering the filter's effective impulse response.

    Estimated from the slowest pole radius: the transient decays like
    ``r^n``, so ``n = ln(10^(-A/20)) / ln(r)`` samples reach ``A`` dB down.
    """
    sos = np.asarray(sos, dtype=np.float64)
    radii = []
    for s in range(sos.shape[0]):
        roots = np.roots(sos[s, 3:])
        radii.extend(np.abs(roots))
    r = float(np.clip(np.max(radii), 1e-6, 0.999999))
    n = np.log(10.0 ** (-attenuation_db / 20.0)) / np.log(r)
    return int(np.ceil(n))


def halo_sosfiltfilt(sos: np.ndarray, x: jnp.ndarray, mesh: Mesh,
                     axis_name: str = "time",
                     halo: Optional[int] = None) -> jnp.ndarray:
    """Zero-phase SOS filtering of a time-sharded ``(T, ...)`` signal.

    ``x`` is sharded over ``axis_name`` along axis 0.  Each shard gathers
    ``halo`` trailing samples from its left neighbor and ``halo`` leading
    samples from its right neighbor via ``ppermute`` (one hop each way),
    zero-phase-filters the extended chunk locally, and returns its interior.
    Interior values match unsharded ``sosfiltfilt`` to float tolerance.
    """
    n_shards = mesh.shape[axis_name]
    if halo is None:
        # A halo cannot exceed the local chunk (one neighbor exchange).
        halo = min(default_halo(sos), x.shape[0] // n_shards)
    if n_shards == 1:
        return filters.sosfiltfilt(sos, x)

    def body(xl):
        # xl: (T_local, ...) local chunk.
        idx = jax.lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        left = jax.lax.ppermute(xl[-halo:], axis_name, fwd)
        right = jax.lax.ppermute(xl[:halo], axis_name, bwd)
        # Interior shards: filter the halo-extended chunk, keep the middle.
        y_mid = filters.sosfiltfilt(
            sos, jnp.concatenate([left, xl, right], axis=0))[halo:-halo]
        # Edge shards re-filter with the *true* boundary on their open side,
        # so the global scipy boundary condition (padlen odd extension +
        # zi-scaled state) is reproduced bit-for-bit.
        y_first = filters.sosfiltfilt(
            sos, jnp.concatenate([xl, right], axis=0))[:xl.shape[0]]
        y_last = filters.sosfiltfilt(
            sos, jnp.concatenate([left, xl], axis=0))[halo:]
        y = jnp.where(idx == 0, y_first,
                      jnp.where(idx == n_shards - 1, y_last, y_mid))
        return y

    return shard_map(body, mesh=mesh, in_specs=(P(axis_name),),
                     out_specs=P(axis_name), check_vma=False)(x)
