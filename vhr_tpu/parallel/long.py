"""Long-recording BPM over a time-sharded signal (sequence parallelism).

Completes the SURVEY.md §5 long-context plan end to end: an hour-scale green
trace is sharded over the ``time`` mesh axis; each device receives a
``window_len - 1`` halo from its left neighbor (one ``ppermute``)
and computes its frames' steady-state FFT-peak estimates locally — the
rolling windows become embarrassingly parallel after one neighbor exchange,
bit-matching the unsharded :func:`vhr_tpu.ops.windows.rolling_bpm_fft`
steady region.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import HRBand
from ..dsp import spectral
from ..ops import windows as vwin

__all__ = ["sharded_steady_bpm", "sharded_holdover", "sharded_forward_fill",
           "sharded_rolling_bpm_fft", "measure_green_avg_sharded"]


def sharded_steady_bpm(signal: jnp.ndarray, fps: float, band: HRBand,
                       window_len: int, mesh: Mesh,
                       axis_name: str = "time"
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame steady-state BPM of a time-sharded ``(T,)`` signal.

    Frame ``i`` (global) sees ``signal[i - window_len + 1 : i + 1]``; frames
    earlier than ``window_len - 1`` are invalid (the acquisition ramp is a
    prefix-local computation — run it on shard 0's data if needed).

    Returns ``(bpm, valid)`` sharded like the input.
    """
    n_shards = mesh.shape[axis_name]
    halo = window_len - 1

    def body(xl):
        idx = jax.lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        left = jax.lax.ppermute(xl[-halo:], axis_name, fwd)
        # Shard 0 has no real left context: zero halo, frames masked invalid.
        left = jnp.where(idx == 0, jnp.zeros_like(left), left)
        ext = jnp.concatenate([left, xl], axis=0)     # (halo + T_local,)
        wins = vwin.sliding_windows(ext, window_len)  # (T_local, W)
        wins = wins - jnp.mean(wins, axis=-1, keepdims=True)
        est = spectral.estimate_bpm(wins, fps, band)
        t_local = xl.shape[0]
        global_i = idx * t_local + jnp.arange(t_local)
        valid = jnp.logical_and(est.valid, global_i >= window_len - 1)
        return est.bpm, valid

    return shard_map(body, mesh=mesh, in_specs=(P(axis_name),),
                     out_specs=(P(axis_name), P(axis_name)),
                     check_vma=False)(signal)


def sharded_holdover(box: jnp.ndarray, valid: jnp.ndarray, mesh: Mesh,
                     hold_frames: int = 15, axis_name: str = "time",
                     attempted: jnp.ndarray = None):
    """Detection holdover over a TIME-SHARDED recording — exactly equal to
    the sequential :func:`vhr_tpu.ops.roi.holdover` scan.

    The holdover carry (last box, failure budget, has-last: 6 int32s) is a
    sequential dependency, but any successful detection RESETS it — so a
    shard's transfer function is summarizable without its input carry:

    * pass 1 (local, parallel): each shard computes ``(any_valid,
      last_valid_box, failures_after_last_valid, failures_total)``.
    * compose: one ``all_gather`` of the 4-field summaries (the only
      collective); every shard folds the prefix of summaries before it —
      a static ``n_shards``-step loop on 6 int32s — to recover its true
      input carry.  A shard with a detection maps ANY input carry to
      ``(last_box, max(hold - f_after, 0), True)``; a shard without one
      passes the carry through with its budget drained by ``f_total``
      (clamped at 0, matching the scan's stop-at-zero rule).
    * pass 2 (local, parallel): re-run the exact per-frame scan from the
      recovered carry.

    Two local scans + one tiny all_gather instead of a cross-chip
    sequential chain.  Reference rule: ``analysis/utils/roi.py:91-101``;
    the per-frame semantics (including the cadence ``attempted`` rule)
    are :func:`ops.roi.holdover`'s, pinned equal in tests/test_parallel.py.

    Args: ``box (T, 4)`` int32, ``valid (T,)`` bool, optionally
    ``attempted (T,)`` bool — all sharded over ``axis_name`` on axis 0.
    Returns a :class:`vhr_tpu.ops.roi.BoxTrack` sharded likewise.
    """
    from ..ops import roi as vroi

    n_shards = mesh.shape[axis_name]
    if attempted is None:
        attempted = jnp.ones(valid.shape, bool)

    def body(bl, vl, al):
        # --- pass 1: local summary ---
        t_local = vl.shape[0]
        any_v = jnp.any(vl)
        last_idx = jnp.argmax(
            jnp.where(vl, jnp.arange(t_local), -1))          # 0 if none
        box_last = bl[last_idx]
        fails = jnp.logical_and(al, jnp.logical_not(vl))
        v_after = (jnp.flip(jnp.cumsum(jnp.flip(vl.astype(jnp.int32))))
                   - vl.astype(jnp.int32))                   # valids after t
        f_after = jnp.sum(jnp.logical_and(fails, v_after == 0)
                          .astype(jnp.int32))
        f_total = jnp.sum(fails.astype(jnp.int32))

        summary = (any_v.astype(jnp.int32), box_last, f_after, f_total)
        gathered = jax.lax.all_gather(summary, axis_name)    # (n_shards, ...)
        g_any, g_box, g_fa, g_ft = gathered

        # --- compose input carries for every shard (static prefix fold) ---
        def apply_summary(c, k):
            last, budget, has = c
            a = g_any[k] > 0
            reset_budget = jnp.maximum(hold_frames - g_fa[k], 0)
            thru_budget = jnp.where(has,
                                    jnp.maximum(budget - g_ft[k], 0), budget)
            return (jnp.where(a, g_box[k], last),
                    jnp.where(a, reset_budget, thru_budget),
                    jnp.logical_or(a, has))

        carries_last = [jnp.zeros((4,), jnp.int32)]
        carries_budget = [jnp.int32(0)]
        carries_has = [jnp.asarray(False)]
        c = (carries_last[0], carries_budget[0], carries_has[0])
        for k in range(n_shards - 1):
            c = apply_summary(c, k)
            carries_last.append(c[0])
            carries_budget.append(c[1])
            carries_has.append(c[2])
        idx = jax.lax.axis_index(axis_name)
        my_carry = (jnp.stack(carries_last)[idx],
                    jnp.stack(carries_budget)[idx],
                    jnp.stack(carries_has)[idx])

        # --- pass 2: exact local scan from the recovered carry ---
        track, _ = vroi.holdover_with_carry(bl, vl, hold_frames,
                                            carry=my_carry, attempted=al)
        return track.box, track.valid

    boxes, valids = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name)),
        check_vma=False)(box, valid, attempted)
    from ..ops.roi import BoxTrack
    return BoxTrack(box=boxes, valid=valids)


def sharded_forward_fill(x: jnp.ndarray, valid: jnp.ndarray, mesh: Mesh,
                         axis_name: str = "time") -> jnp.ndarray:
    """Forward-fill over a TIME-SHARDED trace — exactly equal to the
    sequential :func:`vhr_tpu.dsp.filters.forward_fill` (``init="zeros"``).

    Same summary-compose trick as :func:`sharded_holdover`: the fill carry
    (last valid value) resets at any valid sample, so each shard's transfer
    function is ``(any_valid, last_valid_value)`` — one tiny ``all_gather``
    plus a static prefix fold recovers every shard's true input carry, then
    an exact local scan finishes.  ``x`` is ``(T,)`` or ``(T, C)``; both
    sharded over ``axis_name`` on axis 0.
    """
    n_shards = mesh.shape[axis_name]

    def body(xl, vl):
        t_local = vl.shape[0]
        any_v = jnp.any(vl)
        last_idx = jnp.argmax(jnp.where(vl, jnp.arange(t_local), -1))
        g_any, g_last = jax.lax.all_gather(
            (any_v.astype(jnp.int32), xl[last_idx]), axis_name)

        val = jnp.zeros_like(xl[0])
        vals = [val]
        for k in range(n_shards - 1):           # static prefix fold
            val = jnp.where(g_any[k] > 0, g_last[k], val)
            vals.append(val)
        idx = jax.lax.axis_index(axis_name)
        carry0 = jnp.stack(vals)[idx]

        def step(c, inp):
            v, ok = inp
            new = jnp.where(ok, v, c)
            return new, new

        _, filled = jax.lax.scan(step, carry0, (xl, vl))
        return filled

    return shard_map(body, mesh=mesh,
                     in_specs=(P(axis_name), P(axis_name)),
                     out_specs=P(axis_name), check_vma=False)(x, valid)


def sharded_rolling_bpm_fft(signal: jnp.ndarray, fps: float, band: HRBand,
                            window_len: int, acquisition_len: int,
                            mesh: Mesh, axis_name: str = "time"
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Time-sharded :func:`vhr_tpu.ops.windows.rolling_bpm_fft` — per-frame
    deque-semantics FFT BPM (growing-window acquisition ramp + steady
    sliding windows), exactly equal to the unsharded version.

    Steady windows come from a ``window_len - 1`` left halo (one
    ``ppermute``); the acquisition ramp (every window starts at global
    sample 0) lives entirely on shard 0, which recomputes it locally via
    the exact masked ramp DFT.  Requires ``T_local >= window_len`` so the
    ramp never crosses a shard boundary (an hour-scale recording over a
    pod: 30 s windows vs >10k frames/shard).

    Returns ``(bpm, valid)`` sharded like the input.
    """
    n_shards = mesh.shape[axis_name]
    if n_shards == 1:
        r = vwin.rolling_bpm_fft(signal, fps, band, window_len,
                                 acquisition_len)
        return r.bpm, r.valid
    T = signal.shape[0]
    t_local = T // n_shards
    if t_local < window_len:
        raise ValueError(
            f"time-sharded rolling BPM needs T_local >= window_len "
            f"({t_local} < {window_len}); use fewer shards or a shorter "
            f"window")
    halo = window_len - 1
    first = acquisition_len - 1

    def body(xl):
        xl = (xl if jnp.issubdtype(xl.dtype, jnp.floating)
              else xl.astype(jnp.float32))
        idx = jax.lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        left = jax.lax.ppermute(xl[-halo:], axis_name, fwd)
        ext = jnp.concatenate([left, xl], axis=0)     # (halo + T_local,)
        wins = vwin.sliding_windows(ext, window_len)  # (T_local, W)
        wins = wins - jnp.mean(wins, axis=-1, keepdims=True)
        est = spectral.estimate_bpm(wins, fps, band)
        global_i = idx * t_local + jnp.arange(t_local)
        steady = global_i >= window_len - 1
        bpm = jnp.where(steady, est.bpm, 0.0)
        valid = jnp.logical_and(
            steady, jnp.logical_and(est.valid, window_len >= 8))

        # Acquisition ramp (global frames first..window_len-2): shard 0's
        # local prefix IS the global prefix, so the exact masked ramp DFT
        # runs on xl and is selected only there.
        if first <= window_len - 2:
            lengths = np.arange(first + 1, window_len)
            r_bpm, r_valid = vwin._ramp_bpm(xl, fps, band, lengths)
            r_valid = jnp.logical_and(r_valid, jnp.asarray(lengths >= 8))
            pos = np.arange(first, window_len - 1)
            ramp_b = jnp.zeros((t_local,), bpm.dtype).at[pos].set(r_bpm)
            ramp_v = jnp.zeros((t_local,), bool).at[pos].set(r_valid)
            is_ramp = jnp.logical_and(
                idx == 0, jnp.logical_and(global_i >= first,
                                          global_i <= window_len - 2))
            bpm = jnp.where(is_ramp, ramp_b, bpm)
            valid = jnp.where(is_ramp, ramp_v, valid)
        return bpm, valid

    return shard_map(body, mesh=mesh, in_specs=(P(axis_name),),
                     out_specs=(P(axis_name), P(axis_name)),
                     check_vma=False)(signal)


def measure_green_avg_sharded(frames: jnp.ndarray, fps: float, mesh: Mesh,
                              cfg=None, detector=None,
                              bandpass: bool = False,
                              axis_name: str = "time"):
    """The canonical green-channel measure (``green_avg.py:11-52``) over a
    TIME-SHARDED long recording — SURVEY §5 long-context as one product
    path, not parts.

    ``frames`` is ``(T, H, W, 3)`` uint8 sharded over ``axis_name``;
    detection runs frame-local per shard, the ≤15-frame landmark holdover
    crosses shard boundaries via :func:`sharded_holdover`, dropout
    forward-fill via :func:`sharded_forward_fill`, optional zero-phase
    bandpass via :func:`vhr_tpu.parallel.time_shard.halo_sosfiltfilt`, and
    the windowed FFT-peak estimate via :func:`sharded_rolling_bpm_fft` —
    every cross-shard dependency is one collective, everything else is
    embarrassingly parallel.

    The whole measure is one jitted program per ``(mesh, cfg, detector,
    fps, bandpass)``: run op by op, the masked ROI reduction would
    materialize a float32 copy of the frames (4x the recording's bytes).
    A ``jax.tree_util.Partial`` detector's weights enter as traced
    arguments; any other detector callable is a static (hashed) argument.

    ``bandpass=False`` is pinned EXACTLY equal to the single-device
    :func:`vhr_tpu.pipeline.offline.measure_green_avg` (estimator="fft");
    ``bandpass=True`` additionally zero-phase-filters the filled trace
    (order-2 Butterworth over ``cfg.band``, the ``rppg_VIDEO.py:402``
    filter) before windowing — the long-recording composition.

    Returns ``(bpm, valid, green)``, each ``(T,)`` sharded like the input.
    """
    from ..config import PipelineConfig
    from ..pipeline.offline import _split_detector

    det_fn, det_args = _split_detector(detector)
    return _measure_green_avg_sharded_jit(
        frames, det_args, fps=float(fps), mesh=mesh,
        cfg=cfg or PipelineConfig(), det_fn=det_fn, bandpass=bool(bandpass),
        axis_name=axis_name)


@functools.partial(jax.jit, static_argnames=("fps", "mesh", "cfg", "det_fn",
                                             "bandpass", "axis_name"))
def _measure_green_avg_sharded_jit(frames, det_args, fps, mesh, cfg, det_fn,
                                   bandpass, axis_name):
    from ..ops import reduce as vreduce
    from ..ops import roi as vroi

    T, H, W, _ = frames.shape
    spec = P(axis_name)

    def det_body(fr, args):
        return det_fn(*args, fr)

    boxes, dvalid = shard_map(
        det_body, mesh=mesh, in_specs=(spec, P()),
        out_specs=(spec, spec), check_vma=False)(frames, det_args)

    track = sharded_holdover(boxes, dvalid, mesh,
                             cfg.roi.landmark_hold_frames, axis_name)

    def roi_body(fr, bx, vl):
        rois = vroi.measurement_roi(bx, cfg.roi, W, H, cfg.roi_site)
        rois = jnp.where(vl[:, None], rois, 0)
        means, _ = vreduce.roi_channel_means(fr, rois)
        return means

    means = shard_map(
        roi_body, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=spec, check_vma=False)(frames, track.box, track.valid)

    green = sharded_forward_fill(means[:, cfg.channel], track.valid,
                                 mesh, axis_name)
    sig = green
    if bandpass:
        from ..dsp import design
        from .time_shard import halo_sosfiltfilt
        sos = design.sos_design("butterworth", fps, cfg.band.low_hz,
                                cfg.band.high_hz, order=2)
        sig = halo_sosfiltfilt(sos, sig, mesh, axis_name)

    bpm, rvalid = sharded_rolling_bpm_fft(
        sig, fps, cfg.band, cfg.window_len(fps), cfg.acquisition_len(fps),
        mesh, axis_name)
    ok = jnp.logical_and(rvalid, track.valid)
    return bpm, ok, green
