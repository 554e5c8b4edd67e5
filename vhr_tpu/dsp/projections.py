"""Chrominance pulse projections: CHROM and POS.

Two classic motion-robust rPPG signal constructions, beyond the reference's
green-mean and ICA (`analysis/measurement/green_avg.py`, `ica.py`): both
project the per-frame RGB means onto directions orthogonal to common-mode
intensity changes (specular/motion), keeping the blood-volume pulse.

* **CHROM** (de Haan & Jeanne, IEEE TBME 2013): per-interval normalized
  ``X = 3R - 2G``, ``Y = 1.5R + G - 1.5B``; pulse ``X - (sigma_X/sigma_Y) Y``,
  Hann overlap-add over 50%-overlapping intervals.
* **POS** (Wang et al., IEEE TBME 2017): per-window normalized
  ``S1 = G - B``, ``S2 = G + B - 2R``; pulse ``S1 + (sigma_1/sigma_2) S2``,
  mean-removed and overlap-added with stride 1.
* **OMIT** (Alvarez Casado & Bordallo Lopez, "Face2PPG", 2023): per-window
  QR orthogonalization of the (3, L) channel matrix — the first orthonormal
  direction captures the dominant (skin/intensity) component and the pulse
  is the green row of the residual after projecting it out.  Data-adaptive
  (no fixed skin-tone assumption), unlike CHROM/POS's fixed axes.

Batched implementation: every sliding window is one row of a gathered
``(n_windows, L)`` tensor — all statistics, projections, and the overlap-add
(a segment-sum scatter) run batched in one XLA program; no Python loops.
Both accept the pipeline's BGR channel order and a validity mask (invalid
frames are forward-filled, the mask re-applied by callers downstream).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["chrom_pulse", "pos_pulse", "omit_pulse"]


def _ffill_rows(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Forward-fill invalid frames ((T, 3), (T,)); first-valid init avoids
    a fake step edge in the leading normalized windows."""
    from .filters import forward_fill
    return forward_fill(x, valid, init="first_valid")


def _windows(T: int, L: int, stride: int) -> np.ndarray:
    """Static (n_windows, L) frame-index table covering every frame: the
    last window is pinned to end exactly at T, so strides that don't divide
    T-L still leave no uncovered (zero-pulse) tail."""
    L = min(L, T)
    starts = np.arange(0, max(T - L, 0) + 1, stride)
    if len(starts) == 0:
        starts = np.array([0])
    if starts[-1] != T - L:
        starts = np.append(starts, T - L)
    return starts[:, None] + np.arange(L)[None, :]


def chrom_pulse(bgr: jnp.ndarray, valid: jnp.ndarray, fps: float,
                interval_seconds: float = 1.6) -> jnp.ndarray:
    """CHROM pulse signal from (T, 3) BGR ROI means -> (T,).

    Per 50%-overlapping Hann-weighted interval: channel-normalize by the
    interval mean, project to the two chrominance axes, alpha-combine by
    the in-interval std ratio, overlap-add.
    """
    T = bgr.shape[0]
    L = int(max(4, min(T, round(interval_seconds * fps))))
    step = max(1, L // 2)
    filled = _ffill_rows(bgr, valid)
    b, g, r = filled[:, 0], filled[:, 1], filled[:, 2]

    idx = jnp.asarray(_windows(T, L, step))              # (N, L)
    eps = 1e-9

    def norm(c):
        w = c[idx]                                       # (N, L)
        return w / (jnp.mean(w, axis=1, keepdims=True) + eps)

    rn, gn, bn = norm(r), norm(g), norm(b)
    x = 3.0 * rn - 2.0 * gn
    y = 1.5 * rn + gn - 1.5 * bn
    x = x - jnp.mean(x, axis=1, keepdims=True)
    y = y - jnp.mean(y, axis=1, keepdims=True)
    alpha = (jnp.std(x, axis=1, keepdims=True)
             / (jnp.std(y, axis=1, keepdims=True) + eps))
    s = x - alpha * y                                    # (N, L)

    win = jnp.asarray(np.hanning(idx.shape[1]), jnp.float32)
    s = s * win[None, :]
    pulse = jnp.zeros((T,), jnp.float32).at[idx.reshape(-1)].add(
        s.reshape(-1))
    norm_w = jnp.zeros((T,), jnp.float32).at[idx.reshape(-1)].add(
        jnp.broadcast_to(win, idx.shape).reshape(-1))
    return pulse / jnp.maximum(norm_w, eps)


def pos_pulse(bgr: jnp.ndarray, valid: jnp.ndarray, fps: float,
              window_seconds: float = 1.6) -> jnp.ndarray:
    """POS pulse signal from (T, 3) BGR ROI means -> (T,).

    Stride-1 sliding windows (the paper's overlap-add): normalize by the
    window mean, project onto the plane orthogonal to the skin tone,
    alpha-combine, remove the window mean, accumulate.
    """
    T = bgr.shape[0]
    L = int(max(4, min(T, round(window_seconds * fps))))
    filled = _ffill_rows(bgr, valid)
    b, g, r = filled[:, 0], filled[:, 1], filled[:, 2]

    idx = jnp.asarray(_windows(T, L, 1))                 # (N, L)
    eps = 1e-9

    def norm(c):
        w = c[idx]
        return w / (jnp.mean(w, axis=1, keepdims=True) + eps)

    rn, gn, bn = norm(r), norm(g), norm(b)
    s1 = gn - bn
    s2 = gn + bn - 2.0 * rn
    alpha = (jnp.std(s1, axis=1, keepdims=True)
             / (jnp.std(s2, axis=1, keepdims=True) + eps))
    h = s1 + alpha * s2
    h = h - jnp.mean(h, axis=1, keepdims=True)           # (N, L)

    pulse = jnp.zeros((T,), jnp.float32).at[idx.reshape(-1)].add(
        h.reshape(-1))
    return pulse


def omit_pulse(bgr: jnp.ndarray, valid: jnp.ndarray, fps: float,
               window_seconds: float = 1.6) -> jnp.ndarray:
    """OMIT pulse signal from (T, 3) BGR ROI means -> (T,).

    Per 50%-overlapping Hann window: project the raw (3, L) channel matrix
    onto the complement of its dominant color direction (``P = I - q q^T``)
    and overlap-add the green row of ``P C``.  The published algorithm
    takes ``q = Q[:, 0]`` of the raw matrix's QR — which Gram-Schmidt makes
    exactly the normalized FIRST time sample's RGB vector; here ``q`` is
    the normalized window-mean color instead, identical to first order for
    slowly-varying illumination but robust to single-sample noise (one
    batched matvec instead of N QRs, too).
    """
    T = bgr.shape[0]
    L = int(max(4, min(T, round(window_seconds * fps))))
    step = max(1, L // 2)
    filled = _ffill_rows(bgr, valid)
    rgb = filled[:, ::-1]                                # (T, 3) RGB order

    idx = jnp.asarray(_windows(T, L, step))              # (N, L)
    eps = 1e-9
    C = jnp.transpose(rgb[idx], (0, 2, 1))               # (N, 3, L)
    mean = jnp.mean(C, axis=2)                           # (N, 3)
    q0 = mean / (jnp.linalg.norm(mean, axis=1,
                                 keepdims=True) + eps)   # (N, 3)
    coef = jnp.einsum("nc,ncl->nl", q0, C,
                      precision=jax.lax.Precision.HIGHEST)  # (N, L)
    resid = C - q0[:, :, None] * coef[:, None, :]
    s = resid[:, 1, :]                                   # (N, L) green row
    s = s - jnp.mean(s, axis=1, keepdims=True)

    win = jnp.asarray(np.hanning(idx.shape[1]), jnp.float32)
    s = s * win[None, :]
    pulse = jnp.zeros((T,), jnp.float32).at[idx.reshape(-1)].add(
        s.reshape(-1))
    norm_w = jnp.zeros((T,), jnp.float32).at[idx.reshape(-1)].add(
        jnp.broadcast_to(win, idx.shape).reshape(-1))
    return pulse / jnp.maximum(norm_w, eps)
