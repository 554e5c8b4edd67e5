"""FastICA: batched blind source separation for the ICA rPPG method.

A batched JAX replacement for ``sklearn.decomposition.FastICA`` as configured at
``analysis/measurement/ica.py:36-44`` (3 components, parallel algorithm,
logcosh nonlinearity, max_iter=300, tol=1e-6, unit-variance whitening,
random_state=0).  The per-window solve is a fixed-point iteration under
``lax.while_loop``; whitening uses SVD; symmetric decorrelation uses a
batched 3x3 ``eigh``.  ``vmap`` the public entry point over windows/streams
— the reference runs one FastICA *per frame* (``ica.py:65``), which here
becomes a single batched program over every window at once.

Non-convergence is reported as a boolean instead of a warning so callers can
mask out failed windows (``ica.py:64-69`` skips them).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ICAResult", "fastica", "default_w_init", "ica_sources"]


def _mm(a, b):
    """Exact-f32 matmul: the fixed-point iteration and its tol=1e-6 stop test
    would not survive TF32 rounding (about 11 significant bits)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class ICAResult(NamedTuple):
    sources: jnp.ndarray      # (T, C) estimated independent components
    converged: jnp.ndarray    # () bool — False mirrors ConvergenceWarning
    n_iter: jnp.ndarray       # () int32


def default_w_init(n_components: int, seed: int = 0) -> np.ndarray:
    """The exact ``w_init`` sklearn draws from ``RandomState(seed)``."""
    return np.random.RandomState(seed).normal(
        size=(n_components, n_components))


def _sym_decorrelation(W: jnp.ndarray) -> jnp.ndarray:
    """W <- (W W^T)^{-1/2} W via eigendecomposition (sklearn semantics)."""
    s, u = jnp.linalg.eigh(_mm(W, W.T))
    s = jnp.clip(s, 1e-12, None)
    return _mm(_mm(u * (1.0 / jnp.sqrt(s)), u.T), W)


def _whiten_unit_variance(X: jnp.ndarray, n_components: int,
                          mask: jnp.ndarray, n: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """sklearn's SVD whitening with optional trailing-sample masking.

    ``X`` is ``(T, F)`` samples x features; returns ``(X1, K)`` with ``X1``
    shaped ``(C, T)``.  Masked-out columns become exactly zero after
    centering, and zero columns do not perturb the left singular vectors or
    singular values of ``XT`` — so one compiled program evaluates every
    window length exactly.
    """
    XT = X.T                                   # (F, T)
    mean = jnp.sum(jnp.where(mask, XT, 0.0), axis=-1, keepdims=True) / n
    XT = jnp.where(mask, XT - mean, 0.0)
    u, d, _ = jnp.linalg.svd(XT, full_matrices=False)
    u = u * jnp.sign(u[0])                     # sklearn's deterministic sign
    K = (u / d).T[:n_components]               # (C, F)
    X1 = _mm(K, XT) * jnp.sqrt(n)
    return X1, K


def fastica(X: jnp.ndarray,
            w_init: np.ndarray,
            max_iter: int = 300,
            tol: float = 1e-6,
            n_valid=None) -> ICAResult:
    """Run FastICA (parallel / logcosh / unit-variance) on one window.

    Args:
      X: ``(T, F)`` window, samples along axis 0 (the reference feeds
         ``(window, 3)`` per-frame BGR means, std-normalized — ``ica.py:59-65``).
      w_init: ``(C, C)`` unmixing initialization (host numpy; use
         :func:`default_w_init` for sklearn parity).
      max_iter / tol: sklearn-compatible stopping rule.
      n_valid: optional scalar — only ``X[:n_valid]`` is real data, the rest
         is padding.  Results equal running on the unpadded window (the
         acquisition-ramp trick: every growing window shares one compile).

    Returns:
      :class:`ICAResult` with unit-variance sources shaped ``(T, C)``
      (padded rows are zero).
    """
    n_components = w_init.shape[0]
    T = X.shape[0]
    if n_valid is None:
        n_valid = T
    n = jnp.asarray(n_valid, X.dtype)
    mask = (jax.lax.broadcasted_iota(jnp.int32, (1, T), 1)
            < jnp.asarray(n_valid, jnp.int32))            # (1, T)

    X1, _ = _whiten_unit_variance(X, n_components, mask, n)  # X1: (C, T)
    W0 = _sym_decorrelation(jnp.asarray(w_init, dtype=X.dtype))

    def cond(carry):
        _, ii, lim = carry
        return jnp.logical_and(ii < max_iter, lim >= tol)

    def body(carry):
        W, ii, _ = carry
        gwtx = jnp.tanh(_mm(W, X1))             # padded cols stay 0
        # E[1 - g^2] over *valid* samples only.
        g_wtx = jnp.sum(jnp.where(mask, 1.0 - gwtx**2, 0.0), axis=-1) / n
        W1 = _sym_decorrelation(_mm(gwtx, X1.T) / n - g_wtx[:, None] * W)
        lim = jnp.max(jnp.abs(jnp.abs(jnp.diagonal(_mm(W1, W.T))) - 1.0))
        return W1, ii + 1, lim

    W, n_iter, lim = jax.lax.while_loop(
        cond, body, (W0, jnp.int32(0), jnp.asarray(jnp.inf, X.dtype)))
    converged = lim < tol

    S = _mm(W, X1).T / jnp.sqrt(n)            # undo the sqrt(n) scaling
    # whiten="unit-variance": rescale to unit std (ddof=0 over valid rows;
    # sources are zero-mean so std = sqrt(E[S^2]); padded rows are zero).
    std = jnp.sqrt(jnp.sum(S * S, axis=0, keepdims=True) / n)
    S = S / std
    S = jnp.where(mask.T, S, 0.0)
    return ICAResult(sources=S, converged=converged, n_iter=n_iter)


def ica_sources(windows: jnp.ndarray, w_init: np.ndarray,
                max_iter: int = 300, tol: float = 1e-6,
                n_valid=None) -> ICAResult:
    """Batched FastICA over ``(N, T, F)`` windows via ``vmap``.

    ``n_valid`` may be an ``(N,)`` array of per-window true lengths.
    """
    if n_valid is None:
        return jax.vmap(lambda w: fastica(w, w_init, max_iter, tol))(windows)
    return jax.vmap(lambda w, nv: fastica(w, w_init, max_iter, tol, nv)
                    )(windows, n_valid)
