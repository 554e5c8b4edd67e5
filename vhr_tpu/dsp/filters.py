"""Temporal filtering on the device: XLA-scanned IIR and FIR application.

The reference applies filters with scipy's C implementations
(``sp.sosfiltfilt`` at ``rppg_VIDEO.py:253,287``, ``sp.filtfilt`` at
``rppg_VIDEO.py:269``, streaming ``sp.sosfilt(..., zi=)`` at
``rppg_LIVESTREAM.py:245-251``).  Here the recurrences run under
``jax.lax.scan`` (sequential, the default) or ``jax.lax.associative_scan``
(parallel-in-T for long recordings), batched over arbitrary trailing axes so
thousands of stream windows filter in one fused XLA program.

Conventions: time along axis 0; trailing axes are batch.  Filter
*coefficients* are host-side numpy (see ``vhr_tpu.dsp.design``); they enter
the jitted computation as small constants.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import design

# The parallel IIR path composes 2x2 state matrices whose poles sit close to
# the unit circle for a narrow 0.7-4 Hz band at 30 fps; a TF32 contraction
# would round the coefficients and move the poles, so it stays exact f32.
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "sosfilt",
    "sosfilt_parallel",
    "sosfiltfilt",
    "lfilter",
    "filtfilt_fir",
    "odd_ext",
    "sos_stream_init",
    "sos_stream_push",
    "forward_fill",
]


def _broadcast_state(zi: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Broadcast ``(S, 2)`` init state against the batch dims of ``x``."""
    batch_shape = x.shape[1:]
    return jnp.broadcast_to(
        zi.reshape(zi.shape + (1,) * len(batch_shape)),
        zi.shape + batch_shape,
    )


def sosfilt(sos, x: jnp.ndarray, zi: Optional[jnp.ndarray] = None
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Causal cascaded-biquad filtering along axis 0 via ``lax.scan``.

    Direct-form II transposed, matching ``scipy.signal.sosfilt``:

        y[n]  = b0*x[n] + z0[n-1]
        z0[n] = b1*x[n] - a1*y[n] + z1[n-1]
        z1[n] = b2*x[n] - a2*y[n]

    Args:
      sos: ``(S, 6)`` sections (numpy or jax).
      x: ``(T, *batch)`` signal.
      zi: optional ``(S, 2, *batch)`` (or broadcastable ``(S, 2)``) state.

    Returns:
      ``(y, zf)`` — filtered signal and final state.
    """
    sos = jnp.asarray(sos, dtype=x.dtype)
    n_sections = sos.shape[0]
    if zi is None:
        zi = jnp.zeros((n_sections, 2) + x.shape[1:], dtype=x.dtype)
    elif zi.ndim == 2 and x.ndim > 1:
        zi = _broadcast_state(zi.astype(x.dtype), x)
    else:
        zi = zi.astype(x.dtype)

    def step(z, x_t):
        cur = x_t
        new_z = []
        for s in range(n_sections):  # S is tiny (<=4): unrolled at trace time
            b0, b1, b2, a1, a2 = sos[s, 0], sos[s, 1], sos[s, 2], sos[s, 4], sos[s, 5]
            y = b0 * cur + z[s, 0]
            z0 = b1 * cur - a1 * y + z[s, 1]
            z1 = b2 * cur - a2 * y
            new_z.append(jnp.stack([z0, z1]))
            cur = y
        return jnp.stack(new_z), cur

    zf, y = jax.lax.scan(step, zi, x)
    return y, zf


def _biquad_transition(b0, b1, b2, a1, a2, dtype):
    """State-space form of one DF2T biquad: z[n] = A z[n-1] + B x[n]."""
    A = jnp.array([[-a1, 1.0], [-a2, 0.0]], dtype=dtype)
    B = jnp.array([b1 - a1 * b0, b2 - a2 * b0], dtype=dtype)
    return A, B


def sosfilt_parallel(sos, x: jnp.ndarray, zi: Optional[jnp.ndarray] = None
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``sosfilt`` with the time recurrence parallelized.

    Each biquad is an affine recurrence ``z[n] = A z[n-1] + u[n]`` with a
    constant 2x2 ``A``; composing ``(A, u)`` pairs is associative, so
    ``lax.associative_scan`` evaluates it in O(log T) depth.  Preferred for
    long recordings where a sequential scan would serialize the chip.
    """
    sos = jnp.asarray(sos, dtype=x.dtype)
    n_sections = sos.shape[0]
    T = x.shape[0]
    batch_shape = x.shape[1:]
    if zi is None:
        zi = jnp.zeros((n_sections, 2) + batch_shape, dtype=x.dtype)
    elif zi.ndim == 2 and x.ndim > 1:
        zi = _broadcast_state(zi.astype(x.dtype), x)
    else:
        zi = zi.astype(x.dtype)

    def combine(left, right):
        A1, u1 = left
        A2, u2 = right
        # Elements carry the scan axis in front: A is (t, 2, 2), u is
        # (t, *batch, 2).
        A = jnp.einsum("tij,tjk->tik", A2, A1, precision=_HIGHEST)
        u = jnp.einsum("tij,t...j->t...i", A2, u1, precision=_HIGHEST) + u2
        return A, u

    cur = x
    for s in range(n_sections):
        b0, b1, b2, a1, a2 = sos[s, 0], sos[s, 1], sos[s, 2], sos[s, 4], sos[s, 5]
        A, B = _biquad_transition(b0, b1, b2, a1, a2, x.dtype)
        # u[n] = B * x[n] with the 2-vector axis last; fold zi into u[0].
        u = cur[..., None] * B
        u = u.at[0].add(jnp.einsum("ij,j...->...i", A, zi[s],
                                    precision=_HIGHEST))
        As = jnp.broadcast_to(A, (T, 2, 2))
        _, z = jax.lax.associative_scan(combine, (As, u))
        # y[n] = z0[n-1] + b0 x[n]; z[-1] is the provided zi.
        zi_s0 = zi[s, 0]
        z0_prev = jnp.concatenate([zi_s0[None], z[:-1, ..., 0]], axis=0)
        cur = b0 * cur + z0_prev
    return cur, None  # final state not materialized in the parallel path


def odd_ext(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Odd extension along axis 0 (scipy ``odd_ext`` semantics)."""
    if n < 1:
        return x
    left = 2 * x[0] - x[n:0:-1]
    right = 2 * x[-1] - x[-2:-(n + 2):-1]
    return jnp.concatenate([left, x, right], axis=0)


def sosfiltfilt(sos: np.ndarray, x: jnp.ndarray,
                padlen: Optional[int] = None,
                parallel: bool = False) -> jnp.ndarray:
    """Zero-phase forward-backward SOS filtering along axis 0.

    Matches ``scipy.signal.sosfiltfilt`` (odd extension, steady-state initial
    conditions scaled by the boundary samples) as used at
    ``rppg_VIDEO.py:253`` and ``rppg_VIDEO.py:287``.

    ``sos`` must be concrete numpy (host-designed); the padding length and
    per-section initial conditions are computed on host, so the traced
    computation has static shapes.
    """
    sos_np = np.asarray(sos, dtype=np.float64)
    if padlen is None:
        padlen = design.sosfiltfilt_padlen(sos_np)
    if x.shape[0] <= padlen:
        raise ValueError(
            f"input length {x.shape[0]} must exceed padlen {padlen}")
    zi = jnp.asarray(design.sosfilt_zi(sos_np), dtype=x.dtype)  # (S, 2)

    filt = sosfilt_parallel if parallel else sosfilt

    ext = odd_ext(x, padlen)
    zi_b = _broadcast_state(zi, ext)
    y, _ = filt(sos_np, ext, zi_b * ext[0])
    y_rev = y[::-1]
    y2, _ = filt(sos_np, y_rev, zi_b * y_rev[0])
    out = y2[::-1]
    return out[padlen:-padlen]


def lfilter(b, a, x: jnp.ndarray, zi: Optional[jnp.ndarray] = None
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """General transfer-function filtering along axis 0 (DF2T scan).

    Matches ``scipy.signal.lfilter``.  The state vector has length
    ``max(len(a), len(b)) - 1`` and updates fully vectorized, so a 41-tap FIR
    is a cheap VPU op per timestep.
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        b, a = b / a[0], a / a[0]
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    bj = jnp.asarray(b, dtype=x.dtype)
    aj = jnp.asarray(a, dtype=x.dtype)

    batch_shape = x.shape[1:]
    state_shape = (n - 1,) + batch_shape
    if zi is None:
        zi = jnp.zeros(state_shape, dtype=x.dtype)
    else:
        zi = jnp.broadcast_to(
            zi.astype(x.dtype).reshape((n - 1,) + (1,) * len(batch_shape)
                                       if zi.ndim == 1 else zi.shape),
            state_shape)

    b_rest = bj[1:].reshape((n - 1,) + (1,) * len(batch_shape))
    a_rest = aj[1:].reshape((n - 1,) + (1,) * len(batch_shape))

    def step(z, x_t):
        y = bj[0] * x_t + z[0]
        z_shift = jnp.concatenate([z[1:], jnp.zeros((1,) + batch_shape, x.dtype)])
        z_new = b_rest * x_t - a_rest * y + z_shift
        return z_new, y

    zf, y = jax.lax.scan(step, zi, x)
    return y, zf


def filtfilt_fir(b: np.ndarray, x: jnp.ndarray,
                 padlen: Optional[int] = None) -> jnp.ndarray:
    """Zero-phase FIR filtering, matching ``scipy.signal.filtfilt(b, [1.], x)``
    as used at ``rppg_VIDEO.py:269``."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.array([1.0])
    if padlen is None:
        padlen = design.filtfilt_padlen(b, a)
    if x.shape[0] <= padlen:
        raise ValueError(
            f"input length {x.shape[0]} must exceed padlen {padlen}")
    zi_np = design.lfilter_zi(b, a)  # (ntaps-1,)
    zi = jnp.asarray(zi_np, dtype=x.dtype)
    batch_nd = x.ndim - 1
    zi = zi.reshape(zi.shape + (1,) * batch_nd)

    ext = odd_ext(x, padlen)
    y, _ = lfilter(b, a, ext, zi * ext[0])
    y_rev = y[::-1]
    y2, _ = lfilter(b, a, y_rev, zi * y_rev[0])
    out = y2[::-1]
    return out[padlen:-padlen]


# ---------------------------------------------------------------------------
# Streaming (live) filtering
# ---------------------------------------------------------------------------

def sos_stream_init(sos: np.ndarray, batch_shape: Tuple[int, ...] = (),
                    dtype=jnp.float32) -> jnp.ndarray:
    """Zeroed streaming state, mirroring ``live_sos_init``
    (``rppg_LIVESTREAM.py:230-234``)."""
    return jnp.zeros((np.asarray(sos).shape[0], 2) + tuple(batch_shape), dtype)


def sos_stream_push(sos, z: jnp.ndarray, x_t: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Filter one new sample and carry the state, mirroring ``live_sos_push``
    (``rppg_LIVESTREAM.py:245-251``) but batched over streams and jittable."""
    sos = jnp.asarray(sos, dtype=z.dtype)
    cur = x_t.astype(z.dtype)
    new_z = []
    for s in range(sos.shape[0]):
        b0, b1, b2, a1, a2 = sos[s, 0], sos[s, 1], sos[s, 2], sos[s, 4], sos[s, 5]
        y = b0 * cur + z[s, 0]
        z0 = b1 * cur - a1 * y + z[s, 1]
        z1 = b2 * cur - a2 * y
        new_z.append(jnp.stack([z0, z1]))
        cur = y
    return cur, jnp.stack(new_z)


def forward_fill(x: jnp.ndarray, valid: jnp.ndarray,
                 init: str = "zeros") -> jnp.ndarray:
    """Carry the last valid sample forward over dropout gaps (a scan).

    The shared dropout-handling primitive for every measurement path
    (green/ICA traces via ``pipeline.offline``, chrominance projections via
    ``dsp.projections``).  ``x`` is ``(T,)`` or ``(T, C)``; ``valid`` is
    ``(T,)``.  ``init`` selects what leading-invalid samples become:
    ``"zeros"`` (the offline pipeline's reference-parity choice — masked
    out downstream anyway) or ``"first_valid"`` (projections: avoids a
    fake leading step edge in the normalized windows).
    """
    if init == "first_valid":
        start = x[jnp.argmax(valid)]
    else:
        start = jnp.zeros_like(x[0])

    def step(carry, inp):
        v, ok = inp
        new = jnp.where(ok, v, carry)
        return new, new

    _, filled = jax.lax.scan(step, start, (x, valid))
    return filled
