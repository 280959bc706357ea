"""Unrolled small-matrix linear algebra and the filter path's one matmul helper.

Every matrix on the measurement side of the UKF is tiny and of *static* size
(1–6: the measurement dims of ``src/PoseUKF.hpp:79-89``; 6×6 for the Fossen
inertia matrix), so Cholesky and the triangular substitutions are unrolled
completely into scalar FMAs, which XLA fuses into the surrounding elementwise
graph — no library calls, no loops, no layout changes.

All functions assume SPD inputs (true for innovation covariances S = cov + R
and for Fossen inertia matrices M = M_RB + M_A) and are shape-generic over
any number of right-hand-side columns; they batch transparently under vmap.

:func:`mm` is the one place that sets matmul precision for the filter path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["cholesky_unrolled", "mm", "solve_spd", "UNROLL_LIMIT"]

UNROLL_LIMIT = 8  # beyond this, fall back to library kernels

# read at trace time by :func:`mm`
PRECISION = jax.lax.Precision.HIGHEST


def mm(*operands: jax.Array) -> jax.Array:
    """Left-to-right product of ``operands`` at :data:`PRECISION` (``HIGHEST``).

    An f32 matmul at default precision may run in bf16 or TF32 on an
    accelerator (a 10-bit mantissa, ~1e-3 relative). The covariance update
    P − K·S·Kᵀ cancels ~1.0 against ~1.0 down to ~1e-4 posterior variances,
    and that error flips variances negative (NaN at the next Cholesky), so
    every matmul on the filter path goes through here."""
    out = operands[0]
    for x in operands[1:]:
        out = jnp.matmul(out, x, precision=PRECISION)
    return out


def _scalar_cholesky_factors(S: jax.Array):
    """Scalar lower-triangular factor grid L[i][j] (i ≥ j) of a static-size
    SPD matrix, Cholesky–Crout fully unrolled — the single definition shared
    by :func:`cholesky_unrolled` and :func:`solve_spd` (keeping two copies of
    this numerically delicate loop in sync was a maintenance hazard)."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        s = S[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, m):
            t = S[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    return L


def cholesky_unrolled(S: jax.Array) -> jax.Array:
    """Lower Cholesky factor of a static-size SPD matrix, fully unrolled.

    Cholesky–Crout over scalars; for m ≤ 8 this emits O(m³/6) fused FMAs.
    """
    m = S.shape[-1]
    L = _scalar_cholesky_factors(S)
    rows = [
        jnp.stack([L[i][j] if j <= i else jnp.zeros_like(L[i][i]) for j in range(m)], axis=-1)
        for i in range(m)
    ]
    return jnp.stack(rows, axis=-2)


def _solve_spd_unrolled(S: jax.Array, B: jax.Array) -> jax.Array:
    """x = S⁻¹B for SPD S (m,m), B (m, ...), unrolled Cholesky + substitutions."""
    m = S.shape[-1]
    L = _scalar_cholesky_factors(S)
    inv_diag = [1.0 / L[i][i] for i in range(m)]
    # forward substitution: L y = B
    y = [None] * m
    for i in range(m):
        t = B[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t * inv_diag[i]
    # back substitution: Lᵀ x = y
    x = [None] * m
    for i in reversed(range(m)):
        t = y[i]
        for k in range(i + 1, m):
            t = t - L[k][i] * x[k]
        x[i] = t * inv_diag[i]
    return jnp.stack(x, axis=0)


def solve_spd(S: jax.Array, B: jax.Array) -> jax.Array:
    """S⁻¹B for SPD S; unrolled when the static size permits, library
    ``cho_solve`` otherwise. ``B`` may be (m,) or (m, k)."""
    m = S.shape[-1]
    if m <= UNROLL_LIMIT:
        return _solve_spd_unrolled(S, B)
    f = jax.scipy.linalg.cho_factor(S, lower=True)
    return jax.scipy.linalg.cho_solve(f, B)
