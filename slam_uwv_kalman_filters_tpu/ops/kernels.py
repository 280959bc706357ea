"""Banked factorizations of the filter hot path.

Every unscented predict and update starts from the ukfom sigma-point deltas
of the covariance: row 0 zero, rows 2j+1 / 2j+2 the ±j-th column of
L = chol(P). The 53-DOF PoseUKF covariance mixes variances from ~1e-11
(damping parameters) to ~1e1 (velocity) — condition ~1e12 in raw units,
beyond f32 — so the factor is taken **diagonally equilibrated**:
L = D·chol(D⁻¹·P·D⁻¹) with D = √diag(P), exact in infinite precision, with a
well-conditioned correlation matrix in the middle.

One path runs on every platform: small matrices (n ≤ ``UNROLL_LIMIT``) use
the fully unrolled scalar Cholesky of ``linalg_small``, which XLA fuses into
the surrounding graph; larger ones the batched ``jnp.linalg.cholesky``
(cuSOLVER on a GPU, LAPACK on the CPU). The functions are written for a
single matrix or an (N, n, n) bank and batch under ``vmap``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg_small import UNROLL_LIMIT, cholesky_unrolled, solve_spd

__all__ = ["cholesky_banked", "sigma_deltas_banked", "solve_spd_banked"]


def _equilibrate(cov: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(D⁻¹·P·D⁻¹, √diag(P)) of an (N, n, n) bank."""
    var = jnp.diagonal(cov, axis1=-2, axis2=-1)
    tiny = jnp.asarray(jnp.finfo(cov.dtype).tiny, cov.dtype)
    d = jnp.sqrt(jnp.maximum(var, tiny))
    return cov / (d[:, :, None] * d[:, None, :]), d


@jax.jit
def cholesky_banked(cov: jax.Array) -> jax.Array:
    """Lower Cholesky of an (N, n, n) or (n, n) SPD batch: unrolled for
    n ≤ ``UNROLL_LIMIT``, otherwise the equilibrated
    ``jnp.linalg.cholesky``."""
    single = cov.ndim == 2
    if single:
        cov = cov[None]
    if cov.shape[-1] <= UNROLL_LIMIT:
        out = cholesky_unrolled(cov)
    else:
        corr, d = _equilibrate(cov)
        out = jnp.linalg.cholesky(corr) * d[:, :, None]
    return out[0] if single else out


@jax.jit
def sigma_deltas_banked(cov: jax.Array) -> jax.Array:
    """(N, n, n) or (n, n) SPD → (N, 2n+1, n) or (2n+1, n) ukfom sigma-point
    tangent deltas: :func:`cholesky_banked`, then the ± interleave of the
    factor's columns."""
    single = cov.ndim == 2
    if single:
        cov = cov[None]
    nb, n = cov.shape[0], cov.shape[-1]
    cols = jnp.swapaxes(cholesky_banked(cov), -1, -2)  # row j = column j of L
    pm = jnp.stack([cols, -cols], axis=-2).reshape(nb, 2 * n, n)
    out = jnp.concatenate([jnp.zeros((nb, 1, n), cov.dtype), pm], axis=-2)
    return out[0] if single else out


@jax.jit
def solve_spd_banked(spd: jax.Array, rhs: jax.Array) -> jax.Array:
    """X = A⁻¹B for a batch of SPD systems, ``spd`` (N, n, n), ``rhs``
    (N, n, k) → (N, n, k): unrolled for n ≤ ``UNROLL_LIMIT``, otherwise an
    equilibrated ``cho_factor``/``cho_solve`` (filter covariances reach ~1e12
    condition in raw units — a raw f32 ``cho_factor`` NaNs)."""
    if spd.shape[-1] <= UNROLL_LIMIT:
        return jax.vmap(solve_spd)(spd, rhs)
    corr, d = _equilibrate(spd)
    f = jax.scipy.linalg.cho_factor(corr, lower=True)
    x = jax.scipy.linalg.cho_solve(f, rhs / d[:, :, None])
    return x / d[:, :, None]
