"""Filter observability metrics — the metrics layer the reference lacks
(SURVEY.md §5: "structured per-step metrics (NIS/NEES, gate-rejection rates,
covariance condition numbers)").

All functions are pure/jittable so they can run inside the step loop on
device; nothing here allocates host state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "nis",
    "nees",
    "covariance_condition",
    "ate_rmse",
    "heading_error",
    "StepMetrics",
    "step_metrics",
]


def nis(innovation: jax.Array, innovation_cov: jax.Array) -> jax.Array:
    """Normalized innovation squared νᵀS⁻¹ν (χ²_m under consistency).

    ``ops.ukf.UpdateInfo.mahalanobis2`` already carries this for each update;
    this standalone form is for offline analysis.
    """
    return innovation @ jnp.linalg.solve(innovation_cov, innovation)


def nees(error: jax.Array, cov: jax.Array) -> jax.Array:
    """Normalized estimation error squared eᵀP⁻¹e (χ²_n under consistency)."""
    return error @ jnp.linalg.solve(cov, error)


def covariance_condition(cov: jax.Array) -> jax.Array:
    """Condition number via eigvalsh — divergence early-warning.

    Extremes are taken over eigenvalue MAGNITUDES, not signed values: an
    indefinite covariance (f32 cancellation flipping an eigenvalue to -1000)
    must report a huge condition number, not treat -1000 as the "smallest"
    eigenvalue and read as well-conditioned. A collapsed covariance (some
    |eigenvalue| exactly 0) reports ``inf``, not NaN: the guard divisor must
    be representable in the working dtype (a 1e-300 literal underflows to
    0.0 in float32, turning the flagged case into 0/0 on the f32 deployment path)."""
    w = jnp.abs(jnp.linalg.eigvalsh(cov))
    num = jnp.max(w, axis=-1)
    den = jnp.min(w, axis=-1)
    tiny = jnp.asarray(jnp.finfo(w.dtype).tiny, w.dtype)
    return jnp.where(den > 0, num / jnp.maximum(den, tiny), jnp.inf)


def ate_rmse(estimated: jax.Array, truth: jax.Array) -> jax.Array:
    """Absolute trajectory error (RMSE over positions, no alignment) — the
    BASELINE.md accuracy metric against reference trajectories."""
    d = estimated - truth
    return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1)))


def heading_error(q_est: jax.Array, q_true: jax.Array) -> jax.Array:
    """Yaw difference between two [w,x,y,z] quaternions (rad) — the
    gyrocompassing accuracy metric of the ICRA'18 evaluation."""

    def yaw(q):
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return jnp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))

    d = yaw(q_est) - yaw(q_true)
    return jnp.arctan2(jnp.sin(d), jnp.cos(d))


class StepMetrics(NamedTuple):
    nis: jax.Array
    accepted: jax.Array
    cov_trace: jax.Array
    cov_condition: jax.Array


def step_metrics(info, cov: jax.Array, *, with_condition: bool = False) -> StepMetrics:
    """Per-update metrics record from an ``ops.ukf.UpdateInfo`` + covariance."""
    cond = covariance_condition(cov) if with_condition else jnp.zeros_like(jnp.trace(cov))
    return StepMetrics(
        nis=info.mahalanobis2,
        accepted=info.accepted,
        cov_trace=jnp.trace(cov),
        cov_condition=cond,
    )
