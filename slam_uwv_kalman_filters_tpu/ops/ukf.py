"""Manifold unscented Kalman filter core — the JAX ``ukfom::ukf``.

The reference builds every filter on the header-only ``ukfom::ukf<State>``
sigma-point engine (used via ``ukf->predict`` at ``/root/reference/src/PoseUKF.cpp:462-465``
and ``ukf->update`` at ``src/PoseUKF.cpp:479-481``). This module re-implements
that engine as pure JAX functions over (mu-pytree, covariance) pairs so that it
composes freely with ``jit``/``vmap``/``pjit``: a bank of 100k filters is just a
``vmap`` over the leading axis, and the hot covariance algebra (sigma-point
deviations → outer products) lowers to batched matmuls.

ukfom conventions reproduced here (Hertzberg et al., "Integrating Generic
Sensor Fusion Algorithms with Sound State Representations through Encapsulation
of Manifolds", Information Fusion 2011; pinned by the linear-KF-equivalence and
oracle tests in ``tests/test_ukf.py``):

* 2n+1 sigma points: X₀ = μ, X_{2j+1} = μ ⊞ Lⱼ, X_{2j+2} = μ ⊞ (−Lⱼ) with
  L = chol(P) (unit spread — no α/β/κ scaling).
* Mean: equal-weight iterative manifold mean started from X₀.
* Covariances: ½·Σᵢ(outer products of ⊟-deviations) — consistent with the
  unit spread (2 points per column ⇒ factor ½), exactly reproducing a linear
  Kalman filter on linear-Gaussian problems.
* Update: fresh sigma points from (μ, P); S = ½ΣdZdZᵀ + R;
  C = ½ΣdXdZᵀ; K = C·S⁻¹; χ²-gate on ν ᵀS⁻¹ν before applying
  (gate functions ``d2p95``/``d2p99`` at ``src/PoseUKF.cpp:261-286``).
* Gating under ``vmap`` is a masked select, not control flow, so a bank where
  one instance rejects a measurement stays fully data-parallel.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .kernels import sigma_deltas_banked, solve_spd_banked
from .linalg_small import mm, solve_spd
from .manifolds import ProductManifold

__all__ = [
    "D2P95",
    "D2P99",
    "UpdateInfo",
    "sigma_point_deltas",
    "sigma_points",
    "predict",
    "update",
    "smooth_step",
]

# χ² gate thresholds for 2 degrees of freedom (src/PoseUKF.cpp:265,278).
D2P99 = 9.21
D2P95 = 5.991


class UpdateInfo(NamedTuple):
    """Per-update observability record (reference has no metrics layer; this
    feeds utils.metrics — NIS is ``mahalanobis2``)."""

    mahalanobis2: jax.Array  # scalar: ν ᵀ S⁻¹ ν (the NIS)
    accepted: jax.Array  # bool scalar: χ² gate outcome
    innovation: jax.Array  # (m,) measurement-space innovation ν


_mm = mm  # all covariance-path matmuls pin Precision.HIGHEST (linalg_small.mm)


def _default_tol(dtype) -> float:
    """Manifold-mean convergence tolerance matched to the working precision:
    1e-12 for f64 oracle paths, 1e-6 for f32 throughput paths (an f32
    iteration cannot contract below ~1e-7, so a tighter tol would spin the
    while_loop to max_iters)."""
    return 1e-12 if jnp.dtype(dtype).itemsize >= 8 else 1e-6


def sigma_point_deltas(cov: jax.Array, *, jitter: float = 0.0) -> jax.Array:
    """(2n+1, n) tangent deltas: row 0 zero, then ±columns of chol(P).

    Layout matches ukfom's interleaved order (μ, +L₀, −L₀, +L₁, −L₁, …); the
    order only matters for which point seeds the iterative mean (row 0).
    """
    if jitter:
        cov = cov + jitter * jnp.eye(cov.shape[-1], dtype=cov.dtype)
    # equilibrated Cholesky + ±interleave (ops/kernels.py); batches under vmap
    return sigma_deltas_banked(cov)


def sigma_points(manifold: ProductManifold, mu: Any, cov: jax.Array, *, jitter: float = 0.0) -> Any:
    """Draw 2·DOF+1 sigma points; returns mu-pytree with leading sigma axis."""
    deltas = sigma_point_deltas(cov, jitter=jitter)
    return jax.vmap(lambda d: manifold.boxplus(mu, d))(deltas)


def _symmetrize(m: jax.Array) -> jax.Array:
    return 0.5 * (m + m.T)


def predict(
    manifold: ProductManifold,
    mu: Any,
    cov: jax.Array,
    f: Callable[[Any], Any],
    process_noise: jax.Array,
    *,
    jitter: float = 0.0,
    mean_iters: int = 64,
    mean_tol: Optional[float] = None,
) -> tuple[Any, jax.Array]:
    """Unscented prediction: (μ, P) → (μ⁺, P⁺) through process model ``f``.

    Mirrors ``ukfom::ukf::predict`` as driven by the reference's
    ``predictionStepImpl`` hooks (``src/PoseUKF.cpp:446-474``): propagate each
    sigma point through ``f`` (a single-state pure function; vmapped here),
    reconstruct the manifold mean iteratively, rebuild the covariance from
    ⊟-deviations, and add the (already dt-scaled) process noise.
    """
    if mean_tol is None:
        mean_tol = _default_tol(cov.dtype)
    with jax.named_scope("ukf_sigma_points"):
        X = sigma_points(manifold, mu, cov, jitter=jitter)
    with jax.named_scope("ukf_propagate"):
        Y = jax.vmap(f)(X)
    with jax.named_scope("ukf_mean"):
        mu_y = manifold.mean(Y, max_iters=mean_iters, tol=mean_tol)
        # the state's dtype governs: float64 parameters inside f must not
        # promote an f32 filter's state/covariance step over step
        mu_y = jax.tree_util.tree_map(lambda a, ref: a.astype(ref.dtype), mu_y, mu)
    with jax.named_scope("ukf_cov_reconstruct"):
        D = jax.vmap(lambda y: manifold.boxminus(y, mu_y))(Y)  # (2n+1, n)
        cov_y = 0.5 * _mm(D.astype(cov.dtype).T, D.astype(cov.dtype)) + process_noise
    return mu_y, _symmetrize(cov_y).astype(cov.dtype)


def update(
    manifold: ProductManifold,
    mu: Any,
    cov: jax.Array,
    z: Any,
    h: Callable[[Any], Any],
    meas_cov: jax.Array,
    *,
    meas_manifold: Optional[ProductManifold] = None,
    gate_threshold: Optional[float] = None,
    jitter: float = 0.0,
    mean_iters: int = 64,
    mean_tol: Optional[float] = None,
) -> tuple[Any, jax.Array, UpdateInfo]:
    """Unscented measurement update — the ``ukfom::ukf::update`` equivalent.

    ``h`` maps one state pytree to either a flat (m,) vector or, when
    ``meas_manifold`` is given, a measurement-manifold pytree (the reference's
    S² measurements: seafloor normal ``src/BottomUKF.cpp:63-67`` and visual
    features ``src/PoseUKF.cpp:646-648``). ``gate_threshold`` of ``None``
    reproduces ``ukfom::accept_any_mahalanobis_distance``; a float reproduces
    the χ² gates (e.g. ``D2P95`` for GPS at ``src/PoseUKF.cpp:578``).

    The gate is applied as a masked select so banks of filters never diverge
    in control flow. Cross-covariance uses the sigma deltas directly — for
    every manifold here, (μ ⊞ δ) ⊟ μ = δ exactly, so this matches ukfom's
    recomputed boxminus while skipping redundant work.
    """
    if mean_tol is None:
        mean_tol = _default_tol(cov.dtype)
    deltas = sigma_point_deltas(cov, jitter=jitter)  # (2n+1, n) == X_i ⊟ mu
    X = jax.vmap(lambda d: manifold.boxplus(mu, d))(deltas)
    Z = jax.vmap(h)(X)

    if meas_manifold is None:
        z_mean = jnp.mean(Z, axis=0)
        dZ = Z - z_mean[None, :]
        innovation = z - z_mean
    else:
        z_mean = meas_manifold.mean(Z, max_iters=mean_iters, tol=mean_tol)
        dZ = jax.vmap(lambda zi: meas_manifold.boxminus(zi, z_mean))(Z)
        innovation = meas_manifold.boxminus(z, z_mean)
    # pin the update algebra to the state's dtype (h may read f64 params)
    dZ = dZ.astype(cov.dtype)
    innovation = innovation.astype(cov.dtype)
    meas_cov = jnp.asarray(meas_cov, cov.dtype)

    S = 0.5 * _mm(dZ.T, dZ) + meas_cov
    S = _symmetrize(S)
    C = 0.5 * _mm(deltas.T, dZ)  # (n, m) cross-covariance

    # one unrolled SPD solve shared by the gain and the Mahalanobis distance
    # (ops/linalg_small.py)
    rhs = jnp.concatenate([C.T, innovation[:, None]], axis=1)  # (m, n+1)
    sol = solve_spd(S, rhs)
    K = sol[:, :-1].T  # K = C S⁻¹
    m2 = _mm(innovation, sol[:, -1])

    accepted = (
        jnp.asarray(True)
        if gate_threshold is None
        else m2 <= jnp.asarray(gate_threshold, dtype=m2.dtype)
    )

    mu_new = manifold.boxplus(mu, _mm(K, innovation))
    cov_new = _symmetrize(cov - _mm(_mm(K, S), K.T))

    # masked apply (no control-flow divergence across a vmapped bank)
    select = lambda a, b: jnp.where(accepted, a, b)
    mu_out = jax.tree_util.tree_map(select, mu_new, mu)
    cov_out = select(cov_new, cov)
    return mu_out, cov_out, UpdateInfo(mahalanobis2=m2, accepted=accepted, innovation=innovation)


def smooth_step(
    manifold: ProductManifold,
    mu_f: Any,
    cov_f: jax.Array,
    f: Callable[[Any], Any],
    process_noise: jax.Array,
    mu_s_next: Any,
    cov_s_next: jax.Array,
    *,
    jitter: float = 0.0,
    mean_iters: int = 64,
    mean_tol: Optional[float] = None,
) -> tuple[Any, jax.Array]:
    """One backward unscented Rauch–Tung–Striebel step on a manifold.

    Combines the filtered (μᵏ, Pᵏ) with the already-smoothed next state
    (μˢₖ₊₁, Pˢₖ₊₁) through the same process model ``f`` the forward pass used
    (Särkkä's URTS recursion, expressed in ⊞/⊟ local coordinates):

        χᵢ = μᵏ ⊞ δᵢ,  Υᵢ = f(χᵢ)
        μ⁻ = mean(Υ),  P⁻ = ½ΣDDᵀ + Q,  C = ½ΣδDᵀ
        G  = C·(P⁻)⁻¹
        μˢₖ = μᵏ ⊞ G·(μˢₖ₊₁ ⊟ μ⁻)
        Pˢₖ = Pᵏ + G·(Pˢₖ₊₁ − P⁻)·Gᵀ

    The reference library has no smoother — this is the offline
    reprocessing layer (survey post-processing) built on the same predict
    machinery; it reduces to the classical RTS smoother on linear-Gaussian
    problems (pinned by ``tests/test_smoother.py``). Runs under ``vmap``
    (banks) and inside a reverse ``lax.scan`` (whole trajectories)."""
    if mean_tol is None:
        mean_tol = _default_tol(cov_f.dtype)
    deltas = sigma_point_deltas(cov_f, jitter=jitter)  # (2n+1, n)
    X = jax.vmap(lambda d: manifold.boxplus(mu_f, d))(deltas)
    Y = jax.vmap(f)(X)
    mu_pred = manifold.mean(Y, max_iters=mean_iters, tol=mean_tol)
    mu_pred = jax.tree_util.tree_map(lambda a, ref: a.astype(ref.dtype), mu_pred, mu_f)
    D = jax.vmap(lambda y: manifold.boxminus(y, mu_pred))(Y).astype(cov_f.dtype)
    cov_pred = _symmetrize(0.5 * _mm(D.T, D) + process_noise).astype(cov_f.dtype)
    C = 0.5 * _mm(deltas.T, D)  # (n, n) cross-covariance cov(x_k, x_pred)

    # G = C·P⁻⁻¹ via an SPD solve (P⁻ Gᵀ = Cᵀ), equilibrated and banked
    # under vmap (ops/kernels.solve_spd_banked)
    G = solve_spd_banked(cov_pred[None], C.T[None])[0].T
    mu_s = manifold.boxplus(mu_f, _mm(G, manifold.boxminus(mu_s_next, mu_pred)))
    cov_s = _symmetrize(cov_f + _mm(_mm(G, cov_s_next - cov_pred), G.T))
    return mu_s, cov_s
