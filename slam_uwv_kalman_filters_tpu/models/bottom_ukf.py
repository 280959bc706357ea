"""BottomUKF — seafloor distance/normal tracking filter.

Re-implements the reference ``BottomUKF`` (``/root/reference/src/BottomUKF.hpp``,
``src/BottomUKF.cpp``): a 3-DOF UKF estimating the positive distance to the
bottom surface (scalar manifold) and the bottom surface normal (**S² manifold
state**, ``BottomUKF.hpp:15-21``). Measurements are per-beam DVL ranges via
ray/plane intersection (``BottomUKF.cpp:18-30,56-61``) and an optional direct
normal observation — a manifold-valued measurement (``BottomUKF.cpp:63-67``).
Vehicle velocity is an input, not an update (``BottomUKF.cpp:69-72``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import manifolds as mf
from ..ops import ukf
from ..ops.linalg_small import mm
from ..utils.validation import check_measurement

__all__ = [
    "BottomState",
    "BOTTOM_MANIFOLD",
    "BottomUKFState",
    "BottomUKFParams",
    "init",
    "predict",
    "predict_bank",
    "update_range",
    "update_range_bank",
    "update_normal",
    "update_normal_bank",
    "set_velocity",
    "BottomUKF",
]


class BottomState(NamedTuple):
    """``MTK_BUILD_MANIFOLD(BottomState, ...)`` (``BottomUKF.hpp:18-21``)."""

    distance: jax.Array  # (1,) positive distance to the bottom [m]
    normal: jax.Array  # (3,) unit normal of the bottom surface (S², 2 DOF)


BOTTOM_MANIFOLD = mf.make_manifold(
    mf.Field("distance", "vec", 1),
    mf.Field("normal", "s2"),
)  # DOF = 3 → 7 sigma points


class BottomUKFParams(NamedTuple):
    """``process_noise`` is the reference ctor's ``Covariance::Identity()``
    (``BottomUKF.cpp:45``), rescaled every prediction by speed²·dt²."""

    process_noise: jax.Array  # (3,3)


class BottomUKFState(NamedTuple):
    mu: BottomState
    cov: jax.Array  # (3,3)
    velocity: jax.Array  # (3,) vehicle velocity input (``setVelocity``)


def init(initial_state: BottomState, state_cov: jax.Array) -> tuple[BottomUKFState, BottomUKFParams]:
    dtype = initial_state.normal.dtype
    return (
        BottomUKFState(
            mu=initial_state,
            cov=jnp.asarray(state_cov, dtype=dtype),
            velocity=jnp.zeros(3, dtype=dtype),
        ),
        BottomUKFParams(process_noise=jnp.eye(3, dtype=dtype)),
    )


def predict(state: BottomUKFState, params: BottomUKFParams, dt) -> BottomUKFState:
    """``BottomUKF::predictionStepImpl`` (``BottomUKF.cpp:48-54``): distance
    decreases with vehicle z-velocity; process noise scaled by horizontal
    speed² · dt² (``BottomUKF.cpp:50``)."""
    v = state.velocity

    def f(chi: BottomState) -> BottomState:
        # processModel (BottomUKF.cpp:5-16): distance ⊞ (−v_z)·dt
        return chi._replace(distance=chi.distance + dt * (-v[2]))

    speed2 = v[0] ** 2 + v[1] ** 2
    q = speed2 * dt**2 * params.process_noise
    mu, cov = ukf.predict(BOTTOM_MANIFOLD, state.mu, state.cov, f, q)
    return state._replace(mu=mu, cov=cov)


def update_range(
    state: BottomUKFState,
    z: jax.Array,
    meas_cov: jax.Array,
    unit_direction: jax.Array,
    origin: jax.Array,
) -> tuple[BottomUKFState, ukf.UpdateInfo]:
    """Per-beam DVL range update via ray/plane intersection
    (``measurementDistance``, ``BottomUKF.cpp:18-30``): the bottom plane passes
    through (0,0,−distance) with the state normal; the expected range is the
    intersection parameter of the beam ray (origin, unit_direction)."""

    def h(chi: BottomState) -> jax.Array:
        bottom = jnp.stack(
            [jnp.zeros((), z.dtype), jnp.zeros((), z.dtype), -chi.distance[0]]
        )
        n = chi.normal
        v = mm(unit_direction, n)
        safe_v = jnp.where(v == 0.0, jnp.ones_like(v), v)
        expected = mm(bottom - origin, n) / safe_v
        return jnp.where(v == 0.0, jnp.zeros_like(expected), expected)[None]

    mu, cov, info = ukf.update(
        BOTTOM_MANIFOLD, state.mu, state.cov, jnp.atleast_1d(z), h, jnp.atleast_2d(meas_cov)
    )
    return state._replace(mu=mu, cov=cov), info


def update_normal(
    state: BottomUKFState, z: jax.Array, meas_cov: jax.Array
) -> tuple[BottomUKFState, ukf.UpdateInfo]:
    """Direct bottom-normal observation — an S²-valued measurement
    (``measurementNormal`` + ``integrateMeasurement`` at ``BottomUKF.cpp:32-37,63-67``)."""
    mu, cov, info = ukf.update(
        BOTTOM_MANIFOLD,
        state.mu,
        state.cov,
        z,
        lambda chi: chi.normal,
        meas_cov,
        meas_manifold=mf.S2_MANIFOLD,
    )
    return state._replace(mu=mu, cov=cov), info


def set_velocity(state: BottomUKFState, velocity: jax.Array) -> BottomUKFState:
    """Velocity is an input to the next prediction (``BottomUKF.cpp:69-72``)."""
    return state._replace(velocity=velocity)


# ---------------------------------------------------------------------------
# Bank-level entry points — mirror the pose/velocity bank APIs.
# ``set_velocity`` already works bankwide (pure _replace).
# ---------------------------------------------------------------------------


def predict_bank(bstate: BottomUKFState, params: BottomUKFParams, dt) -> BottomUKFState:
    """Bank-level prediction, ``vmap(predict)``. A banked ``process_noise``
    (leading bank axis — Monte-Carlo sweeps) is vmapped alongside."""
    if params.process_noise.ndim == 3:
        return jax.vmap(lambda s, p: predict(s, p, dt))(bstate, params)
    return jax.vmap(lambda s: predict(s, params, dt))(bstate)


def update_range_bank(bstate, z, meas_cov, unit_direction, origin):
    """Bank-level per-beam DVL range update; ``unit_direction``/``origin``
    may be shared ``(3,)`` or per-instance ``(B, 3)``."""
    nb = bstate.cov.shape[0]
    dtype = bstate.cov.dtype
    d = jnp.broadcast_to(jnp.asarray(unit_direction, dtype), (nb, 3))
    o = jnp.broadcast_to(jnp.asarray(origin, dtype), (nb, 3))
    rr = jnp.broadcast_to(jnp.asarray(meas_cov, dtype), (nb, 1, 1))
    return jax.vmap(update_range)(bstate, jnp.asarray(z, dtype).reshape(nb, 1), rr, d, o)


def update_normal_bank(bstate, z, meas_cov):
    """Bank-level S²-valued normal observation."""
    dtype = bstate.cov.dtype
    rr = jnp.broadcast_to(jnp.asarray(meas_cov, dtype), (bstate.cov.shape[0], 2, 2))
    return jax.vmap(update_normal)(bstate, jnp.asarray(z, dtype), rr)


class BottomUKF:
    """Object-style wrapper mirroring the reference class (``BottomUKF.hpp:27-52``)."""

    def __init__(self, initial_state: BottomState, state_cov):
        self.state, self.params = init(initial_state, jnp.asarray(state_cov))

    def prediction_step(self, dt: float) -> None:
        self.state = predict(self.state, self.params, dt)

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (``setProcessNoiseCovariance``)."""
        self.params = self.params._replace(process_noise=jnp.asarray(q))

    def integrate_range_measurement(self, mu, cov, unit_direction, origin) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = update_range(
            self.state,
            jnp.asarray(mu),
            jnp.asarray(cov),
            jnp.asarray(unit_direction),
            jnp.asarray(origin),
        )
        return info

    def integrate_normal_measurement(self, mu, cov) -> ukf.UpdateInfo:
        self.state, info = update_normal(self.state, jnp.asarray(mu), jnp.asarray(cov))
        return info

    def set_velocity(self, velocity) -> None:
        self.state = set_velocity(self.state, jnp.asarray(velocity))

    @property
    def mu(self) -> BottomState:
        return self.state.mu

    @property
    def sigma(self) -> jax.Array:
        return self.state.cov
