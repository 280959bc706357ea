"""VelocityUKF — model-aided velocity filter.

Re-implements the reference ``VelocityUKF`` (``/root/reference/src/VelocityUKF.hpp``,
``src/VelocityUKF.cpp``): a 4-DOF UKF over {velocity ℝ³, z_position ℝ¹}
(``VelocityUKF.hpp:24-27``) whose *process model is the AUV forward dynamics* —
each sigma point is pushed through one step of the motion simulator driven by
the latest thruster efforts and gyro rates (``VelocityUKF.cpp:6-33``), giving
high-rate velocity between DVL fixes.

Architecture: the reference's two stateful ``ModelSimulation`` objects
(``motion_model`` tracking orientation + ``prediction_model`` for sigma
propagation, ``VelocityUKF.cpp:58-77``) become explicit state threading — the
tracker state lives inside :class:`VelocityUKFState` and the per-sigma-point
simulation is a pure function, so ``vmap`` over sigma points (and over filter
banks) is free.

Inputs-vs-updates pattern (``VelocityUKF.cpp:87-104``): gyro and body-effort
"measurements" are cached as inputs to the next prediction; DVL and pressure
are synchronous UKF updates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import dynamics as dyn
from ..ops import manifolds as mf
from ..ops import ukf
from ..utils.validation import check_measurement

__all__ = [
    "VelocityState",
    "VELOCITY_MANIFOLD",
    "VelocityUKFState",
    "VelocityUKFParams",
    "init",
    "initial_filter_state",
    "default_process_noise",
    "predict",
    "predict_bank",
    "update_dvl",
    "update_dvl_bank",
    "update_pressure",
    "update_pressure_bank",
    "integrate_gyro",
    "integrate_body_efforts",
    "VelocityUKF",
]


class VelocityState(NamedTuple):
    """The ``MTK_BUILD_MANIFOLD(VelocityState, ...)`` of ``VelocityUKF.hpp:24-27``."""

    velocity: jax.Array  # (3,) body-frame linear velocity
    z_position: jax.Array  # (1,) depth coordinate (z in nav frame)


VELOCITY_MANIFOLD = mf.make_manifold(
    mf.Field("velocity", "vec", 3),
    mf.Field("z_position", "vec", 1),
)  # DOF = 4 → 9 sigma points


class VelocityUKFParams(NamedTuple):
    """Static-per-run parameters: vehicle model + process noise.

    ``process_noise`` reproduces the reference ctor's
    ``MTK::setDiagonal(process_noise_cov, &WState::velocity, 0.0001)``
    (``VelocityUKF.cpp:54-55``): velocity diag 1e-4, z_position diag 0.
    """

    model: dyn.UWVParameters
    process_noise: jax.Array  # (4,4)


class VelocityUKFState(NamedTuple):
    """Full filter state as one pytree (leading-axis batchable)."""

    mu: VelocityState
    cov: jax.Array  # (4,4)
    body_efforts: jax.Array  # (6,) latest thruster efforts (input cache)
    angular_velocity: jax.Array  # (3,) latest gyro rates (input cache)
    model_state: dyn.PoseVelocityState  # the ``motion_model`` orientation tracker


def default_process_noise(dtype=jnp.float64) -> jax.Array:
    q = jnp.zeros((4, 4), dtype=dtype)
    return q.at[:3, :3].set(1e-4 * jnp.eye(3, dtype=dtype))


def initial_filter_state(initial_state: VelocityState, state_cov: jax.Array) -> VelocityUKFState:
    """Filter-state construction of the reference ctor (``VelocityUKF.cpp:49-56``):
    the orientation tracker starts at the origin with identity orientation
    and the filter's current velocity; input caches zero."""
    dtype = initial_state.velocity.dtype
    return VelocityUKFState(
        mu=initial_state,
        cov=jnp.asarray(state_cov, dtype=dtype),
        body_efforts=jnp.zeros(6, dtype=dtype),
        angular_velocity=jnp.zeros(3, dtype=dtype),
        model_state=dyn.PoseVelocityState(
            position=jnp.zeros(3, dtype=dtype),
            orientation=mf.quat_identity(dtype),
            linear_velocity=initial_state.velocity,
            angular_velocity=jnp.zeros(3, dtype=dtype),
        ),
    )


def init(
    initial_state: VelocityState,
    state_cov: jax.Array,
    model: dyn.UWVParameters,
) -> tuple[VelocityUKFState, VelocityUKFParams]:
    """Construct filter state + params — the reference ctor
    (``VelocityUKF.cpp:49-56``) fused with ``setupMotionModel``
    (``VelocityUKF.cpp:58-77``)."""
    dtype = initial_state.velocity.dtype
    params = VelocityUKFParams(model=model, process_noise=default_process_noise(dtype))
    return initial_filter_state(initial_state, state_cov), params


def _process_motion_model(
    chi: VelocityState,
    params: VelocityUKFParams,
    orientation: jax.Array,
    angular_velocity: jax.Array,
    body_efforts: jax.Array,
    dt,
) -> VelocityState:
    """Per-sigma-point process model — ``processMotionModel`` of
    ``VelocityUKF.cpp:6-33``: seed the simulator with the sigma point's
    velocity, advance one dynamics step, keep the velocity delta, and
    integrate depth with the rotated *new* velocity."""
    seed = dyn.PoseVelocityState(
        position=jnp.zeros(3, dtype=chi.velocity.dtype),
        orientation=orientation,
        linear_velocity=chi.velocity,
        angular_velocity=angular_velocity,
    )
    sim = dyn.simulate_effort(params.model, seed, body_efforts, dt, integrate_pose=False)
    new_velocity = sim.linear_velocity
    z_vel = mf.quat_rotate(orientation, new_velocity)[2]
    return VelocityState(
        velocity=new_velocity,
        z_position=chi.z_position + dt * z_vel[None],
    )


def predict(state: VelocityUKFState, params: VelocityUKFParams, dt) -> VelocityUKFState:
    """Prediction step — ``VelocityUKF::predictionStepImpl`` (``VelocityUKF.cpp:114-130``).

    1. sigma propagation through the dynamics with the tracker's orientation,
       Q = dt·process_noise (note: *linear* dt scaling, unlike PoseUKF's dt²);
    2. advance the orientation tracker one full kinematic step with the same
       efforts (``VelocityUKF.cpp:126-127``).
    """
    orientation = state.model_state.orientation

    def f(chi):
        return _process_motion_model(
            chi, params, orientation, state.angular_velocity, state.body_efforts, dt
        )

    mu, cov = ukf.predict(VELOCITY_MANIFOLD, state.mu, state.cov, f, dt * params.process_noise)
    tracker = dyn.simulate_effort(
        params.model, state.model_state, state.body_efforts, dt, integrate_pose=True
    )
    return state._replace(mu=mu, cov=cov, model_state=tracker)


def update_dvl(
    state: VelocityUKFState, z: jax.Array, cov: jax.Array
) -> tuple[VelocityUKFState, ukf.UpdateInfo]:
    """DVL velocity update — direct observation of the velocity sub-state
    (``measurementDVL``, ``VelocityUKF.cpp:35-40,79-85``); accept-any gate."""
    mu, c, info = ukf.update(
        VELOCITY_MANIFOLD, state.mu, state.cov, z, lambda s: s.velocity, cov
    )
    return state._replace(mu=mu, cov=c), info


def update_pressure(
    state: VelocityUKFState, z: jax.Array, cov: jax.Array
) -> tuple[VelocityUKFState, ukf.UpdateInfo]:
    """Pressure-derived depth update — observes z_position directly
    (``measurementPressureSensor``, ``VelocityUKF.cpp:42-47,106-112``)."""
    mu, c, info = ukf.update(
        VELOCITY_MANIFOLD, state.mu, state.cov, z, lambda s: s.z_position, cov
    )
    return state._replace(mu=mu, cov=c), info


# ---------------------------------------------------------------------------
# Bank-level entry points (leading bank axis on every state leaf) — mirror
# pose_ukf.predict_bank/update_*_bank.
# ---------------------------------------------------------------------------


def _params_banked(params: VelocityUKFParams) -> bool:
    """True when ANY parameter leaf carries a bank axis (Monte-Carlo sweep):
    the vehicle model's matrices count, not just the process noise."""
    return params.process_noise.ndim == 3 or params.model.inertia_matrix.ndim == 3


def _broadcast_params_bank(params: VelocityUKFParams, nb: int) -> VelocityUKFParams:
    """Give every parameter leaf a bank axis, so a sweep that banks only some
    leaves (e.g. the vehicle model but not the process noise) still vmaps."""

    def b(leaf, unbanked_ndim):
        leaf = jnp.asarray(leaf)
        if leaf.ndim == unbanked_ndim:
            return jnp.broadcast_to(leaf, (nb, *leaf.shape))
        return leaf

    m = params.model
    model = m._replace(
        inertia_matrix=b(m.inertia_matrix, 2),
        damping_linear=b(m.damping_linear, 2),
        damping_quadratic=b(m.damping_quadratic, 2),
        weight=b(m.weight, 0),
        buoyancy=b(m.buoyancy, 0),
        cog=b(m.cog, 1),
        cob=b(m.cob, 1),
    )
    return params._replace(model=model, process_noise=b(params.process_noise, 2))


def predict_bank(
    bstate: VelocityUKFState, params: VelocityUKFParams, dt
) -> VelocityUKFState:
    """Bank-level prediction: ``vmap(predict)`` over the bank. Parameter
    sweeps (banked ``params``, any leaf) vmap the parameters alongside."""
    if _params_banked(params):  # per-instance parameter bank (sweeps)
        pb = _broadcast_params_bank(params, bstate.cov.shape[0])
        return jax.vmap(lambda s, p: predict(s, p, dt))(bstate, pb)
    return jax.vmap(lambda s: predict(s, params, dt))(bstate)


def _update_bank(fn, bstate, z, meas_cov):
    rr = jnp.broadcast_to(
        jnp.asarray(meas_cov, bstate.cov.dtype), (bstate.cov.shape[0], z.shape[-1], z.shape[-1])
    )
    return jax.vmap(fn)(bstate, z, rr)


def update_dvl_bank(bstate, z, meas_cov):
    """Bank-level DVL update (``src/VelocityUKF.cpp:79-85``)."""
    return _update_bank(update_dvl, bstate, z, meas_cov)


def update_pressure_bank(bstate, z, meas_cov):
    """Bank-level pressure→depth update (``src/VelocityUKF.cpp:106-112``)."""
    return _update_bank(update_pressure, bstate, z, meas_cov)


def integrate_gyro(state: VelocityUKFState, rates: jax.Array) -> VelocityUKFState:
    """Gyro rates are an *input*, not an update (``VelocityUKF.cpp:87-98``):
    cache them and refresh the orientation tracker's angular velocity."""
    return state._replace(
        angular_velocity=rates,
        model_state=state.model_state._replace(angular_velocity=rates),
    )


def integrate_body_efforts(state: VelocityUKFState, efforts: jax.Array) -> VelocityUKFState:
    """Thruster efforts are an *input* (``VelocityUKF.cpp:100-104``)."""
    return state._replace(body_efforts=efforts)


# ---------------------------------------------------------------------------
# Object-style wrapper mirroring the reference class API (single instance).
# ---------------------------------------------------------------------------


class VelocityUKF:
    """Stateful convenience wrapper with the reference's class surface
    (``VelocityUKF.hpp:33-68``): construct, ``setup_motion_model``,
    ``integrate_*`` overloads, ``prediction_step``. All math delegates to the
    pure functions above (which is what batched/sharded deployments use)."""

    def __init__(self, initial_state: VelocityState, state_cov):
        # the filter is live from construction (reference ctor,
        # VelocityUKF.cpp:49-56); only PREDICTION needs the motion model
        self.state: VelocityUKFState = initial_filter_state(
            initial_state, jnp.asarray(state_cov)
        )
        self.params: Optional[VelocityUKFParams] = None

    def setup_motion_model(self, model: dyn.UWVParameters) -> bool:
        """Set or swap the vehicle model (``VelocityUKF.cpp:58-77``) —
        PRESERVES the current estimate and input caches; the orientation
        tracker's velocity is re-seeded from the current mean, as the
        reference seeds it from ``getCurrentState``."""
        dtype = self.state.mu.velocity.dtype
        self.params = VelocityUKFParams(
            model=model, process_noise=default_process_noise(dtype)
        )
        self.state = self.state._replace(
            model_state=self.state.model_state._replace(
                linear_velocity=self.state.mu.velocity
            )
        )
        return True

    def _require_model(self):
        # mirrors the reference's runtime error (VelocityUKF.cpp:117-118)
        if self.params is None:
            raise RuntimeError("Motion model is not initialized!")

    def prediction_step(self, dt: float) -> None:
        self._require_model()
        self.state = predict(self.state, self.params, dt)

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (the reference assigns
        ``process_noise_cov`` at ``src/VelocityUKF.cpp:54-56``)."""
        self._require_model()
        self.params = self.params._replace(process_noise=jnp.asarray(q))

    def integrate_dvl_measurement(self, mu, cov) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = update_dvl(self.state, jnp.asarray(mu), jnp.asarray(cov))
        return info

    def integrate_pressure_measurement(self, mu, cov) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = update_pressure(self.state, jnp.asarray(mu), jnp.asarray(cov))
        return info

    def integrate_gyro_measurement(self, mu, cov=None) -> None:
        if cov is not None:
            check_measurement(mu, cov)
        self.state = integrate_gyro(self.state, jnp.asarray(mu))

    def integrate_body_efforts(self, mu, cov=None) -> None:
        if cov is not None:
            check_measurement(mu, cov)
        self.state = integrate_body_efforts(self.state, jnp.asarray(mu))

    # reference getCurrentState equivalent
    @property
    def mu(self) -> VelocityState:
        return self.state.mu

    @property
    def sigma(self) -> jax.Array:
        return self.state.cov
