"""PoseUKF — full model-aided inertial localization. The flagship.

Re-implements the reference ``PoseUKF`` (``/root/reference/src/PoseUKF.hpp``,
``src/PoseUKF.cpp``; algorithmic basis Arnold & Medagoda, ICRA 2018,
arXiv:1805.08011): a 53-DOF UKF estimating position/orientation/velocity/
acceleration of the IMU in an NWU navigation frame plus IMU biases, local
gravity, online-identified motion-model parameters (inertia, linear/quadratic
damping of the (x,y,ψ) sub-model), water currents at and below the vehicle,
ADCP bias and water density. Earth-rotation-aware attitude propagation enables
gyrocompassing with FOG-grade gyros (``PoseUKF.hpp:25-39``).

State manifold (``src/PoseState.hpp:29-45``): ℝ³×SO(3)×ℝ³×ℝ³×ℝ³×ℝ³×ℝ¹×ℝ⁹×ℝ⁹×ℝ⁹
×ℝ²×ℝ²×ℝ²×ℝ¹ = 53 DOF → 107 sigma points. Covariance block layout follows the
field declaration order exactly, so the reference's ``MTK::subblock``
addresses map to :meth:`ProductManifold.block` slices.

Design: every entry point is a pure function over the
(:class:`PoseUKFState`, :class:`PoseUKFParams`) pytrees. A Monte-Carlo sweep
over vehicles *and* parameters is ``jax.vmap`` over both arguments; the hot
covariance algebra (107×53 deviations) lowers to batched matmuls (see
``ops/ukf.py`` and ``ops/kernels.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import dynamics as dyn
from ..ops import geodesy as geo
from ..ops import manifolds as mf
from ..ops import ukf
from ..ops.linalg_small import mm
from ..utils import delayed_states
from ..utils.config import CameraConfiguration, PoseUKFConfig
from ..utils.validation import check_measurement

__all__ = [
    "PoseState",
    "POSE_MANIFOLD",
    "PoseStateWithMarker",
    "POSE_MARKER_MANIFOLD",
    "PoseUKFParams",
    "PoseUKFState",
    "initial_state_from_config",
    "initial_cov_from_config",
    "params_from_config",
    "process_noise_from_config",
    "init_from_pose",
    "init_from_state",
    "predict",
    "get_rotation_rate",
    "get_rotation_rate_bank",
    "update_velocity",
    "update_acceleration",
    "integrate_rotation_rate",
    "update_z_position",
    "update_xy_position",
    "update_delayed_position",
    "PoseStateWithDelayedPosition",
    "POSE_DELAYED_MANIFOLD",
    "update_delayed_position_with_augmentation",
    "push_delayed_state",
    "update_delayed_position_buffered",
    "update_pressure",
    "update_geographic_position",
    "update_body_efforts",
    "update_water_velocity",
    "update_visual_features",
    "update_geographic_position_bank",
    "update_delayed_position_bank",
    "update_delayed_position_with_augmentation_bank",
    "push_delayed_state_bank",
    "update_delayed_position_buffered_bank",
    "update_visual_features_bank",
    "reset_with_external_pose",
    "PoseUKF",
]


class PoseState(NamedTuple):
    """Field-for-field mirror of ``MTK_BUILD_MANIFOLD(PoseState, ...)``
    (``src/PoseState.hpp:29-45``); semantics quoted from the inline docs."""

    position: jax.Array  # (3,) IMU position in navigation (NWU) frame
    orientation: jax.Array  # (4,) quaternion [w,x,y,z], IMU in nav frame
    velocity: jax.Array  # (3,) IMU velocity in nav frame
    acceleration: jax.Array  # (3,) IMU acceleration in nav frame
    bias_gyro: jax.Array  # (3,)
    bias_acc: jax.Array  # (3,)
    gravity: jax.Array  # (1,) local gravity refinement
    inertia: jax.Array  # (3,3) (x,y,ψ) inertia sub-model, 9 DOF col-major
    lin_damping: jax.Array  # (3,3)
    quad_damping: jax.Array  # (3,3)
    water_velocity: jax.Array  # (2,) N/W current at the vehicle
    water_velocity_below: jax.Array  # (2,) N/W current below the vehicle
    bias_adcp: jax.Array  # (2,)
    water_density: jax.Array  # (1,) [kg/m³]


POSE_MANIFOLD = mf.make_manifold(
    mf.Field("position", "vec", 3),
    mf.Field("orientation", "so3"),
    mf.Field("velocity", "vec", 3),
    mf.Field("acceleration", "vec", 3),
    mf.Field("bias_gyro", "vec", 3),
    mf.Field("bias_acc", "vec", 3),
    mf.Field("gravity", "vec", 1),
    mf.Field("inertia", "mat33"),
    mf.Field("lin_damping", "mat33"),
    mf.Field("quad_damping", "mat33"),
    mf.Field("water_velocity", "vec", 2),
    mf.Field("water_velocity_below", "vec", 2),
    mf.Field("bias_adcp", "vec", 2),
    mf.Field("water_density", "vec", 1),
)  # DOF = 53 → 107 sigma points
assert POSE_MANIFOLD.dof == 53


class PoseStateWithMarker(NamedTuple):
    """``MTK_BUILD_MANIFOLD(PoseStateWithMarker, ...)`` (``src/PoseUKF.cpp:225-228``)
    flattened — 53 + 6 = 59 DOF → 119 sigma points. Augmentation is a second
    fixed-shape compiled path, not a dynamic resize (SURVEY.md §3.4)."""

    position: jax.Array
    orientation: jax.Array
    velocity: jax.Array
    acceleration: jax.Array
    bias_gyro: jax.Array
    bias_acc: jax.Array
    gravity: jax.Array
    inertia: jax.Array
    lin_damping: jax.Array
    quad_damping: jax.Array
    water_velocity: jax.Array
    water_velocity_below: jax.Array
    bias_adcp: jax.Array
    water_density: jax.Array
    marker_position: jax.Array  # (3,)
    marker_orientation: jax.Array  # (4,)


POSE_MARKER_MANIFOLD = mf.make_manifold(
    *POSE_MANIFOLD.fields,
    mf.Field("marker_position", "vec", 3),
    mf.Field("marker_orientation", "so3"),
)
assert POSE_MARKER_MANIFOLD.dof == 59


class PoseUKFParams(NamedTuple):
    """The reference's ``PoseUKFParameter`` (``src/PoseUKF.hpp:46-76``) plus
    everything else it keeps as filter members: first-order-Markov rest points
    (``src/PoseUKF.cpp:346-349``), the vehicle model, the geographic
    projection anchor and the assembled process noise. All leaves are arrays ⇒
    the whole object is sweepable under ``vmap`` for Monte-Carlo tuning."""

    imu_in_body: jax.Array  # (3,) IMU position in body frame
    gyro_bias_offset: jax.Array  # (3,)
    gyro_bias_tau: jax.Array  # ()
    acc_bias_offset: jax.Array  # (3,)
    acc_bias_tau: jax.Array  # ()
    inertia_tau: jax.Array  # ()
    lin_damping_tau: jax.Array  # ()
    quad_damping_tau: jax.Array  # ()
    water_velocity_tau: jax.Array  # ()
    water_velocity_limits: jax.Array  # ()
    water_velocity_scale: jax.Array  # ()
    adcp_bias_tau: jax.Array  # ()
    atmospheric_pressure: jax.Array  # ()
    water_density_tau: jax.Array  # ()
    inertia_offset: jax.Array  # (3,3) Markov rest point
    lin_damping_offset: jax.Array  # (3,3)
    quad_damping_offset: jax.Array  # (3,3)
    water_density_offset: jax.Array  # ()
    model: dyn.UWVParameters
    projection: geo.GeographicProjection
    process_noise: jax.Array  # (53,53)


class PoseUKFState(NamedTuple):
    mu: PoseState
    cov: jax.Array  # (53,53)
    rotation_rate: jax.Array  # (3,) cached IMU rates (input, PoseUKF.cpp:492-496)


# ---------------------------------------------------------------------------
# construction (PoseUKF ctors + setProcessNoiseFromConfig)
# ---------------------------------------------------------------------------


def initial_state_from_config(
    imu_in_nwu_pos: jax.Array,
    imu_in_nwu_rot: jax.Array,
    config: PoseUKFConfig,
    model_parameters: dyn.UWVParameters,
    imu_in_body_rot: Optional[jax.Array] = None,
    dtype=jnp.float64,
) -> PoseState:
    """Initial state assembly of the first ctor (``src/PoseUKF.cpp:293-321``):
    zero velocity/acceleration/currents/ADCP bias, biases rotated into the
    body frame, WGS-84 gravity, (x,y,ψ) blocks extracted from the 6×6 model."""
    rot_ib = (
        jnp.eye(3, dtype=dtype)
        if imu_in_body_rot is None
        else mf.quat_to_matrix(jnp.asarray(imu_in_body_rot, dtype))
    )
    gravity = geo.wgs84_gravity(
        jnp.asarray(config.location.latitude, dtype), jnp.asarray(config.location.altitude, dtype)
    )
    return PoseState(
        position=jnp.asarray(imu_in_nwu_pos, dtype),
        orientation=jnp.asarray(imu_in_nwu_rot, dtype),
        velocity=jnp.zeros(3, dtype),
        acceleration=jnp.zeros(3, dtype),
        bias_gyro=mm(rot_ib, jnp.asarray(config.rotation_rate.bias_offset, dtype)),
        bias_acc=mm(rot_ib, jnp.asarray(config.acceleration.bias_offset, dtype)),
        gravity=gravity[None].astype(dtype),
        inertia=dyn.extract_xy_yaw(jnp.asarray(model_parameters.inertia_matrix, dtype)),
        lin_damping=dyn.extract_xy_yaw(jnp.asarray(model_parameters.damping_linear, dtype)),
        quad_damping=dyn.extract_xy_yaw(jnp.asarray(model_parameters.damping_quadratic, dtype)),
        water_velocity=jnp.zeros(2, dtype),
        water_velocity_below=jnp.zeros(2, dtype),
        bias_adcp=jnp.zeros(2, dtype),
        water_density=jnp.asarray([config.hydrostatics.water_density], dtype),
    )


def _set_block(cov: jax.Array, name: str, value: jax.Array) -> jax.Array:
    s = POSE_MANIFOLD.block(name)
    return cov.at[s, s].set(value)


def initial_cov_from_config(
    imu_in_nwu_pos_cov: jax.Array,
    imu_in_nwu_rot_cov: jax.Array,
    config: PoseUKFConfig,
    imu_in_body_rot: Optional[jax.Array] = None,
    dtype=jnp.float64,
) -> jax.Array:
    """Blockwise initial covariance (``src/PoseUKF.cpp:323-342``)."""
    rot = (
        jnp.eye(3, dtype=dtype)
        if imu_in_body_rot is None
        else mf.quat_to_matrix(jnp.asarray(imu_in_body_rot, dtype))
    )
    c = jnp.zeros((53, 53), dtype=dtype)
    c = _set_block(c, "position", jnp.asarray(imu_in_nwu_pos_cov, dtype))
    c = _set_block(c, "orientation", jnp.asarray(imu_in_nwu_rot_cov, dtype))
    c = _set_block(c, "velocity", jnp.eye(3, dtype=dtype))  # unknown at start
    c = _set_block(c, "acceleration", 10.0 * jnp.eye(3, dtype=dtype))  # unknown at start
    gi = jnp.asarray(config.rotation_rate.bias_instability, dtype)
    ai = jnp.asarray(config.acceleration.bias_instability, dtype)
    c = _set_block(c, "bias_gyro", mm(rot, jnp.diag(gi**2), rot.T))
    c = _set_block(c, "bias_acc", mm(rot, jnp.diag(ai**2), rot.T))
    c = _set_block(c, "gravity", jnp.asarray([[0.05**2]], dtype))  # 5 cm/s² 1σ
    mnp = config.model_noise_parameters
    c = _set_block(c, "inertia", jnp.diag(jnp.asarray(mnp.inertia_instability, dtype) ** 2))
    c = _set_block(c, "lin_damping", jnp.diag(jnp.asarray(mnp.lin_damping_instability, dtype) ** 2))
    c = _set_block(
        c, "quad_damping", jnp.diag(jnp.asarray(mnp.quad_damping_instability, dtype) ** 2)
    )
    wv = config.water_velocity
    c = _set_block(c, "water_velocity", wv.limits**2 * jnp.eye(2, dtype=dtype))
    c = _set_block(c, "water_velocity_below", wv.limits**2 * jnp.eye(2, dtype=dtype))
    c = _set_block(c, "bias_adcp", wv.adcp_bias_limits**2 * jnp.eye(2, dtype=dtype))
    c = _set_block(
        c, "water_density", jnp.asarray([[config.hydrostatics.water_density_limits**2]], dtype)
    )
    return c


def process_noise_from_config(
    config: PoseUKFConfig,
    imu_delta_t: float,
    imu_in_body_rot: Optional[jax.Array] = None,
    dtype=jnp.float64,
) -> jax.Array:
    """``setProcessNoiseFromConfig`` (``src/PoseUKF.cpp:393-439``): Euler
    integration error terms from max_jerk for position/velocity/acceleration,
    first-order-Markov 2/(τ·dt)·instability² for biases and model parameters."""
    rot = (
        jnp.eye(3, dtype=dtype)
        if imu_in_body_rot is None
        else mf.quat_to_matrix(jnp.asarray(imu_in_body_rot, dtype))
    )
    dt = imu_delta_t
    jerk = jnp.asarray(config.max_jerk, dtype)
    q = jnp.zeros((53, 53), dtype=dtype)
    # position: 1.5·(dt⁴·((1/6)·¼·jerk)²);  velocity: 1.5·(dt²·(½·¼·jerk)²)
    q = _set_block(q, "position", 1.5 * jnp.diag(dt**4 * ((1.0 / 6.0) * 0.25 * jerk) ** 2))
    q = _set_block(q, "velocity", 1.5 * jnp.diag(dt**2 * (0.5 * 0.25 * jerk) ** 2))
    q = _set_block(q, "acceleration", jnp.diag((0.25 * jerk) ** 2))
    rw = jnp.asarray(config.rotation_rate.randomwalk, dtype)
    q = _set_block(q, "orientation", mm(rot, jnp.diag(rw**2), rot.T))
    gi = jnp.asarray(config.rotation_rate.bias_instability, dtype)
    q = _set_block(
        q, "bias_gyro", mm(rot, (2.0 / (config.rotation_rate.bias_tau * dt)) * jnp.diag(gi**2), rot.T)
    )
    ai = jnp.asarray(config.acceleration.bias_instability, dtype)
    q = _set_block(
        q, "bias_acc", mm(rot, (2.0 / (config.acceleration.bias_tau * dt)) * jnp.diag(ai**2), rot.T)
    )
    q = _set_block(q, "gravity", jnp.asarray([[1e-12]], dtype))  # numeric stability only
    mnp = config.model_noise_parameters
    q = _set_block(
        q,
        "inertia",
        (2.0 / (mnp.inertia_tau * dt)) * jnp.diag(jnp.asarray(mnp.inertia_instability, dtype) ** 2),
    )
    q = _set_block(
        q,
        "lin_damping",
        (2.0 / (mnp.lin_damping_tau * dt))
        * jnp.diag(jnp.asarray(mnp.lin_damping_instability, dtype) ** 2),
    )
    q = _set_block(
        q,
        "quad_damping",
        (2.0 / (mnp.quad_damping_tau * dt))
        * jnp.diag(jnp.asarray(mnp.quad_damping_instability, dtype) ** 2),
    )
    wv = config.water_velocity
    q = _set_block(
        q, "water_velocity", (2.0 / (wv.tau * dt)) * wv.limits**2 * jnp.eye(2, dtype=dtype)
    )
    q = _set_block(
        q, "water_velocity_below", (2.0 / (wv.tau * dt)) * wv.limits**2 * jnp.eye(2, dtype=dtype)
    )
    q = _set_block(
        q, "bias_adcp", (2.0 / (wv.adcp_bias_tau * dt)) * wv.adcp_bias_limits**2 * jnp.eye(2, dtype=dtype)
    )
    hyd = config.hydrostatics
    q = _set_block(
        q,
        "water_density",
        jnp.asarray([[(2.0 / (hyd.water_density_tau * dt)) * hyd.water_density_limits**2]], dtype),
    )
    return q


def params_from_config(
    config: PoseUKFConfig,
    model_parameters: dyn.UWVParameters,
    initial_state: PoseState,
    imu_delta_t: float = 0.01,
    imu_in_body_rot: Optional[jax.Array] = None,
    imu_in_body_trans: Optional[jax.Array] = None,
    dtype=jnp.float64,
) -> PoseUKFParams:
    """``PoseUKFParameter`` population + Markov rest-point snapshot
    (``src/PoseUKF.cpp:346-371``) + process-noise assembly."""
    rot = (
        jnp.eye(3, dtype=dtype)
        if imu_in_body_rot is None
        else mf.quat_to_matrix(jnp.asarray(imu_in_body_rot, dtype))
    )
    t = (
        jnp.zeros(3, dtype=dtype)
        if imu_in_body_trans is None
        else jnp.asarray(imu_in_body_trans, dtype)
    )
    wv, hyd = config.water_velocity, config.hydrostatics
    return PoseUKFParams(
        imu_in_body=t,
        gyro_bias_offset=mm(rot, jnp.asarray(config.rotation_rate.bias_offset, dtype)),
        gyro_bias_tau=jnp.asarray(config.rotation_rate.bias_tau, dtype),
        acc_bias_offset=mm(rot, jnp.asarray(config.acceleration.bias_offset, dtype)),
        acc_bias_tau=jnp.asarray(config.acceleration.bias_tau, dtype),
        inertia_tau=jnp.asarray(config.model_noise_parameters.inertia_tau, dtype),
        lin_damping_tau=jnp.asarray(config.model_noise_parameters.lin_damping_tau, dtype),
        quad_damping_tau=jnp.asarray(config.model_noise_parameters.quad_damping_tau, dtype),
        water_velocity_tau=jnp.asarray(wv.tau, dtype),
        water_velocity_limits=jnp.asarray(wv.limits, dtype),
        water_velocity_scale=jnp.asarray(wv.scale, dtype),
        adcp_bias_tau=jnp.asarray(wv.adcp_bias_tau, dtype),
        atmospheric_pressure=jnp.asarray(hyd.atmospheric_pressure, dtype),
        water_density_tau=jnp.asarray(hyd.water_density_tau, dtype),
        inertia_offset=initial_state.inertia,
        lin_damping_offset=initial_state.lin_damping,
        quad_damping_offset=initial_state.quad_damping,
        water_density_offset=initial_state.water_density[0],
        model=jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), model_parameters),
        projection=geo.make_projection(config.location.latitude, config.location.longitude, dtype),
        process_noise=process_noise_from_config(config, imu_delta_t, imu_in_body_rot, dtype),
    )


def init_from_pose(
    imu_in_nwu_pos,
    imu_in_nwu_pos_cov,
    imu_in_nwu_rot,
    imu_in_nwu_rot_cov,
    config: PoseUKFConfig,
    model_parameters: dyn.UWVParameters,
    imu_delta_t: float = 0.01,
    imu_in_body_rot=None,
    imu_in_body_trans=None,
    dtype=jnp.float64,
) -> tuple[PoseUKFState, PoseUKFParams]:
    """First ctor (``src/PoseUKF.cpp:288-372``) + ``setProcessNoiseFromConfig``."""
    mu = initial_state_from_config(
        imu_in_nwu_pos, imu_in_nwu_rot, config, model_parameters, imu_in_body_rot, dtype
    )
    cov = initial_cov_from_config(
        imu_in_nwu_pos_cov, imu_in_nwu_rot_cov, config, imu_in_body_rot, dtype
    )
    params = params_from_config(
        config, model_parameters, mu, imu_delta_t, imu_in_body_rot, imu_in_body_trans, dtype
    )
    state = PoseUKFState(mu=mu, cov=cov, rotation_rate=jnp.zeros(3, dtype))
    return state, params


def init_from_state(
    initial_state: PoseState, state_cov: jax.Array, params: PoseUKFParams
) -> PoseUKFState:
    """Second ctor (``src/PoseUKF.cpp:374-391``): resume from an explicit
    state/covariance — also the checkpoint-restore path."""
    dtype = initial_state.position.dtype
    return PoseUKFState(
        mu=initial_state,
        cov=jnp.asarray(state_cov, dtype),
        rotation_rate=jnp.zeros(3, dtype),
    )


# ---------------------------------------------------------------------------
# process model + prediction (the hot path)
# ---------------------------------------------------------------------------


def _process_model(
    chi: PoseState, rotation_rate: jax.Array, params: PoseUKFParams, dt
) -> PoseState:
    """``processModel`` (``src/PoseUKF.cpp:12-84``), per sigma point."""
    # position ⊞ velocity·dt
    position = chi.position + dt * chi.velocity
    # earth rotation at the (per-sigma-point) latitude
    lat, _ = geo.nav_to_world(params.projection, chi.position[0], chi.position[1])
    earth_rot = geo.earth_rotation_nav(lat).astype(chi.position.dtype)
    # nav-frame angular velocity; orientation ⊞ ω·dt
    angular_velocity = mf.quat_rotate(chi.orientation, rotation_rate - chi.bias_gyro) - earth_rot
    orientation = mf.so3_boxplus(chi.orientation, angular_velocity, dt)
    # velocity ⊞ acceleration·dt
    velocity = chi.velocity + dt * chi.acceleration

    # first-order Markov decays toward the rest points (:37-78)
    def decay(x, offset, tau):
        return x + dt * (-1.0 / tau) * (x - offset)

    return PoseState(
        position=position,
        orientation=orientation,
        velocity=velocity,
        acceleration=chi.acceleration,  # random walk — driven by noise only
        bias_gyro=decay(chi.bias_gyro, params.gyro_bias_offset, params.gyro_bias_tau),
        bias_acc=decay(chi.bias_acc, params.acc_bias_offset, params.acc_bias_tau),
        gravity=chi.gravity,
        inertia=decay(chi.inertia, params.inertia_offset, params.inertia_tau),
        lin_damping=decay(chi.lin_damping, params.lin_damping_offset, params.lin_damping_tau),
        quad_damping=decay(chi.quad_damping, params.quad_damping_offset, params.quad_damping_tau),
        water_velocity=decay(chi.water_velocity, 0.0, params.water_velocity_tau),
        water_velocity_below=decay(chi.water_velocity_below, 0.0, params.water_velocity_tau),
        bias_adcp=decay(chi.bias_adcp, 0.0, params.adcp_bias_tau),
        water_density=decay(chi.water_density, params.water_density_offset, params.water_density_tau),
    )


def _block_selector(name: str, dtype) -> jax.Array:
    """(53, k) constant selector E with Iₖ at the block's rows: E·B·Eᵀ embeds
    a k×k block densely — a tiny batched matmul instead of a per-instance
    scatter."""
    s = POSE_MANIFOLD.block(name)
    e = jnp.zeros((POSE_MANIFOLD.dof, s.stop - s.start), dtype)
    return e.at[s, :].set(jnp.eye(s.stop - s.start, dtype=dtype))


def _diag_mask(names: tuple[str, ...], dtype) -> jax.Array:
    d = jnp.zeros(POSE_MANIFOLD.dof, dtype)
    for name in names:
        d = d.at[POSE_MANIFOLD.block(name)].set(1.0)
    return jnp.diag(d)


def assemble_process_noise(mu: PoseState, params: PoseUKFParams, dt) -> jax.Array:
    """Per-step process noise of ``predictionStepImpl``
    (``src/PoseUKF.cpp:448-460``): rotate the orientation noise into the nav
    frame with the pre-predict orientation, inflate the water-current noise
    with the z-weighted speed, scale the whole Q by dt².

    Assembled densely (selector-matrix embedding and a diagonal mask — both
    trace-time constants) so a vmapped bank sees batched matmuls, never
    per-instance scatters. Shared by :func:`predict` and the smoother's
    backward pass (``models/pose_smoother.py``)."""
    rot = mf.quat_to_matrix(mu.orientation)
    q0 = params.process_noise
    so = POSE_MANIFOLD.block("orientation")
    e_rot = _block_selector("orientation", q0.dtype)
    # mask that zeroes the whole 3×3 orientation block (it gets replaced)
    ori_zero = 1.0 - mm(e_rot, jnp.ones((3, 3), q0.dtype), e_rot.T)
    ori_new = mm(e_rot, mm(rot, q0[so, so], rot.T), e_rot.T)

    scaled_velocity = mu.velocity * jnp.asarray([1.0, 1.0, 10.0], mu.velocity.dtype)
    wv_extra = params.water_velocity_scale * mm(scaled_velocity, scaled_velocity) * dt
    wv_mask = _diag_mask(("water_velocity", "water_velocity_below"), q0.dtype)

    # pin Q to the configured process-noise dtype: float64 scalar params (e.g.
    # water_velocity_scale) must not promote an f32 filter's covariance
    return (dt**2 * (q0 * ori_zero + ori_new + wv_extra * wv_mask)).astype(q0.dtype)


def predict(state: PoseUKFState, params: PoseUKFParams, dt) -> PoseUKFState:
    """``predictionStepImpl`` (``src/PoseUKF.cpp:446-474``): assemble the
    state-dependent Q, then unscented-predict through the process model."""
    q = assemble_process_noise(state.mu, params, dt)
    mu, cov = ukf.predict(
        POSE_MANIFOLD, state.mu, state.cov, lambda chi: _process_model(chi, state.rotation_rate, params, dt), q
    )
    return state._replace(mu=mu, cov=cov)


def predict_bank(bstate: PoseUKFState, params: PoseUKFParams, dt) -> PoseUKFState:
    """Bank-level prediction (leading bank axis on every state leaf):
    ``vmap(predict)``. Both shared and banked (Monte-Carlo sweep) parameter
    sets are supported."""
    if params.process_noise.ndim == 3:  # per-instance parameter bank
        return jax.vmap(lambda s, p: predict(s, p, dt))(bstate, params)
    return jax.vmap(lambda s: predict(s, params, dt))(bstate)


def update_bank(
    bstate: PoseUKFState,
    params: PoseUKFParams,
    z: jax.Array,
    meas_cov: jax.Array,
    h,
    gate_threshold=None,
    *,
    params_independent: bool = False,
) -> tuple[PoseUKFState, "ukf.UpdateInfo"]:
    """Bank-level unscented update with a vector measurement model ``h``:
    ``vmap(ukf.update)`` over the bank. ``params_independent=True`` declares
    that ``h`` reads no parameters, which makes the update valid for banked
    (Monte-Carlo sweep) parameter sets too."""
    if params.process_noise.ndim == 3 and not params_independent:
        # ``h`` is already closed over the (banked) params, so a state-only
        # vmap cannot evaluate it per instance — sweep measurement updates
        # via the per-instance functions instead.
        raise ValueError(
            "update_bank received a banked parameter set; use "
            "jax.vmap(update_<sensor>)(state, params, ...) for parameter "
            "sweeps (predict_bank supports banked params directly)"
        )

    def one(s_mu, s_cov, zz, rr):
        mu, cov, info = ukf.update(
            POSE_MANIFOLD, s_mu, s_cov, zz, h, rr, gate_threshold=gate_threshold
        )
        return mu, cov, info

    rr_b = jnp.broadcast_to(
        jnp.asarray(meas_cov, bstate.cov.dtype), (bstate.cov.shape[0], z.shape[-1], z.shape[-1])
    )
    mu, cov, info = jax.vmap(one)(bstate.mu, bstate.cov, z, rr_b)
    return bstate._replace(mu=mu, cov=cov), info


def _update_bank_per_instance(bstate, z, meas_cov, make_h, aux, gate_threshold=None):
    """Bank update whose measurement model differs per instance:
    ``make_h(aux_i)`` builds instance i's model from its row of ``aux``."""
    dtype = bstate.cov.dtype
    nb = bstate.cov.shape[0]
    z = jnp.asarray(z, dtype)
    rr_b = jnp.broadcast_to(jnp.asarray(meas_cov, dtype), (nb, z.shape[-1], z.shape[-1]))

    def one(s_mu, s_cov, zz, rr, a):
        return ukf.update(
            POSE_MANIFOLD, s_mu, s_cov, zz, make_h(a), rr, gate_threshold=gate_threshold
        )

    mu, cov, info = jax.vmap(one)(bstate.mu, bstate.cov, z, rr_b, aux)
    return bstate._replace(mu=mu, cov=cov), info


def update_velocity_bank(bstate, params, z, meas_cov):
    """Bank-level DVL velocity update (``PoseUKF.cpp:117-123,476-482``)."""
    return update_bank(bstate, params, z, meas_cov, _h_velocity, params_independent=True)


def update_acceleration_bank(bstate, params, z, meas_cov):
    """Bank-level IMU specific-force update (``PoseUKF.cpp:125-131,484-490``)."""
    return update_bank(bstate, params, z, meas_cov, _h_acceleration, params_independent=True)


def update_z_position_bank(bstate, params, z, meas_cov):
    """Bank-level depth update (``PoseUKF.cpp:100-105,498-504``)."""
    return update_bank(bstate, params, z, meas_cov, _h_z_position, params_independent=True)


def update_xy_position_bank(bstate, params, z, meas_cov, gate_threshold=None):
    """Bank-level XY position update (``PoseUKF.cpp:87-92,506-512``);
    pass ``gate_threshold=ukf.D2P95`` for the GPS path (``:567-579``)."""
    return update_bank(
        bstate, params, z, meas_cov, _h_xy_position, gate_threshold, params_independent=True
    )


def update_pressure_bank(bstate, params, z, meas_cov, pressure_sensor_in_imu=None):
    """Bank-level hydrostatic-pressure update (``PoseUKF.cpp:107-115,559-565``).

    The one parameter the model reads, ``params.atmospheric_pressure``, may be
    banked (Monte-Carlo sweeps): per-instance values go through a
    per-instance ``vmap`` — a partially-banked set (banked ``process_noise``,
    shared pressure) is broadcast."""
    dtype = bstate.cov.dtype
    lever = (
        jnp.zeros(3, dtype)
        if pressure_sensor_in_imu is None
        else jnp.asarray(pressure_sensor_in_imu, dtype)
    )
    if params.process_noise.ndim == 3 or jnp.ndim(params.atmospheric_pressure) >= 1:
        nb = bstate.cov.shape[0]
        p_atm = jnp.broadcast_to(
            jnp.asarray(params.atmospheric_pressure, dtype).reshape(-1), (nb,)
        )
        return _update_bank_per_instance(
            bstate, z, meas_cov, lambda pa: _h_pressure(pa, lever), p_atm
        )
    return update_bank(
        bstate, params, z, meas_cov, _h_pressure(params.atmospheric_pressure, lever)
    )


def update_water_velocity_bank(bstate, params, z, meas_cov, cell_weighting):
    """Bank-level ADCP water-current update, χ²-95 gated
    (``PoseUKF.cpp:133-151,604-611``). ``cell_weighting`` may be a shared
    scalar or a (B,) array — each instance's ADCP cell is an independent
    measurement attribute."""
    cw = jnp.asarray(cell_weighting, bstate.cov.dtype)
    if cw.ndim == 1:  # per-instance cell weightings
        return _update_bank_per_instance(
            bstate, z, meas_cov, _h_water_velocity, cw, ukf.D2P95
        )
    return update_bank(
        bstate, params, z, meas_cov, _h_water_velocity(cell_weighting),
        ukf.D2P95, params_independent=True,
    )


def update_body_efforts_bank(bstate, params, z, meas_cov, rotation_rate_body):
    """Bank-level model-aided effort update (``PoseUKF.cpp:153-196,581-602``,
    full mode). ``rotation_rate_body`` is the bias/earth-rate-compensated body
    rate — (3,) shared across the bank, or (B, 3) per instance (each
    instance's own :func:`get_rotation_rate`, the exact reference semantics)."""
    rr = jnp.asarray(rotation_rate_body, bstate.cov.dtype)
    if rr.ndim == 2:  # per-instance compensated body rates
        return _update_bank_per_instance(
            bstate, z, meas_cov,
            lambda rr_one: lambda chi: _efforts_measurement(chi, params, rr_one), rr,
        )
    return update_bank(
        bstate, params, z, meas_cov, lambda s: _efforts_measurement(s, params, rr)
    )


def update_geographic_position_bank(
    bstate, params, lat, lon, meas_cov, gps_in_body=None
):
    """Bank-level GPS fix (``PoseUKF.cpp:567-579``): project each instance's
    (lat, lon) to the NWU plane, correct the antenna lever arm with that
    instance's OWN mean orientation, then the χ²-95-gated XY update.

    ``lat``/``lon`` are (B,) per-instance fixes (scalars broadcast — a fleet
    sharing one surface fix); ``gps_in_body`` may be (3,) shared or (B, 3).
    The per-instance lever arm is why this needs a dedicated entry instead of
    host-side preprocessing + :func:`update_xy_position_bank`. Banked
    (Monte-Carlo sweep) parameter sets are supported — ``world_to_nav`` broadcasts over banked
    projection anchors and the XY model reads no parameters."""
    dtype = bstate.cov.dtype
    nb = bstate.cov.shape[0]
    lat = jnp.broadcast_to(jnp.asarray(lat, dtype), (nb,))
    lon = jnp.broadcast_to(jnp.asarray(lon, dtype), (nb,))
    x, y = geo.world_to_nav(params.projection, lat, lon)
    projected = jnp.stack(
        [jnp.broadcast_to(x, (nb,)), jnp.broadcast_to(y, (nb,))], axis=-1
    ).astype(dtype)
    if gps_in_body is not None:
        g = jnp.asarray(gps_in_body, dtype)
        lever = jax.vmap(mf.quat_rotate, in_axes=(0, 0 if g.ndim == 2 else None))(
            bstate.mu.orientation, g
        )
        projected = projected - lever[:, :2]
    return update_xy_position_bank(
        bstate, params, projected, meas_cov, gate_threshold=ukf.D2P95
    )


def update_delayed_position_bank(
    bstate, params, z, meas_cov, delayed_position
):
    """Bank-level active delayed-position path (``PoseUKF.cpp:514-527``):
    shift each instance's measurement by its own (current − delayed) position,
    then the standard XY update. ``delayed_position`` is (B, 2) per instance
    or (2,) shared."""
    dtype = bstate.cov.dtype
    shifted = jnp.asarray(z, dtype) + (
        bstate.mu.position[:, :2] - jnp.asarray(delayed_position, dtype)
    )
    return update_xy_position_bank(bstate, params, shifted, meas_cov)


def update_delayed_position_with_augmentation_bank(
    bstate, params, z, meas_cov, delayed_position, cov_delayed_position
):
    """Bank-level 55-DOF augmented delayed-position update
    (``PoseUKF.cpp:529-557``): the fixed-shape augmentation of
    :func:`update_delayed_position_with_augmentation`, vmapped over the bank.
    Event rate for delayed fixes is ~0.1 Hz against the 100 Hz predict, so a
    vmapped path is the right cost point (fuse only if profiling ever says
    otherwise). All measurement operands broadcast from shared to (B, ...)."""
    nb = bstate.cov.shape[0]
    dtype = bstate.cov.dtype
    z = jnp.broadcast_to(jnp.asarray(z, dtype), (nb, 2))
    rr = jnp.broadcast_to(jnp.asarray(meas_cov, dtype), (nb, 2, 2))
    dp = jnp.broadcast_to(jnp.asarray(delayed_position, dtype), (nb, 2))
    dc = jnp.broadcast_to(jnp.asarray(cov_delayed_position, dtype), (nb, 2, 2))

    def one(s_mu, s_cov, zz, r, d, c):
        st = PoseUKFState(mu=s_mu, cov=s_cov, rotation_rate=jnp.zeros(3, dtype))
        st2, info = update_delayed_position_with_augmentation(st, params, zz, r, d, c)
        return st2.mu, st2.cov, info

    mu, cov, info = jax.vmap(one)(bstate.mu, bstate.cov, z, rr, dp, dc)
    return bstate._replace(mu=mu, cov=cov), info


def push_delayed_state_bank(buffer, bstate: PoseUKFState, filter_ts_us) -> "delayed_states.DelayedStates":
    """Bank-level :func:`push_delayed_state`: ``buffer`` carries a leading
    bank axis on every leaf (build one with
    ``parallel.bank.replicate(delayed_states.make_buffer(...), B)``)."""
    s = POSE_MANIFOLD.block("position")
    xy = bstate.mu.position[:, :2]
    xy_cov = bstate.cov[:, s, s][:, :2, :2]
    ts = jnp.broadcast_to(jnp.asarray(filter_ts_us), (xy.shape[0],))
    return jax.vmap(delayed_states.push)(buffer, ts, xy, xy_cov)


def update_delayed_position_buffered_bank(
    bstate: PoseUKFState,
    params: PoseUKFParams,
    buffer: "delayed_states.DelayedStates",
    filter_ts_us,
    z,
    meas_cov,
    delay_seconds,
):
    """Bank-level out-of-sequence XY fix through per-instance delayed-state
    ring buffers (``PoseUKF.cpp:656-683``): per-instance closest-state lookup,
    shift-identity anchor, χ²-95 gate. ``delay_seconds`` may be scalar or
    (B,) (sensors with per-vehicle latency). Returns (state, info, found);
    instances whose delay exceeds their buffer horizon are left untouched
    with neutralized info, exactly like the solo path."""
    from ..parallel.bank import select_where

    nb = bstate.cov.shape[0]
    dtype = bstate.cov.dtype
    ts = jnp.broadcast_to(jnp.asarray(filter_ts_us), (nb,)) - jnp.broadcast_to(
        delayed_states.from_seconds(delay_seconds), (nb,)
    )
    delayed_xy, _, found = jax.vmap(delayed_states.closest)(buffer, ts)
    shifted = jnp.asarray(z, dtype) + (bstate.mu.position[:, :2] - delayed_xy)
    new_state, info = update_xy_position_bank(
        bstate, params, shifted, meas_cov, gate_threshold=ukf.D2P95
    )
    keep = info.accepted & found
    out = select_where(keep, new_state, bstate)._replace(rotation_rate=bstate.rotation_rate)
    info = ukf.UpdateInfo(
        mahalanobis2=jnp.where(found, info.mahalanobis2, 0.0),
        accepted=keep,
        innovation=jnp.where(found[:, None], info.innovation, jnp.zeros_like(info.innovation)),
    )
    return out, info, found


def update_visual_features_bank(
    bstate: PoseUKFState,
    params: PoseUKFParams,
    marker_features: jax.Array,  # (B,K,2) or (K,2) pixels
    feature_covs: jax.Array,  # (B,K,2,2) or (K,2,2)
    feature_positions: jax.Array,  # (K,3) marker geometry (mission constant)
    marker_position: jax.Array,  # (B,3) or (3,)
    marker_orientation: jax.Array,  # (B,4) or (4,)
    cov_marker_pose: jax.Array,  # (6,6)
    camera: CameraConfiguration,
    camera_in_imu_position: jax.Array,
    camera_in_imu_orientation: jax.Array,
) -> tuple[PoseUKFState, ukf.UpdateInfo]:
    """Bank-level visual-marker update (``PoseUKF.cpp:613-654``): the 59-DOF
    fixed-shape augmentation + per-corner S² updates + marginalization of
    :func:`update_visual_features`, vmapped over the bank so a Monte-Carlo
    fleet can run a marker-aided mission.

    Per-instance operands: ``marker_features``/``feature_covs`` may carry a
    leading bank axis (each vehicle's own corner detections) or be shared;
    likewise the marker-pose prior mean. Marker geometry, marker-pose
    covariance and camera intrinsics/extrinsics are mission constants. The
    model reads no ``PoseUKFParams`` fields, so banked (Monte-Carlo sweep)
    parameter sets work unchanged."""
    dtype = bstate.cov.dtype
    nb = bstate.cov.shape[0]
    feats = jnp.asarray(marker_features, dtype)
    if feats.ndim == 2:
        feats = jnp.broadcast_to(feats[None], (nb, *feats.shape))
    covs = jnp.asarray(feature_covs, dtype)
    if covs.ndim == 3:
        covs = jnp.broadcast_to(covs[None], (nb, *covs.shape))
    mpos = jnp.broadcast_to(jnp.asarray(marker_position, dtype), (nb, 3))
    mrot = jnp.asarray(marker_orientation, dtype)
    mrot = jnp.broadcast_to(mrot, (nb, 4)) if mrot.ndim == 1 else mrot
    fpos = jnp.asarray(feature_positions, dtype)
    cmp_ = jnp.asarray(cov_marker_pose, dtype)
    cam_p = jnp.asarray(camera_in_imu_position, dtype)
    cam_q = jnp.asarray(camera_in_imu_orientation, dtype)

    def one(s_mu, s_cov, f, c, mp, mr):
        st = PoseUKFState(mu=s_mu, cov=s_cov, rotation_rate=jnp.zeros(3, dtype))
        st2, info = update_visual_features(
            st, params, f, c, fpos, mp, mr, cmp_, camera, cam_p, cam_q
        )
        return st2.mu, st2.cov, info

    mu, cov, info = jax.vmap(one)(bstate.mu, bstate.cov, feats, covs, mpos, mrot)
    return bstate._replace(mu=mu, cov=cov), info


def get_rotation_rate(state: PoseUKFState, params: PoseUKFParams) -> jax.Array:
    """``getRotationRate`` (``src/PoseUKF.cpp:693-699``): bias- and
    earth-rate-compensated body rotation rate."""
    lat, _ = geo.nav_to_world(params.projection, state.mu.position[0], state.mu.position[1])
    earth_rot = geo.earth_rotation_nav(lat).astype(state.mu.position.dtype)
    return (
        state.rotation_rate
        - state.mu.bias_gyro
        - mf.quat_rotate_inv(state.mu.orientation, earth_rot)
    )


def get_rotation_rate_bank(bstate: PoseUKFState, params: PoseUKFParams) -> jax.Array:
    """(B, 3) per-instance :func:`get_rotation_rate` — vectorized, no vmap,
    so it stays cheap at fleet scale (feeds the efforts-bank update)."""
    lat, _ = geo.nav_to_world(
        params.projection, bstate.mu.position[:, 0], bstate.mu.position[:, 1]
    )
    earth_rot = jax.vmap(geo.earth_rotation_nav)(lat).astype(bstate.mu.position.dtype)
    return (
        bstate.rotation_rate
        - bstate.mu.bias_gyro
        - jax.vmap(mf.quat_rotate_inv)(bstate.mu.orientation, earth_rot)
    )


# ---------------------------------------------------------------------------
# measurement models + updates (src/PoseUKF.cpp:86-243, 476-654)
# ---------------------------------------------------------------------------


def _apply(state: PoseUKFState, mu, cov, info) -> tuple[PoseUKFState, ukf.UpdateInfo]:
    return state._replace(mu=mu, cov=cov), info


# Measurement models in XLA form, defined ONCE and shared by the
# single-instance updates and the *_bank paths.


def _h_velocity(s: PoseState) -> jax.Array:
    """``measurementVelocity`` (``PoseUKF.cpp:117-123``): h = R⁻¹·v."""
    return mf.quat_rotate_inv(s.orientation, s.velocity)


def _h_acceleration(s: PoseState) -> jax.Array:
    """``measurementAcceleration`` (``PoseUKF.cpp:125-131``):
    R⁻¹(a + [0,0,g]) + b_acc."""
    dtype = s.gravity.dtype
    g_vec = jnp.stack([jnp.zeros((), dtype), jnp.zeros((), dtype), s.gravity[0]])
    return mf.quat_rotate_inv(s.orientation, s.acceleration + g_vec) + s.bias_acc


def _h_z_position(s: PoseState) -> jax.Array:
    """``measurementZPosition`` (``PoseUKF.cpp:100-105``)."""
    return s.position[2:3]


def _h_xy_position(s: PoseState) -> jax.Array:
    """``measurementXYPosition`` (``PoseUKF.cpp:87-92``)."""
    return s.position[:2]


def _h_pressure(atmospheric_pressure, lever: jax.Array):
    """``measurementPressureSensor`` (``PoseUKF.cpp:107-115``):
    p = p_atm − z_sensor·g·ρ with the sensor lever arm."""

    def h(s: PoseState) -> jax.Array:
        sensor_nav = s.position + mf.quat_rotate(s.orientation, lever)
        p = atmospheric_pressure - sensor_nav[2] * s.gravity[0] * s.water_density[0]
        return p[None]

    return h


def _h_water_velocity(cell_weighting):
    """``measurementWaterCurrents`` (``PoseUKF.cpp:133-151``): cell-weighted
    blend of at-vehicle and below-vehicle currents plus ADCP bias, IMU frame."""

    def h(s: PoseState) -> jax.Array:
        dtype = s.position.dtype
        wvb = jnp.stack([s.water_velocity_below[0], s.water_velocity_below[1], jnp.zeros((), dtype)])
        wvb_meas = mf.quat_rotate_inv(s.orientation, s.velocity - wvb)
        wv = jnp.stack([s.water_velocity[0], s.water_velocity[1], jnp.zeros((), dtype)])
        wv_meas = mf.quat_rotate_inv(s.orientation, s.velocity - wv)
        blended = cell_weighting * wvb_meas[:2] + (1.0 - cell_weighting) * wv_meas[:2]
        return blended + s.bias_adcp

    return h


def update_velocity(state, params, z, meas_cov):
    """DVL velocity in the IMU frame: h = R⁻¹·v (``PoseUKF.cpp:117-123,476-482``)."""
    mu, cov, info = ukf.update(
        POSE_MANIFOLD, state.mu, state.cov, z, _h_velocity, meas_cov
    )
    return _apply(state, mu, cov, info)


def update_acceleration(state, params, z, meas_cov):
    """Expected IMU specific force: R⁻¹(a + [0,0,g]) + b_acc
    (``PoseUKF.cpp:125-131,484-490``)."""
    mu, cov, info = ukf.update(POSE_MANIFOLD, state.mu, state.cov, z, _h_acceleration, meas_cov)
    return _apply(state, mu, cov, info)


def integrate_rotation_rate(state: PoseUKFState, z: jax.Array) -> PoseUKFState:
    """Rotation rates are a process input, not an update (``PoseUKF.cpp:492-496``)."""
    return state._replace(rotation_rate=z)


def update_z_position(state, params, z, meas_cov):
    """Depth update (``PoseUKF.cpp:100-105,498-504``)."""
    mu, cov, info = ukf.update(
        POSE_MANIFOLD, state.mu, state.cov, z, _h_z_position, meas_cov
    )
    return _apply(state, mu, cov, info)


def update_xy_position(state, params, z, meas_cov, gate_threshold=None):
    """2D position in the nav frame (``PoseUKF.cpp:87-92,506-512``)."""
    mu, cov, info = ukf.update(
        POSE_MANIFOLD,
        state.mu,
        state.cov,
        z,
        _h_xy_position,
        meas_cov,
        gate_threshold=gate_threshold,
    )
    return _apply(state, mu, cov, info)


def update_delayed_position(state, params, z, meas_cov, delayed_position):
    """Active delayed-position path (``integrateDelayedPositionMeasurement``,
    ``PoseUKF.cpp:514-527``): shift the measurement by (current − delayed)
    position, then a standard XY update."""
    shifted = z + (state.mu.position[:2] - delayed_position)
    return update_xy_position(state, params, shifted, meas_cov)


def update_pressure(state, params, z, meas_cov, pressure_sensor_in_imu=None):
    """Hydrostatic pressure with co-estimated gravity and density
    (``PoseUKF.cpp:107-115,559-565``): p = p_atm − z_sensor·g·ρ."""
    lever = (
        jnp.zeros(3, z.dtype) if pressure_sensor_in_imu is None else pressure_sensor_in_imu
    )
    mu, cov, info = ukf.update(
        POSE_MANIFOLD, state.mu, state.cov, z,
        _h_pressure(params.atmospheric_pressure, lever), meas_cov,
    )
    return _apply(state, mu, cov, info)


def update_geographic_position(state, params, lat, lon, meas_cov, gps_in_body=None):
    """GPS fix (``PoseUKF.cpp:567-579``): project to the NWU plane, correct the
    antenna lever arm with the current orientation, χ²-95 gate."""
    x, y = geo.world_to_nav(params.projection, lat, lon)
    projected = jnp.stack([x, y])
    if gps_in_body is not None:
        projected = projected - mf.quat_rotate(state.mu.orientation, gps_in_body)[:2]
    return update_xy_position(state, params, projected, meas_cov, gate_threshold=ukf.D2P95)


def _efforts_measurement(chi: PoseState, params: PoseUKFParams, rotation_rate_body: jax.Array):
    """``measurementEfforts`` (``PoseUKF.cpp:153-196``): inverse dynamics with
    the per-sigma-point online (x,y,ψ) inertia/damping substituted into the
    6×6 model — free under vmap because parameters are just arrays."""
    m = params.model
    m = m._replace(
        inertia_matrix=dyn.embed_xy_yaw(m.inertia_matrix, chi.inertia),
        damping_linear=dyn.embed_xy_yaw(m.damping_linear, chi.lin_damping),
        damping_quadratic=dyn.embed_xy_yaw(m.damping_quadratic, chi.quad_damping),
    )
    dtype = chi.position.dtype
    water_velocity = jnp.stack(
        [chi.water_velocity[0], chi.water_velocity[1], jnp.zeros((), dtype)]
    )
    velocity_body = mf.quat_rotate_inv(chi.orientation, chi.velocity) - jnp.cross(
        rotation_rate_body, params.imu_in_body
    )
    velocity_body = velocity_body - mf.quat_rotate_inv(chi.orientation, water_velocity)
    vel6 = jnp.concatenate([velocity_body, rotation_rate_body])
    acceleration_body = mf.quat_rotate_inv(chi.orientation, chi.acceleration) - jnp.cross(
        rotation_rate_body, jnp.cross(rotation_rate_body, params.imu_in_body)
    )
    acc6 = jnp.concatenate([acceleration_body, jnp.zeros(3, dtype)])
    return dyn.calc_efforts(m, acc6, vel6, chi.orientation)


def _constrain_velocity_measurement(
    chi: PoseState,
    params: PoseUKFParams,
    rotation_rate_body: jax.Array,
    water_velocity: jax.Array,
    orientation: jax.Array,
    acceleration_body: jax.Array,
):
    """``constrainVelocity`` (``PoseUKF.cpp:199-219``): only the velocity
    varies per sigma point; orientation/acceleration/water current are frozen
    at the current mean. Uses the pristine base model parameters (the
    reference mutates a shared DynamicModel, so its behavior there depends on
    the *last* setUWVParameters call — we pin the unambiguous semantics)."""
    velocity_body = mf.quat_rotate_inv(orientation, chi.velocity) - jnp.cross(
        rotation_rate_body, params.imu_in_body
    )
    velocity_body = velocity_body - mf.quat_rotate_inv(orientation, water_velocity)
    vel6 = jnp.concatenate([velocity_body, rotation_rate_body])
    acc6 = jnp.concatenate([acceleration_body, jnp.zeros(3, chi.position.dtype)])
    return dyn.calc_efforts(params.model, acc6, vel6, orientation)


def update_body_efforts(state, params, z, meas_cov, only_affect_velocity: bool = False):
    """Model-aided effort measurement (``PoseUKF.cpp:581-602``)."""
    rr_body = get_rotation_rate(state, params)
    if only_affect_velocity:
        dtype = state.mu.position.dtype
        water_velocity = jnp.stack(
            [state.mu.water_velocity[0], state.mu.water_velocity[1], jnp.zeros((), dtype)]
        )
        acceleration_body = mf.quat_rotate_inv(
            state.mu.orientation, state.mu.acceleration
        ) - jnp.cross(rr_body, jnp.cross(rr_body, params.imu_in_body))
        orientation = state.mu.orientation

        def h(chi):
            return _constrain_velocity_measurement(
                chi, params, rr_body, water_velocity, orientation, acceleration_body
            )

    else:

        def h(chi):
            return _efforts_measurement(chi, params, rr_body)

    mu, cov, info = ukf.update(POSE_MANIFOLD, state.mu, state.cov, z, h, meas_cov)
    return _apply(state, mu, cov, info)


def update_water_velocity(state, params, z, meas_cov, cell_weighting):
    """ADCP water-current measurement (``PoseUKF.cpp:133-151,604-611``):
    cell-weighted blend of at-vehicle and below-vehicle currents plus ADCP
    bias, in the IMU frame; χ²-95 gate."""
    mu, cov, info = ukf.update(
        POSE_MANIFOLD, state.mu, state.cov, z, _h_water_velocity(cell_weighting),
        meas_cov, gate_threshold=ukf.D2P95,
    )
    return _apply(state, mu, cov, info)


def _visual_landmark_measurement(
    chi: PoseStateWithMarker, feature_pos: jax.Array, cam_q: jax.Array, cam_p: jax.Array
) -> jax.Array:
    """``measurementVisualLandmark`` (``PoseUKF.cpp:233-243``): feature → nav →
    camera frame → S² bearing."""
    cam_in_nav_q, cam_in_nav_p = mf.affine_mul(chi.orientation, chi.position, cam_q, cam_p)
    nav_in_cam_q, nav_in_cam_p = mf.affine_inv(cam_in_nav_q, cam_in_nav_p)
    feature_nav = mf.affine_apply(chi.marker_orientation, chi.marker_position, feature_pos)
    return mf.s2_normalize(mf.affine_apply(nav_in_cam_q, nav_in_cam_p, feature_nav))


def update_visual_features(
    state: PoseUKFState,
    params: PoseUKFParams,
    marker_features: jax.Array,  # (K,2) pixels
    feature_covs: jax.Array,  # (K,2,2)
    feature_positions: jax.Array,  # (K,3) in marker frame
    marker_position: jax.Array,  # (3,)
    marker_orientation: jax.Array,  # (4,)
    cov_marker_pose: jax.Array,  # (6,6)
    camera: CameraConfiguration,
    camera_in_imu_position: jax.Array,
    camera_in_imu_orientation: jax.Array,
) -> tuple[PoseUKFState, ukf.UpdateInfo]:
    """Visual-marker update via 59-DOF state augmentation
    (``PoseUKF.cpp:613-654``): filter ⊕ marker pose, one S² update per corner
    (pixel→bearing via pinhole, covariance scaled by 1/f²), then marginalize
    the filter block back out. Fixed shapes throughout — jit-safe.

    Returns the per-corner ``UpdateInfo`` stacked along a leading (K,) axis —
    an outlier corner (wrong data association) stays visible in the NIS
    record instead of being shadowed by the last corner's fit."""
    k = marker_features.shape[0]
    if k == 0:
        raise ValueError("update_visual_features needs at least one feature")
    if feature_positions.shape[0] != k or feature_covs.shape[0] != k:
        # JAX silently clamps out-of-range indices — a feature matched against
        # the wrong 3D corner corrupts the pose instead of failing loudly
        raise ValueError(
            f"{k} marker_features but {feature_positions.shape[0]} feature_positions "
            f"/ {feature_covs.shape[0]} feature_covs"
        )
    aug_mu = PoseStateWithMarker(
        *state.mu, marker_position=marker_position, marker_orientation=marker_orientation
    )
    n = POSE_MARKER_MANIFOLD.dof
    aug_cov = jnp.zeros((n, n), dtype=state.cov.dtype)
    aug_cov = aug_cov.at[:53, :53].set(state.cov)
    aug_cov = aug_cov.at[53:, 53:].set(cov_marker_pose)

    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    f_scale = jnp.asarray([[fx * fx, fx * fy], [fx * fy, fy * fy]], dtype=state.cov.dtype)

    infos = []
    for i in range(marker_features.shape[0]):  # static corner count — unrolled
        px = marker_features[i]
        z = mf.s2_normalize(
            jnp.stack([(px[0] - cx) / fx, (px[1] - cy) / fy, jnp.ones((), px.dtype)])
        )
        r = feature_covs[i] / f_scale

        def h(chi, fp=feature_positions[i]):
            return _visual_landmark_measurement(
                chi, fp, camera_in_imu_orientation, camera_in_imu_position
            )

        aug_mu, aug_cov, info = ukf.update(
            POSE_MARKER_MANIFOLD, aug_mu, aug_cov, z, h, r, meas_manifold=mf.S2_MANIFOLD
        )
        infos.append(info)

    new_mu = PoseState(*aug_mu[:14])
    info_all = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *infos)
    return state._replace(mu=new_mu, cov=aug_cov[:53, :53]), info_all


class PoseStateWithDelayedPosition(NamedTuple):
    """``MTK_BUILD_MANIFOLD(PoseStateWithDelayedPosition, ...)``
    (``src/PoseUKF.cpp:248-252``) flattened — 53 + 2 = 55 DOF."""

    position: jax.Array
    orientation: jax.Array
    velocity: jax.Array
    acceleration: jax.Array
    bias_gyro: jax.Array
    bias_acc: jax.Array
    gravity: jax.Array
    inertia: jax.Array
    lin_damping: jax.Array
    quad_damping: jax.Array
    water_velocity: jax.Array
    water_velocity_below: jax.Array
    bias_adcp: jax.Array
    water_density: jax.Array
    delayed_position: jax.Array  # (2,)


POSE_DELAYED_MANIFOLD = mf.make_manifold(
    *POSE_MANIFOLD.fields, mf.Field("delayed_position", "vec", 2)
)
assert POSE_DELAYED_MANIFOLD.dof == 55


def update_delayed_position_with_augmentation(
    state: PoseUKFState,
    params: PoseUKFParams,
    z: jax.Array,
    meas_cov: jax.Array,
    delayed_position: jax.Array,
    cov_delayed_position: jax.Array,
) -> tuple[PoseUKFState, ukf.UpdateInfo]:
    """State-augmentation variant of the delayed-position update — the path
    the reference designed but left disabled
    (``integrateDelayedPositionMeasurementWithStateAugmentation``,
    ``src/PoseUKF.cpp:529-557``): augment with the delayed position (55-DOF
    fixed-shape filter), observe the delayed block directly
    (``measurementDelayedPosition``, ``src/PoseUKF.cpp:254-259``), then
    marginalize back. Unlike the active shift path this consumes the delayed
    position's own uncertainty."""
    aug_mu = PoseStateWithDelayedPosition(*state.mu, delayed_position=delayed_position)
    n = POSE_DELAYED_MANIFOLD.dof
    aug_cov = jnp.zeros((n, n), dtype=state.cov.dtype)
    aug_cov = aug_cov.at[:53, :53].set(state.cov)
    aug_cov = aug_cov.at[53:, 53:].set(cov_delayed_position)

    # measurement couples the filter via the shift identity used by the active
    # path (PoseUKF.cpp:514-527): z ≈ delayed_position + (position − current),
    # expressed with the *current-mean* position so only the relative motion
    # since the delayed time is trusted.
    current_xy = state.mu.position[:2]

    def h(chi: PoseStateWithDelayedPosition):
        return chi.delayed_position + (chi.position[:2] - current_xy)

    aug_mu, aug_cov, info = ukf.update(POSE_DELAYED_MANIFOLD, aug_mu, aug_cov, z, h, meas_cov)
    return state._replace(mu=PoseState(*aug_mu[:14]), cov=aug_cov[:53, :53]), info


def push_delayed_state(
    buffer: "delayed_states.DelayedStates", state: PoseUKFState, filter_ts_us: jax.Array
) -> "delayed_states.DelayedStates":
    """Record the current XY position + its covariance block into the
    delayed-state ring buffer — the prediction-side bookkeeping the reference
    sketches at ``src/PoseUKF.cpp:467-473``."""
    s = POSE_MANIFOLD.block("position")
    xy_cov = state.cov[s, s][:2, :2]
    return delayed_states.push(buffer, filter_ts_us, state.mu.position[:2], xy_cov)


def update_delayed_position_buffered(
    state: PoseUKFState,
    params: PoseUKFParams,
    buffer: "delayed_states.DelayedStates",
    filter_ts_us: jax.Array,
    z: jax.Array,
    meas_cov: jax.Array,
    delay_seconds,
) -> tuple[PoseUKFState, ukf.UpdateInfo, jax.Array]:
    """Out-of-sequence XY fix via the delayed-state buffer — the
    ``integrateDelayedMeasurement`` path (``src/PoseUKF.cpp:656-683``):
    look up the filter position closest to (now − delay), anchor the
    measurement through the shift identity, χ²-95 gate as in the reference
    sketch. Returns (state, info, found); found=False (delay beyond the
    buffer horizon) leaves the state untouched, mirroring the bool return."""
    ts = filter_ts_us - delayed_states.from_seconds(delay_seconds)
    delayed_xy, _, found = delayed_states.closest(buffer, ts)
    shifted = z + (state.mu.position[:2] - delayed_xy)
    new_state, info = update_xy_position(
        state, params, shifted, meas_cov, gate_threshold=ukf.D2P95
    )
    keep = info.accepted & found
    sel = lambda a, b: jnp.where(keep, a, b)
    out = PoseUKFState(
        mu=jax.tree_util.tree_map(sel, new_state.mu, state.mu),
        cov=sel(new_state.cov, state.cov),
        rotation_rate=state.rotation_rate,
    )
    # with found=False the lookup (and hence the innovation/NIS) is garbage —
    # neutralize them so NIS monitoring never records a phantom update
    info = ukf.UpdateInfo(
        mahalanobis2=jnp.where(found, info.mahalanobis2, 0.0),
        accepted=keep,
        innovation=jnp.where(found, info.innovation, jnp.zeros_like(info.innovation)),
    )
    return out, info, found


def reset_with_external_pose(
    state: PoseUKFState, position: jax.Array, orientation: jax.Array
) -> PoseUKFState:
    """``resetFilterWithExternalPose`` (``PoseUKF.cpp:685-691``): overwrite the
    pose sub-state, keep everything else including the covariance."""
    return state._replace(mu=state.mu._replace(position=position, orientation=orientation))


# ---------------------------------------------------------------------------
# Object-style wrapper with the reference's class API
# ---------------------------------------------------------------------------


class PoseUKF:
    """Single-instance convenience wrapper (the batched/sharded deployments
    use the pure functions above). API mirrors ``src/PoseUKF.hpp:91-191``."""

    def __init__(
        self,
        imu_in_nwu_pos,
        imu_in_nwu_pos_cov,
        imu_in_nwu_rot,
        imu_in_nwu_rot_cov,
        config: PoseUKFConfig,
        model_parameters: dyn.UWVParameters,
        imu_delta_t: float = 0.01,
        imu_in_body_rot=None,
        imu_in_body_trans=None,
    ):
        self.state, self.params = init_from_pose(
            imu_in_nwu_pos,
            imu_in_nwu_pos_cov,
            imu_in_nwu_rot,
            imu_in_nwu_rot_cov,
            config,
            model_parameters,
            imu_delta_t,
            imu_in_body_rot,
            imu_in_body_trans,
        )

    @classmethod
    def from_state(cls, initial_state: PoseState, state_cov, params: PoseUKFParams) -> "PoseUKF":
        obj = cls.__new__(cls)
        obj.state = init_from_state(initial_state, state_cov, params)
        obj.params = params
        return obj

    def set_process_noise_from_config(self, config, imu_delta_t, imu_in_body_rot=None):
        # pin Q to the filter's state dtype: a float64 Q on a float32 filter
        # (e.g. restored from an f64 checkpoint) silently promotes the
        # covariance on the next predict
        self.params = self.params._replace(
            process_noise=process_noise_from_config(
                config, imu_delta_t, imu_in_body_rot, dtype=self.state.cov.dtype
            )
        )

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (``setProcessNoiseCovariance``,
        called at ``src/PoseUKF.cpp:438``)."""
        self.params = self.params._replace(
            process_noise=jnp.asarray(q, self.state.cov.dtype)
        )

    def _upd(self, fn, mu, cov, *args, **kw) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = fn(self.state, self.params, jnp.asarray(mu), jnp.asarray(cov), *args, **kw)
        return info

    def integrate_velocity(self, mu, cov):
        return self._upd(update_velocity, mu, cov)

    def integrate_acceleration(self, mu, cov):
        return self._upd(update_acceleration, mu, cov)

    def integrate_rotation_rate(self, mu, cov=None):
        if cov is not None:
            check_measurement(mu, cov)
        self.state = integrate_rotation_rate(self.state, jnp.asarray(mu))

    def integrate_z_position(self, mu, cov):
        return self._upd(update_z_position, mu, cov)

    def integrate_xy_position(self, mu, cov):
        return self._upd(update_xy_position, mu, cov)

    def integrate_delayed_position(self, mu, cov, delayed_position):
        return self._upd(update_delayed_position, mu, cov, jnp.asarray(delayed_position))

    def integrate_pressure(self, mu, cov, pressure_sensor_in_imu=None):
        lever = None if pressure_sensor_in_imu is None else jnp.asarray(pressure_sensor_in_imu)
        return self._upd(update_pressure, mu, cov, lever)

    def integrate_geographic_position(self, lat, lon, cov, gps_in_body=None):
        check_measurement(jnp.asarray([lat, lon]), cov)
        g = None if gps_in_body is None else jnp.asarray(gps_in_body)
        self.state, info = update_geographic_position(
            self.state, self.params, jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(cov), g
        )
        return info

    def integrate_body_efforts(self, mu, cov, only_affect_velocity=False):
        return self._upd(update_body_efforts, mu, cov, only_affect_velocity)

    def integrate_water_velocity(self, mu, cov, cell_weighting):
        return self._upd(update_water_velocity, mu, cov, cell_weighting)

    def integrate_visual_features(
        self,
        marker_features,
        feature_covs,
        feature_positions,
        marker_position,
        marker_orientation,
        cov_marker_pose,
        camera: CameraConfiguration,
        camera_in_imu_position,
        camera_in_imu_orientation,
    ):
        for i in range(len(marker_features)):
            check_measurement(marker_features[i], feature_covs[i])
        self.state, info = update_visual_features(
            self.state,
            self.params,
            jnp.asarray(marker_features),
            jnp.asarray(feature_covs),
            jnp.asarray(feature_positions),
            jnp.asarray(marker_position),
            jnp.asarray(marker_orientation),
            jnp.asarray(cov_marker_pose),
            camera,
            jnp.asarray(camera_in_imu_position),
            jnp.asarray(camera_in_imu_orientation),
        )
        return info

    def setup_delayed_state_buffer(self, maximum_delay: float, capacity: int = 256) -> None:
        """``setupDelayedStateBuffer`` (``src/PoseUKF.hpp:130-133``): allocate
        the XY delayed-state ring buffer; prediction_step then records the
        position block each tick (``src/PoseUKF.cpp:467-473``)."""
        self._delayed_buffer = delayed_states.make_buffer(
            capacity, 2, maximum_delay, dtype=self.state.cov.dtype
        )
        self._filter_ts = delayed_states.from_seconds(0.0)

    def prediction_step(self, dt: float) -> None:
        self.state = predict(self.state, self.params, dt)
        if getattr(self, "_delayed_buffer", None) is not None:
            self._filter_ts = self._filter_ts + delayed_states.from_seconds(dt)
            self._delayed_buffer = push_delayed_state(
                self._delayed_buffer, self.state, self._filter_ts
            )

    def integrate_delayed_measurement(self, mu, cov, delay: float) -> bool:
        """``integrateDelayedMeasurement`` (``src/PoseUKF.cpp:656-683``):
        out-of-sequence XY fix through the delayed-state buffer; returns False
        when the delay exceeds the buffer horizon."""
        if getattr(self, "_delayed_buffer", None) is None:
            raise RuntimeError("setup_delayed_state_buffer was not called")
        check_measurement(mu, cov)
        self.state, info, found = update_delayed_position_buffered(
            self.state,
            self.params,
            self._delayed_buffer,
            self._filter_ts,
            jnp.asarray(mu),
            jnp.asarray(cov),
            delay,
        )
        return bool(found)

    def integrate_delayed_position_with_augmentation(
        self, mu, cov, delayed_position, cov_delayed_position
    ):
        return self._upd(
            update_delayed_position_with_augmentation,
            mu,
            cov,
            jnp.asarray(delayed_position),
            jnp.asarray(cov_delayed_position),
        )

    def reset_filter_with_external_pose(self, position, orientation):
        self.state = reset_with_external_pose(
            self.state, jnp.asarray(position), jnp.asarray(orientation)
        )

    def get_rotation_rate(self):
        return get_rotation_rate(self.state, self.params)

    @property
    def mu(self) -> PoseState:
        return self.state.mu

    @property
    def sigma(self) -> jax.Array:
        return self.state.cov
