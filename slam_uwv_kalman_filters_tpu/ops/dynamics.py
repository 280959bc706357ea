"""Fossen 6-DOF AUV dynamics — the ``uwv_dynamic_model`` layer, in JAX.

JAX replacement for the external ``uwv_dynamic_model`` package the
reference links against (``/root/reference/src/PoseUKF.cpp:3``,
``src/VelocityUKF.cpp:2``):

* ``UWVParameters`` (``src/PoseUKF.cpp:159-173``) → a parameter pytree. Because
  parameters are plain arrays, the reference's per-sigma-point parameter
  substitution (``src/PoseUKF.cpp:159-173``) is free under ``vmap`` — no
  stateful ``setUWVParameters`` mutation.
* ``DynamicModel::calcEfforts(ν̇, ν, q)`` (``src/PoseUKF.cpp:192``) →
  :func:`calc_efforts` — Fossen inverse dynamics
  τ = M·ν̇ + C(ν)ν + D_lin·ν + D_quad·(|ν|∘ν) + g(q).
* ``ModelSimulation(DYNAMIC, dt, order)`` with ``sendEffort(τ[, state])``,
  ``setPose``/``getPose`` (``src/VelocityUKF.cpp:18-21,60-75,121-127``) →
  :func:`simulate_effort` — a pure step function; the reference's stateful
  simulator becomes explicit state threading (:class:`PoseVelocityState`).

Frame conventions: body-fixed FRD-style 6-DOF vector ν = [v; ω] with the
navigation frame NWU (z up). Gravity acts along −z_nav, buoyancy along +z_nav.
The restoring term g(q) is written so that :func:`calc_efforts` and
:func:`calc_acceleration` are exact inverses — the property the filters rely
on. Signs are pinned by tests in ``tests/test_dynamics.py``.

ICRA 2018 basis: Arnold & Medagoda, "Robust model-aided inertial localization
for autonomous underwater vehicles" (arXiv:1805.08011), Eq. (4): the motion
model used as a virtual measurement is exactly this inverse dynamics.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .linalg_small import mm, solve_spd
from .manifolds import quat_rotate, quat_rotate_inv, so3_boxplus

__all__ = [
    "UWVParameters",
    "PoseVelocityState",
    "default_uwv_parameters",
    "coriolis_effort",
    "damping_effort",
    "gravity_buoyancy_effort",
    "calc_efforts",
    "calc_acceleration",
    "simulate_effort",
    "embed_xy_yaw",
    "extract_xy_yaw",
]


class UWVParameters(NamedTuple):
    """Hydrodynamic parameters (the ``uwv_dynamic_model::UWVParameters`` the
    reference populates at ``src/PoseUKF.cpp:159-173``).

    inertia_matrix includes added mass (6×6). damping_linear/quadratic are the
    two entries of the reference's ``damping_matrices[0..1]``.
    """

    inertia_matrix: jax.Array  # (6,6)
    damping_linear: jax.Array  # (6,6)
    damping_quadratic: jax.Array  # (6,6)
    weight: jax.Array  # scalar: m·g [N]
    buoyancy: jax.Array  # scalar [N]
    cog: jax.Array  # (3,) centre of gravity in body frame [m]
    cob: jax.Array  # (3,) centre of buoyancy in body frame [m]


class PoseVelocityState(NamedTuple):
    """The ``uwv_dynamic_model::PoseVelocityState`` (``src/VelocityUKF.cpp:13-17``)
    as an explicit pytree: position [nav], orientation quaternion [w,x,y,z]
    (body→nav), linear velocity [body], angular velocity [body]."""

    position: jax.Array  # (3,)
    orientation: jax.Array  # (4,)
    linear_velocity: jax.Array  # (3,)
    angular_velocity: jax.Array  # (3,)


def default_uwv_parameters(dtype=jnp.float64) -> UWVParameters:
    """Neutral test vehicle: diagonal inertia incl. added mass, light damping,
    neutrally buoyant with coincident COG/COB (⇒ zero restoring term)."""
    return UWVParameters(
        inertia_matrix=jnp.diag(jnp.array([120.0, 150.0, 180.0, 20.0, 30.0, 35.0], dtype=dtype)),
        damping_linear=jnp.diag(jnp.array([40.0, 65.0, 80.0, 10.0, 12.0, 14.0], dtype=dtype)),
        damping_quadratic=jnp.diag(jnp.array([25.0, 40.0, 50.0, 5.0, 6.0, 7.0], dtype=dtype)),
        weight=jnp.asarray(980.7, dtype=dtype),
        buoyancy=jnp.asarray(980.7, dtype=dtype),
        cog=jnp.zeros(3, dtype=dtype),
        cob=jnp.zeros(3, dtype=dtype),
    )


def coriolis_effort(inertia_matrix: jax.Array, velocity: jax.Array) -> jax.Array:
    """Rigid-body + added-mass Coriolis/centripetal term C(ν)ν (Fossen §3.3).

    With M = [[M11,M12],[M21,M22]] and ν = [v; ω]:
      C(ν)ν = [ ω × (M11 v + M12 ω);  ω × (M21 v + M22 ω) + v × (M11 v + M12 ω) ].
    """
    v, w = velocity[:3], velocity[3:]
    p1 = mm(inertia_matrix[:3, :], velocity)  # M11 v + M12 ω
    p2 = mm(inertia_matrix[3:, :], velocity)  # M21 v + M22 ω
    return jnp.concatenate([jnp.cross(w, p1), jnp.cross(w, p2) + jnp.cross(v, p1)])


def damping_effort(params: UWVParameters, velocity: jax.Array) -> jax.Array:
    """D_lin·ν + D_quad·(|ν|∘ν) — the reference's two ``damping_matrices``
    (linear + quadratic, ``src/PoseUKF.cpp:164-171``)."""
    return mm(params.damping_linear, velocity) + mm(
        params.damping_quadratic, jnp.abs(velocity) * velocity
    )


def gravity_buoyancy_effort(params: UWVParameters, orientation: jax.Array) -> jax.Array:
    """Restoring term g(q) in the body frame (NWU nav frame, z up).

    Net gravity+buoyancy wrench on the vehicle, sign-flipped onto the
    left-hand side of M ν̇ + C ν + D ν + g(q) = τ:
      f_ext  = R⁻¹·(0,0,B−W);   τ_ext = r_g × R⁻¹(0,0,−W) + r_b × R⁻¹(0,0,B)
      g(q)   = −[f_ext; τ_ext].
    """
    up_body = quat_rotate_inv(orientation, jnp.array([0.0, 0.0, 1.0], dtype=orientation.dtype))
    f_ext = up_body * (params.buoyancy - params.weight)  # = R⁻¹(0,0,B−W)
    f_grav = -up_body * params.weight
    f_buoy = up_body * params.buoyancy
    tau_ext = jnp.cross(params.cog, f_grav) + jnp.cross(params.cob, f_buoy)
    return -jnp.concatenate([f_ext, tau_ext])


def calc_efforts(
    params: UWVParameters,
    acceleration: jax.Array,
    velocity: jax.Array,
    orientation: jax.Array,
) -> jax.Array:
    """Inverse dynamics: expected body efforts τ for a given motion.

    The ``DynamicModel::calcEfforts(acc6, vel6, q)`` of the reference's
    model-aided effort measurement (``src/PoseUKF.cpp:192``):
      τ = M·ν̇ + C(ν)ν + D_lin·ν + D_quad·(|ν|∘ν) + g(q).
    """
    return (
        mm(params.inertia_matrix, acceleration)
        + coriolis_effort(params.inertia_matrix, velocity)
        + damping_effort(params, velocity)
        + gravity_buoyancy_effort(params, orientation)
    )


def calc_acceleration(
    params: UWVParameters,
    efforts: jax.Array,
    velocity: jax.Array,
    orientation: jax.Array,
) -> jax.Array:
    """Forward dynamics ν̇ = M⁻¹(τ − C(ν)ν − D(ν)ν − g(q)); exact inverse of
    :func:`calc_efforts` (property-tested)."""
    rhs = (
        efforts
        - coriolis_effort(params.inertia_matrix, velocity)
        - damping_effort(params, velocity)
        - gravity_buoyancy_effort(params, orientation)
    )
    # Fossen M = M_RB + M_A is SPD, so the 6×6 solve unrolls into fused FMAs
    # (ops/linalg_small.py) instead of a library LU/triangular-solve call.
    return solve_spd(params.inertia_matrix, rhs)


def simulate_effort(
    params: UWVParameters,
    state: PoseVelocityState,
    efforts: jax.Array,
    dt,
    *,
    integrate_pose: bool = True,
) -> PoseVelocityState:
    """One Euler step of the forward simulator — ``ModelSimulation::sendEffort``
    (``src/VelocityUKF.cpp:21,127``; constructed order-1 at :60-62).

    Velocity update is explicit Euler on the 6-DOF dynamics; the kinematic pose
    update (position in nav frame, orientation via body-frame angular velocity)
    uses the *updated* velocity (semi-implicit Euler), and is optional to model
    the reference's velocity-only DYNAMIC simulation mode.
    """
    vel6 = jnp.concatenate([state.linear_velocity, state.angular_velocity])
    acc6 = calc_acceleration(params, efforts, vel6, state.orientation)
    lin_vel = state.linear_velocity + dt * acc6[:3]
    ang_vel = state.angular_velocity + dt * acc6[3:]
    if integrate_pose:
        position = state.position + dt * quat_rotate(state.orientation, lin_vel)
        orientation = so3_boxplus(state.orientation, ang_vel, dt)
    else:
        position, orientation = state.position, state.orientation
    return PoseVelocityState(
        position=position,
        orientation=orientation,
        linear_velocity=lin_vel,
        angular_velocity=ang_vel,
    )


# ---------------------------------------------------------------------------
# 3×3 (x, y, ψ) sub-model ↔ 6×6 embedding used by PoseUKF's online-identified
# inertia/damping states (src/PoseUKF.cpp:159-171 and :303-314).
# ---------------------------------------------------------------------------

# numpy, not jnp: a module-level jnp constant is committed to whichever
# backend is default at import time, and every later use under a different
# default device forces a cross-backend transfer
_XY_YAW = np.array([0, 1, 5])


def extract_xy_yaw(mat6: jax.Array) -> jax.Array:
    """6×6 → 3×3 surge/sway/yaw block, the reference's state extraction
    (``src/PoseUKF.cpp:303-306``)."""
    return mat6[np.ix_(_XY_YAW, _XY_YAW)]


def embed_xy_yaw(mat6: jax.Array, block3: jax.Array) -> jax.Array:
    """Write a 3×3 (x,y,ψ) block back into a 6×6 matrix — the per-sigma-point
    parameter substitution of ``src/PoseUKF.cpp:159-171``."""
    return mat6.at[np.ix_(_XY_YAW, _XY_YAW)].set(block3)
