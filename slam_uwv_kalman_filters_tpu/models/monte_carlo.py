"""Monte-Carlo fleet mission replay — the fleet-scale accuracy harness.

The north star (BASELINE.json) asks for 100k-class banks *within the ATE
bound*, which requires measuring the ATE **distribution** over a real
Monte-Carlo bank, not one replayed instance (VERDICT r3 "Missing #1"). This
module runs an ICRA'18-style mission as a bank through the bank tick
(:func:`models.pose_driver.pose_step_bank`) with

- **per-instance initial-state perturbations** drawn from the filter's own
  initial covariance (each instance starts with a plausibly-wrong estimate
  of the same true trajectory — the textbook Monte-Carlo consistency setup),
- **per-instance, per-tick sensor noise** generated ON DEVICE inside the
  scan (``jax.random.fold_in`` per tick), so a (T, B, ...) measurement
  tensor never exists in device memory — the schedule streams (T, ...) clean truth
  signals and each instance sees its own noise realization,
- optional **banked Monte-Carlo parameters** (leading bank axis on every
  parameter leaf), and
- **streaming error accumulation**: the carry integrates per-instance
  squared position error and χ²-gate outcomes, so the scan emits (B,)
  statistics instead of a (T, B, 3) trajectory.

The reference has no analogue (it runs one filter on one log); this is the
fleet capability layer on top of the reference's semantics
(``/root/reference/README.md:73-84`` — the ICRA'18 accuracy claim this
distribution quantifies).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import pose_driver as drv
from . import pose_ukf as pukf

__all__ = [
    "FleetMissionSpec",
    "FleetMissionResult",
    "perturb_initial_bank",
    "run_fleet_mission",
]


class FleetMissionSpec(NamedTuple):
    """Clean (noise-free) truth streams + noise model of one mission tick
    schedule. All streams carry a leading (T,) time axis; noise sigmas are
    scalars (per-axis noise is drawn i.i.d.); covariances are the shared
    measurement covariances handed to the filter."""

    dt: float
    gyro: jax.Array  # (T, 3) clean gyro signal (incl. true biases/earth rate)
    acc: jax.Array  # (T, 3) clean specific force
    dvl: jax.Array  # (T, 3) clean body velocity
    pressure: jax.Array  # (T, 1) clean hydrostatic pressure
    truth_pos: jax.Array  # (T, 3) ground-truth position (ATE reference)
    dvl_valid: jax.Array  # (T,) bool
    pressure_valid: jax.Array  # (T,) bool
    gyro_sigma: float
    acc_sigma: float
    dvl_sigma: float
    pressure_sigma: float
    acc_cov: jax.Array  # (3, 3)
    dvl_cov: jax.Array  # (3, 3)
    pressure_cov: jax.Array  # (1, 1)
    # χ²-95-gated surface fixes through the GeographicPosition path
    # (PoseUKF.cpp:567-579) — the gated stream whose acceptance spread the
    # artifact reports; lat/lon in radians, noise sigmas in radians
    gps: Optional[jax.Array] = None  # (T, 2) clean (lat, lon)
    gps_valid: Optional[jax.Array] = None  # (T,) bool
    gps_lat_sigma: float = 0.0
    gps_lon_sigma: float = 0.0
    gps_cov: Optional[jax.Array] = None  # (2, 2)


class FleetMissionResult(NamedTuple):
    ate: jax.Array  # (B,) per-instance ATE RMSE [m]
    gps_accept_frac: jax.Array  # (B,) accepted / offered gated fixes (0 if none)
    dvl_nis_mean: jax.Array  # (B,) mean DVL NIS over valid ticks
    final_state: pukf.PoseUKFState  # bank-first final filter state


def perturb_initial_bank(
    bstate: pukf.PoseUKFState,
    key: jax.Array,
    *,
    pos_sigma: float = 0.2,
    vel_sigma: float = 0.05,
    yaw_sigma: float = 3e-3,
) -> pukf.PoseUKFState:
    """Monte-Carlo initial-estimate perturbation: each instance starts from
    the same truth with its own plausibly-wrong position/velocity/yaw
    estimate (sigmas default to the scale of the mission's initial
    covariance, so the perturbation is exactly what the filter claims it can
    absorb)."""
    from ..ops import manifolds as mf

    nb = bstate.cov.shape[0]
    dtype = bstate.cov.dtype
    kp, kv, ky = jax.random.split(key, 3)
    pos = bstate.mu.position + pos_sigma * jax.random.normal(kp, (nb, 3), dtype)
    vel = bstate.mu.velocity + vel_sigma * jax.random.normal(kv, (nb, 3), dtype)
    dyaw = yaw_sigma * jax.random.normal(ky, (nb,), dtype)
    rotvec = jnp.stack([jnp.zeros_like(dyaw), jnp.zeros_like(dyaw), dyaw], axis=-1)
    quat = jax.vmap(mf.so3_boxplus)(bstate.mu.orientation, rotvec)
    return bstate._replace(
        mu=bstate.mu._replace(position=pos, velocity=vel, orientation=quat)
    )


def run_fleet_mission(
    bstate: pukf.PoseUKFState,
    params: pukf.PoseUKFParams,
    spec: FleetMissionSpec,
    key: jax.Array,
    consts: Optional[drv.PoseStepConstants] = None,
) -> FleetMissionResult:
    """Replay the mission over the bank and return per-instance
    accuracy/consistency statistics. ``params`` may be a shared set or a
    fully-banked Monte-Carlo sweep (leading bank axis on every leaf). One
    ``lax.scan`` of :func:`models.pose_driver.pose_step_bank`; the carry
    holds only the bank state + (B,) accumulators."""
    nb = bstate.cov.shape[0]
    dtype = bstate.cov.dtype
    n_ticks = spec.gyro.shape[0]

    has_gps = spec.gps is not None
    bc = lambda a: jnp.broadcast_to(a, (nb, *jnp.shape(a)))
    zeros_b = jnp.zeros((nb,), dtype)

    xs = {
        "idx": jnp.arange(n_ticks, dtype=jnp.int32),
        "gyro": spec.gyro.astype(dtype),
        "acc": spec.acc.astype(dtype),
        "dvl": spec.dvl.astype(dtype),
        "pressure": spec.pressure.astype(dtype),
        "truth": spec.truth_pos.astype(dtype),
        "dvl_valid": spec.dvl_valid,
        "pressure_valid": spec.pressure_valid,
    }
    if has_gps:
        xs["gps"] = spec.gps.astype(dtype)
        xs["gps_valid"] = spec.gps_valid

    def tick(carry, x):
        ls, err, g_acc, nis_sum = carry
        k = jax.random.fold_in(key, x["idx"])
        kg, ka, kd, kp, kx = jax.random.split(k, 5)
        noisy = lambda kk, v, s: bc(v) + s * jax.random.normal(
            kk, (nb, *jnp.shape(v)), dtype
        )
        inp = drv.PoseInputs(
            dt=jnp.full((nb,), spec.dt, dtype),
            rotation_rate=noisy(kg, x["gyro"], spec.gyro_sigma),
            acc=noisy(ka, x["acc"], spec.acc_sigma),
            acc_cov=bc(spec.acc_cov.astype(dtype)),
            acc_valid=jnp.ones((nb,), bool),
            dvl=noisy(kd, x["dvl"], spec.dvl_sigma),
            dvl_cov=bc(spec.dvl_cov.astype(dtype)),
            dvl_valid=bc(x["dvl_valid"]),
            pressure=noisy(kp, x["pressure"], spec.pressure_sigma),
            pressure_cov=bc(spec.pressure_cov.astype(dtype)),
            pressure_valid=bc(x["pressure_valid"]),
            # the schedule carries no XY/ADCP/efforts sensors at all — None
            # keeps their update phases out of the trace entirely
            xy=None,
            xy_cov=None,
            xy_valid=None,
            adcp=None,
            adcp_cov=None,
            adcp_cell_weighting=None,
            adcp_valid=None,
            efforts=None,
            efforts_cov=None,
            efforts_valid=None,
            gps=(
                None
                if not has_gps
                else bc(x["gps"])
                + jnp.stack([spec.gps_lat_sigma, spec.gps_lon_sigma]).astype(dtype)
                * jax.random.normal(kx, (nb, 2), dtype)
            ),
            gps_cov=None if not has_gps else bc(spec.gps_cov.astype(dtype)),
            gps_valid=None if not has_gps else bc(x["gps_valid"]),
        )
        ls, out = drv.pose_step_bank(ls, params, inp, consts)
        err = err + jnp.sum((out.position - x["truth"][None, :]) ** 2, axis=-1)
        if has_gps:
            g_acc = g_acc + jnp.where(
                bc(x["gps_valid"]), out.gps_accepted.astype(dtype), 0.0
            )
        nis_sum = nis_sum + jnp.where(bc(x["dvl_valid"]), out.dvl_nis, 0.0)
        return (ls, err, g_acc, nis_sum), None

    (ls_f, err, g_acc, nis_sum), _ = jax.lax.scan(
        tick, (bstate, zeros_b, zeros_b, zeros_b), xs
    )
    n_gps = jnp.sum(spec.gps_valid.astype(dtype)) if has_gps else jnp.asarray(0.0, dtype)
    n_dvl = jnp.maximum(jnp.sum(spec.dvl_valid.astype(dtype)), 1.0)
    return FleetMissionResult(
        ate=jnp.sqrt(err / n_ticks),
        gps_accept_frac=jnp.where(n_gps > 0, g_acc / jnp.maximum(n_gps, 1.0), 0.0),
        dvl_nis_mean=nis_sum / n_dvl,
        final_state=ls_f,
    )
