"""Whole-trajectory replay driver for PoseUKF — the scan-based offline
equivalent of the reference's host-component driving pattern (SURVEY.md §3.6:
on each IMU tick → ``predictionStep``; on each sensor arrival → the matching
``integrateMeasurement``).

An irregular multi-rate sensor schedule is packed into a dense per-tick
:class:`PoseInputs` structure with validity flags; absent measurements are
masked selects (never control flow), so one ``lax.scan`` jit-compiles the
entire replay and the same code path vmaps over trajectory banks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..parallel.bank import select_where
from . import pose_ukf as pukf

__all__ = [
    "PoseInputs",
    "MarkerSetup",
    "PoseStepConstants",
    "make_inputs",
    "pose_step",
    "run_trajectory",
    "pose_step_bank",
    "run_trajectory_bank",
    "TickOutput",
]


class MarkerSetup(NamedTuple):
    """Mission constants for the visual-marker stream (the marker geometry,
    pose prior and camera calibration of ``integrateMeasurement(
    VisualFeatureMeasurement, ...)``, ``src/PoseUKF.hpp:168-174``) — fixed for
    a replay, so they ride the scan closure instead of the per-tick inputs."""

    feature_positions: jax.Array  # (K,3) corner geometry in the marker frame
    marker_position: jax.Array  # (3,) prior mean, nav frame
    marker_orientation: jax.Array  # (4,) prior mean quaternion
    cov_marker_pose: jax.Array  # (6,6) prior covariance
    camera: object  # CameraConfiguration (static floats)
    camera_in_imu_position: jax.Array  # (3,)
    camera_in_imu_orientation: jax.Array  # (4,)


class PoseStepConstants(NamedTuple):
    """Per-mission constants consumed by :func:`pose_step` /
    :func:`pose_step_bank` — sensor mounting and marker setup that the
    reference passes per call but never varies within a mission."""

    gps_in_body: Optional[jax.Array] = None  # (3,) antenna lever arm
    marker: Optional[MarkerSetup] = None


class PoseInputs(NamedTuple):
    """One tick of the packed sensor schedule (leading time axis when used
    with :func:`run_trajectory`). ``*_valid`` flags express the multi-rate /
    dropout structure (e.g. 100 Hz IMU, 5 Hz DVL, 1 Hz pressure).

    Any sensor group may be ``None`` when the mission carries no such sensor
    at all — its update phase is then not even traced (None leaves are empty
    pytree nodes, so scan/vmap treat lean and full schedules uniformly;
    presence is static per compilation). :func:`make_inputs` keeps the
    classic always-on streams dense by default and the event-rate streams
    ``None`` when omitted."""

    dt: jax.Array  # () prediction interval
    rotation_rate: jax.Array  # (3,) gyro input (always present — drives predict)
    acc: Optional[jax.Array]  # (3,)
    acc_cov: Optional[jax.Array]  # (3,3)
    acc_valid: Optional[jax.Array]  # () bool
    dvl: Optional[jax.Array]  # (3,)
    dvl_cov: Optional[jax.Array]  # (3,3)
    dvl_valid: Optional[jax.Array]  # () bool
    pressure: Optional[jax.Array]  # (1,)
    pressure_cov: Optional[jax.Array]  # (1,1)
    pressure_valid: Optional[jax.Array]  # () bool
    xy: Optional[jax.Array]  # (2,)
    xy_cov: Optional[jax.Array]  # (2,2)
    xy_valid: Optional[jax.Array]  # () bool
    adcp: Optional[jax.Array]  # (2,)
    adcp_cov: Optional[jax.Array]  # (2,2)
    adcp_cell_weighting: Optional[jax.Array]  # ()
    adcp_valid: Optional[jax.Array]  # () bool
    efforts: Optional[jax.Array]  # (6,)
    efforts_cov: Optional[jax.Array]  # (6,6)
    efforts_valid: Optional[jax.Array]  # () bool
    # Optional streams (None when the mission has no such sensor — None leaves
    # are empty pytree nodes, so scan/vmap treat a lean schedule and a full
    # ICRA'18 schedule uniformly; presence is static per compilation):
    z: Optional[jax.Array] = None  # (1,) depth
    z_cov: Optional[jax.Array] = None  # (1,1)
    z_valid: Optional[jax.Array] = None  # () bool
    gps: Optional[jax.Array] = None  # (2,) lat, lon in radians
    gps_cov: Optional[jax.Array] = None  # (2,2) planar covariance
    gps_valid: Optional[jax.Array] = None  # () bool
    delayed_xy: Optional[jax.Array] = None  # (2,) delayed XY fix
    delayed_xy_cov: Optional[jax.Array] = None  # (2,2)
    delayed_position: Optional[jax.Array] = None  # (2,) state at capture time
    delayed_valid: Optional[jax.Array] = None  # () bool
    marker_features: Optional[jax.Array] = None  # (K,2) detected pixels
    marker_feature_covs: Optional[jax.Array] = None  # (K,2,2)
    marker_valid: Optional[jax.Array] = None  # () bool


def make_inputs(
    n: int,
    dt: float,
    rotation_rate,
    *,
    acc=None,
    acc_cov=None,
    acc_valid=None,
    dvl=None,
    dvl_cov=None,
    dvl_valid=None,
    pressure=None,
    pressure_cov=None,
    pressure_valid=None,
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
    z=None,
    z_cov=None,
    z_valid=None,
    gps=None,
    gps_cov=None,
    gps_valid=None,
    delayed_xy=None,
    delayed_xy_cov=None,
    delayed_position=None,
    delayed_valid=None,
    marker_features=None,
    marker_feature_covs=None,
    marker_valid=None,
    dtype=jnp.float64,
) -> PoseInputs:
    """Assemble a dense (n,)-tick schedule; omitted sensors are all-invalid.

    The always-on streams get dense dummy slots when omitted (the masked
    update is cheap); the event-rate streams (``z``/``gps``/``delayed_*``/
    ``marker_*``) stay ``None`` when absent so their — much heavier —
    update phases are not even traced."""
    if marker_features is not None:
        marker_features = jnp.asarray(marker_features, dtype)
        if marker_features.ndim not in (2, 3):
            raise ValueError(
                f"marker_features has shape {marker_features.shape}; expected "
                "(K,2) (constant detections) or (n,K,2) (per tick)"
            )

    def fill(x, shape, default=0.0):
        if x is None:
            return jnp.full((n, *shape), default, dtype)
        x = jnp.asarray(x, dtype)
        if x.ndim == len(shape):  # one constant value → every tick
            return jnp.broadcast_to(x, (n, *shape))
        if x.shape != (n, *shape):
            raise ValueError(
                f"sensor stream has shape {x.shape}; expected {(n, *shape)} "
                f"(per tick) or {tuple(shape)} (constant)"
            )
        return x

    def fill_cov(x, d):
        if x is None:
            return jnp.tile(jnp.eye(d, dtype=dtype)[None], (n, 1, 1))
        x = jnp.asarray(x, dtype)
        return jnp.tile(x[None], (n, 1, 1)) if x.ndim == 2 else x

    def flag(v, provided):
        if v is None:
            return jnp.full((n,), bool(provided))
        v = jnp.asarray(v, bool)
        return jnp.broadcast_to(v, (n,)) if v.ndim == 0 else v

    return PoseInputs(
        dt=jnp.full((n,), dt, dtype),
        rotation_rate=fill(rotation_rate, (3,)),
        acc=fill(acc, (3,)),
        acc_cov=fill_cov(acc_cov, 3),
        acc_valid=flag(acc_valid, acc is not None),
        dvl=fill(dvl, (3,)),
        dvl_cov=fill_cov(dvl_cov, 3),
        dvl_valid=flag(dvl_valid, dvl is not None),
        pressure=fill(pressure, (1,)),
        pressure_cov=fill_cov(pressure_cov, 1),
        pressure_valid=flag(pressure_valid, pressure is not None),
        xy=fill(xy, (2,)),
        xy_cov=fill_cov(xy_cov, 2),
        xy_valid=flag(xy_valid, xy is not None),
        adcp=fill(adcp, (2,)),
        adcp_cov=fill_cov(adcp_cov, 2),
        adcp_cell_weighting=fill(adcp_cell_weighting, ()),
        adcp_valid=flag(adcp_valid, adcp is not None),
        efforts=fill(efforts, (6,)),
        efforts_cov=fill_cov(efforts_cov, 6),
        efforts_valid=flag(efforts_valid, efforts is not None),
        z=None if z is None else fill(z, (1,)),
        z_cov=None if z is None else fill_cov(z_cov, 1),
        z_valid=None if z is None else flag(z_valid, True),
        gps=None if gps is None else fill(gps, (2,)),
        gps_cov=None if gps is None else fill_cov(gps_cov, 2),
        gps_valid=None if gps is None else flag(gps_valid, True),
        delayed_xy=None if delayed_xy is None else fill(delayed_xy, (2,)),
        delayed_xy_cov=None if delayed_xy is None else fill_cov(delayed_xy_cov, 2),
        delayed_position=(
            None
            if delayed_xy is None
            else fill(_required(delayed_position, "delayed_position"), (2,))
        ),
        delayed_valid=None if delayed_xy is None else flag(delayed_valid, True),
        marker_features=(
            None if marker_features is None else fill(marker_features, marker_features.shape[-2:])
        ),
        marker_feature_covs=(
            None
            if marker_features is None
            else _fill_corner_covs(
                _required(marker_feature_covs, "marker_feature_covs"),
                n,
                marker_features.shape[-2],
                dtype,
            )
        ),
        marker_valid=None if marker_features is None else flag(marker_valid, True),
    )


def _required(x, name):
    if x is None:
        raise ValueError(f"{name} is required when its sensor stream is provided")
    return x


def _fill_corner_covs(x, n, k, dtype):
    """(K,2,2) constant per-corner covariances → (n,K,2,2), or pass through a
    full per-tick stream."""
    x = jnp.asarray(x, dtype)
    if x.shape == (k, 2, 2):
        return jnp.broadcast_to(x[None], (n, k, 2, 2))
    if x.shape != (n, k, 2, 2):
        raise ValueError(
            f"marker_feature_covs has shape {x.shape}; expected {(k, 2, 2)} or {(n, k, 2, 2)}"
        )
    return x


class TickOutput(NamedTuple):
    position: jax.Array
    orientation: jax.Array
    velocity: jax.Array
    cov_trace: jax.Array
    # per-step observability (utils.metrics semantics): the DVL NIS — the
    # highest-rate consistency signal — and the χ²-gate outcome of the ADCP
    # update; both neutral (0 / False) on ticks without that measurement
    dvl_nis: jax.Array
    adcp_accepted: jax.Array
    # gate outcomes of the optional event-rate streams; None when the mission
    # schedule carries no such stream (mirrors PoseInputs)
    gps_accepted: Optional[jax.Array] = None  # () bool
    marker_nis: Optional[jax.Array] = None  # (K,) per-corner NIS


def _masked_update(state, valid, update_fn, *args):
    """Apply an update only where ``valid``; returns (state, info) so gated
    sensors stay observable (``info`` fields are only meaningful under
    ``valid`` — mask them at use sites). Rank-agnostic via
    ``bank.select_where``: serves both the solo path (scalar mask) and the
    bank path ((B,) mask). When no instance has the measurement the update
    is skipped outright (``lax.cond``; zero ``info``), so a multi-rate
    schedule pays each update only on the ticks it fires — under ``vmap``
    the cond becomes a select and both branches run, as before."""

    def run():
        new_state, info = update_fn(*args)
        return select_where(valid, new_state, state), info

    def skip():
        # a closure: ``args`` may hold static configs (e.g. the camera)
        info = jax.eval_shape(lambda: update_fn(*args))[1]
        return state, jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), info)

    return jax.lax.cond(jnp.any(valid), run, skip)


def pose_step(
    state: pukf.PoseUKFState,
    params: pukf.PoseUKFParams,
    inp: PoseInputs,
    consts: Optional[PoseStepConstants] = None,
) -> tuple[pukf.PoseUKFState, TickOutput]:
    """One tick: cache gyro input → predict → masked sensor updates, in the
    reference's integration order (prediction first, then synchronous
    updates — SURVEY.md §3.6). With every optional stream populated this
    covers the reference's full ``integrateMeasurement`` surface
    (``src/PoseUKF.hpp:137-177``): rotation rate, acceleration, DVL, pressure,
    depth, XY, GPS, delayed XY, ADCP, efforts, visual markers."""
    state = pukf.integrate_rotation_rate(state, inp.rotation_rate)
    state = pukf.predict(state, params, inp.dt)

    if inp.acc is not None:
        state, _ = _masked_update(
            state, inp.acc_valid, pukf.update_acceleration, state, params, inp.acc, inp.acc_cov
        )
    dvl_info = None
    if inp.dvl is not None:
        state, dvl_info = _masked_update(
            state, inp.dvl_valid, pukf.update_velocity, state, params, inp.dvl, inp.dvl_cov
        )
    if inp.pressure is not None:
        state, _ = _masked_update(
            state,
            inp.pressure_valid,
            pukf.update_pressure,
            state,
            params,
            inp.pressure,
            inp.pressure_cov,
        )
    if inp.xy is not None:
        state, _ = _masked_update(
            state, inp.xy_valid, pukf.update_xy_position, state, params, inp.xy, inp.xy_cov
        )
    adcp_info = None
    if inp.adcp is not None:
        state, adcp_info = _masked_update(
            state,
            inp.adcp_valid,
            pukf.update_water_velocity,
            state,
            params,
            inp.adcp,
            inp.adcp_cov,
            inp.adcp_cell_weighting,
        )
    if inp.efforts is not None:
        state, _ = _masked_update(
            state,
            inp.efforts_valid,
            pukf.update_body_efforts,
            state,
            params,
            inp.efforts,
            inp.efforts_cov,
        )

    if inp.z is not None:
        state, _ = _masked_update(
            state, inp.z_valid, pukf.update_z_position, state, params, inp.z, inp.z_cov
        )
    gps_accepted = None
    if inp.gps is not None:
        gps_in_body = consts.gps_in_body if consts is not None else None
        state, gps_info = _masked_update(
            state,
            inp.gps_valid,
            pukf.update_geographic_position,
            state,
            params,
            inp.gps[0],
            inp.gps[1],
            inp.gps_cov,
            gps_in_body,
        )
        gps_accepted = inp.gps_valid & gps_info.accepted
    if inp.delayed_xy is not None:
        state, _ = _masked_update(
            state,
            inp.delayed_valid,
            pukf.update_delayed_position,
            state,
            params,
            inp.delayed_xy,
            inp.delayed_xy_cov,
            inp.delayed_position,
        )
    marker_nis = None
    if inp.marker_features is not None:
        if consts is None or consts.marker is None:
            raise ValueError(
                "schedule carries marker detections; pass "
                "PoseStepConstants(marker=MarkerSetup(...))"
            )
        ms = consts.marker
        state, m_info = _masked_update(
            state,
            inp.marker_valid,
            pukf.update_visual_features,
            state,
            params,
            inp.marker_features,
            inp.marker_feature_covs,
            ms.feature_positions,
            ms.marker_position,
            ms.marker_orientation,
            ms.cov_marker_pose,
            ms.camera,
            ms.camera_in_imu_position,
            ms.camera_in_imu_orientation,
        )
        marker_nis = jnp.where(inp.marker_valid, m_info.mahalanobis2, 0.0)

    zero = jnp.zeros_like(inp.dt)
    out = TickOutput(
        position=state.mu.position,
        orientation=state.mu.orientation,
        velocity=state.mu.velocity,
        cov_trace=jnp.trace(state.cov),
        dvl_nis=(
            jnp.where(inp.dvl_valid, dvl_info.mahalanobis2, 0.0)
            if dvl_info is not None
            else zero
        ),
        adcp_accepted=(
            inp.adcp_valid & adcp_info.accepted
            if adcp_info is not None
            else zero.astype(bool)
        ),
        gps_accepted=gps_accepted,
        marker_nis=marker_nis,
    )
    return state, out


def run_trajectory(
    state: pukf.PoseUKFState,
    params: pukf.PoseUKFParams,
    inputs: PoseInputs,
    consts: Optional[PoseStepConstants] = None,
) -> tuple[pukf.PoseUKFState, TickOutput]:
    """lax.scan over the packed schedule — one compilation for the whole
    replay; vmap this over a bank of initial states / parameter sets for
    fleet-scale reprocessing."""
    return jax.lax.scan(lambda s, i: pose_step(s, params, i, consts), state, inputs)


def pose_step_bank(
    bstate: pukf.PoseUKFState,
    params: pukf.PoseUKFParams,
    inp: PoseInputs,
    consts: Optional[PoseStepConstants] = None,
) -> tuple[pukf.PoseUKFState, TickOutput]:
    """Bank-level tick: same integration order as :func:`pose_step`, with
    each phase one bank-level call over the whole bank
    (``pukf.predict_bank`` / ``pukf.update_*_bank``). ``inp`` carries a
    leading bank axis on every leaf (per-vehicle sensor streams)."""
    banked = params.process_noise.ndim == 3  # per-instance (Monte-Carlo) params
    bstate = bstate._replace(rotation_rate=inp.rotation_rate)
    bstate = pukf.predict_bank(bstate, params, inp.dt[0])

    if inp.acc is not None:
        bstate, _ = _masked_update(
            bstate,
            inp.acc_valid,
            pukf.update_acceleration_bank,
            bstate,
            params,
            inp.acc,
            inp.acc_cov,
        )
    dvl_info = None
    if inp.dvl is not None:
        bstate, dvl_info = _masked_update(
            bstate,
            inp.dvl_valid,
            pukf.update_velocity_bank,
            bstate,
            params,
            inp.dvl,
            inp.dvl_cov,
        )
    # the pressure model reads params.atmospheric_pressure; the bank entry
    # handles banked values itself (a per-instance vmap)
    if inp.pressure is not None:
        bstate, _ = _masked_update(
            bstate,
            inp.pressure_valid,
            pukf.update_pressure_bank,
            bstate,
            params,
            inp.pressure,
            inp.pressure_cov,
        )
    if inp.xy is not None:
        bstate, _ = _masked_update(
            bstate,
            inp.xy_valid,
            pukf.update_xy_position_bank,
            bstate,
            params,
            inp.xy,
            inp.xy_cov,
        )
    adcp_info = None
    if inp.adcp is not None:
        bstate, adcp_info = _masked_update(
            bstate,
            inp.adcp_valid,
            pukf.update_water_velocity_bank,
            bstate,
            params,
            inp.adcp,
            inp.adcp_cov,
            inp.adcp_cell_weighting,
        )
    # body efforts need each instance's compensated body rate: shared params
    # ride the banked entry with per-instance rates; a banked (Monte-Carlo
    # sweep) parameter set must be vmapped alongside the state instead of
    # closed over as (B,...)-constants
    if inp.efforts is not None:

        def _efforts(bs):
            if banked:
                return jax.vmap(pukf.update_body_efforts)(
                    bs, params, inp.efforts, inp.efforts_cov
                )
            rr_bank = pukf.get_rotation_rate_bank(bs, params)
            return pukf.update_body_efforts_bank(
                bs, params, inp.efforts, inp.efforts_cov, rr_bank
            )

        bstate, _ = _masked_update(bstate, inp.efforts_valid, _efforts, bstate)

    if inp.z is not None:
        bstate, _ = _masked_update(
            bstate,
            inp.z_valid,
            pukf.update_z_position_bank,
            bstate,
            params,
            inp.z,
            inp.z_cov,
        )
    gps_accepted = None
    if inp.gps is not None:
        gps_in_body = consts.gps_in_body if consts is not None else None
        bstate, gps_info = _masked_update(
            bstate,
            inp.gps_valid,
            pukf.update_geographic_position_bank,
            bstate,
            params,
            inp.gps[:, 0],
            inp.gps[:, 1],
            inp.gps_cov,
            gps_in_body,
        )
        gps_accepted = inp.gps_valid & gps_info.accepted
    if inp.delayed_xy is not None:
        bstate, _ = _masked_update(
            bstate,
            inp.delayed_valid,
            pukf.update_delayed_position_bank,
            bstate,
            params,
            inp.delayed_xy,
            inp.delayed_xy_cov,
            inp.delayed_position,
        )
    marker_nis = None
    if inp.marker_features is not None:
        if consts is None or consts.marker is None:
            raise ValueError(
                "schedule carries marker detections; pass "
                "PoseStepConstants(marker=MarkerSetup(...))"
            )
        ms = consts.marker
        bstate, m_info = _masked_update(
            bstate,
            inp.marker_valid,
            pukf.update_visual_features_bank,
            bstate,
            params,
            inp.marker_features,
            inp.marker_feature_covs,
            ms.feature_positions,
            ms.marker_position,
            ms.marker_orientation,
            ms.cov_marker_pose,
            ms.camera,
            ms.camera_in_imu_position,
            ms.camera_in_imu_orientation,
        )
        marker_nis = jnp.where(inp.marker_valid[:, None], m_info.mahalanobis2, 0.0)

    zero = jnp.zeros_like(inp.dt)
    out = TickOutput(
        position=bstate.mu.position,
        orientation=bstate.mu.orientation,
        velocity=bstate.mu.velocity,
        cov_trace=jnp.trace(bstate.cov, axis1=-2, axis2=-1),
        dvl_nis=(
            jnp.where(inp.dvl_valid, dvl_info.mahalanobis2, 0.0)
            if dvl_info is not None
            else zero
        ),
        adcp_accepted=(
            inp.adcp_valid & adcp_info.accepted
            if adcp_info is not None
            else zero.astype(bool)
        ),
        gps_accepted=gps_accepted,
        marker_nis=marker_nis,
    )
    return bstate, out


def run_trajectory_bank(
    bstate: pukf.PoseUKFState,
    params: pukf.PoseUKFParams,
    inputs: PoseInputs,
    consts: Optional[PoseStepConstants] = None,
) -> tuple[pukf.PoseUKFState, TickOutput]:
    """Fleet-scale replay: ``lax.scan`` over ticks of :func:`pose_step_bank`
    — inputs have shape (T, bank, ...); one compilation. Note: unlike ``vmap(run_trajectory)``, the prediction interval is
    shared across the bank at each tick (the per-vehicle sensor values,
    validity, covariances and ADCP cell weightings still vary)."""
    return jax.lax.scan(
        lambda s, i: pose_step_bank(s, params, i, consts),
        bstate,
        inputs,
    )
