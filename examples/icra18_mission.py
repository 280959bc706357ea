"""ICRA'18-style synthetic survey mission — accuracy (ATE) demonstration.

Recreates the experiment family behind the reference library (Arnold &
Medagoda, "Robust model-aided inertial localization for autonomous underwater
vehicles", ICRA 2018 — cited at ``/root/reference/README.md:73-84``): an AUV
flies a lawn-mower survey at depth with a 100 Hz IMU, 5 Hz DVL, 10 Hz
pressure sensor and an intermittent surface GPS fix, including a mid-mission
**DVL dropout** window where the model-aided filter must coast on inertial +
hydrostatic data alone.

The whole replay is one ``lax.scan`` (``models.pose_driver.run_trajectory``)
— a single XLA compilation covering thousands of prediction/update ticks —
and the script reports the absolute trajectory error (ATE RMSE), final drift
and heading error against the simulated ground truth.

Run:
    python examples/icra18_mission.py                 # default device (f32 on a GPU)
    JAX_PLATFORMS=cpu python examples/icra18_mission.py --dtype f64
    python examples/icra18_mission.py --minutes 10 --dvl-dropout 120,240
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--minutes", type=float, default=3.0, help="mission duration")
    p.add_argument("--rate", type=float, default=100.0, help="IMU tick rate [Hz]")
    p.add_argument("--dtype", choices=["f32", "f64"], default=None,
                   help="default: f64 on CPU, f32 on an accelerator")
    p.add_argument("--dvl-dropout", default=None, metavar="T0,T1",
                   help="DVL outage window in seconds (e.g. 60,120)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smooth", action="store_true",
                   help="also run the unscented RTS smoother and report smoothed ATE")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    return p.parse_args(argv)


def simulate_mission(n, dt, rng, *, speed=0.75, leg_s=40.0, depth=-20.0, g=9.8209,
                     rho=1025.0, p_atm=101325.0, gyro_bias=(2e-5, -1e-5, 1.5e-5),
                     acc_bias=(2e-3, -1e-3, 1e-3), lat0=0.8, lon0=0.15, noise=True):
    """Ground truth + noisy sensor streams for a lawn-mower survey.

    Yaw-only attitude; headings alternate 0°/180° with 90° turn legs, the
    classic survey pattern of the ICRA'18 field trials. Returns everything in
    the filter's NWU navigation frame. ``noise=False`` returns CLEAN sensor
    streams (true biases still applied) — the fleet Monte-Carlo harness
    (``models/monte_carlo.py``) draws per-instance noise on device instead.
    """
    t = np.arange(n) * dt
    # yaw-rate schedule: straight legs with smooth 90°-turn transitions
    yaw_rate = np.zeros(n)
    turn_time = 8.0
    cycle = 2 * (leg_s + turn_time)
    tc = np.mod(t, cycle)
    in_turn1 = (tc >= leg_s) & (tc < leg_s + turn_time)
    in_turn2 = tc >= 2 * leg_s + turn_time
    yaw_rate[in_turn1] = np.pi / turn_time
    yaw_rate[in_turn2] = -np.pi / turn_time
    yaw = np.cumsum(yaw_rate) * dt

    # body-frame surge velocity -> nav velocity; gentle depth oscillation
    vz = 0.05 * np.sin(2 * np.pi * t / 60.0)
    vel = np.stack([speed * np.cos(yaw), speed * np.sin(yaw), vz], axis=1)
    pos = np.cumsum(vel, axis=0) * dt
    pos[:, 2] += depth
    acc = np.gradient(vel, dt, axis=0)

    # quaternion [w,x,y,z] for yaw about +z
    quat = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], axis=1)

    def rot_to_body(q, v):
        """R(q)⁻¹ v for yaw-only q."""
        c, s = np.cos(yaw), np.sin(yaw)
        return np.stack([c * v[:, 0] + s * v[:, 1], -s * v[:, 0] + c * v[:, 1], v[:, 2]], axis=1)

    # earth rotation in nav frame at lat0 (NWU: [Ω cosφ, 0, Ω sinφ])
    earthw = 7.292115e-5
    omega_e = np.array([earthw * np.cos(lat0), 0.0, earthw * np.sin(lat0)])
    omega_nav = np.stack([0 * yaw, 0 * yaw, yaw_rate], axis=1)
    # gyro: ω_imu = R⁻¹(ω_nav + ω_e) + b_g  (the filter removes earth rate)
    gyro = rot_to_body(quat, omega_nav + omega_e[None, :]) + np.asarray(gyro_bias)
    # accelerometer: f = R⁻¹(a + [0,0,g]) + b_a
    acc_m = rot_to_body(quat, acc + np.array([0.0, 0.0, g])[None, :]) + np.asarray(acc_bias)
    # DVL: body-frame velocity
    dvl = rot_to_body(quat, vel)
    # pressure: p = p_atm − z·g·ρ
    pressure = (p_atm - pos[:, 2] * g * rho)[:, None]
    if noise:
        gyro = gyro + rng.normal(scale=2e-5, size=(n, 3))
        acc_m = acc_m + rng.normal(scale=2e-3, size=(n, 3))
        dvl = dvl + rng.normal(scale=2e-3, size=(n, 3))
        pressure = pressure + rng.normal(scale=50.0, size=(n, 1))

    return dict(t=t, pos=pos, vel=vel, quat=quat, yaw=yaw, gyro=gyro, acc=acc_m,
                dvl=dvl, pressure=pressure, lat0=lat0, lon0=lon0, g=g, rho=rho, p_atm=p_atm)


def build_fleet_setup(minutes=1.0, rate=100.0, dtype_name="f32", seed=0):
    """(state, params, FleetMissionSpec) of this mission for the fleet
    Monte-Carlo harness (``models/monte_carlo.py``): clean truth streams,
    the same multi-rate schedule as :func:`main` (DVL 5 Hz, pressure 10 Hz)
    plus a χ²-95-gated surface fix every 30 s through the GeographicPosition
    path, and per-stream noise sigmas matching the solo replay."""
    import jax
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu.models import monte_carlo as mc
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn, geodesy as geo
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    dt = 1.0 / rate
    n = int(minutes * 60 * rate)
    sim = simulate_mission(n, dt, np.random.default_rng(seed), noise=False)

    cfg = default_pose_ukf_config()
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray(sim["pos"][0], dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.25,
        imu_in_nwu_rot=jnp.asarray(sim["quat"][0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=dt,
        dtype=dtype,
    )
    every = lambda hz: (np.arange(n) % max(1, int(round(rate / hz)))) == 0
    # clean gated surface fixes: truth XY through the FILTER's own projection
    # (so the anchor cancels), noise sigma 1.5 m converted to radians
    proj = params.projection
    lat, lon = geo.nav_to_world(
        proj,
        jnp.asarray(sim["pos"][:, 0], dtype),
        jnp.asarray(sim["pos"][:, 1], dtype),
    )
    m_rad = float(proj.m_rad)
    n_rad_cos = float(proj.n_rad_cos)
    spec = mc.FleetMissionSpec(
        dt=dt,
        gyro=jnp.asarray(sim["gyro"], dtype),
        acc=jnp.asarray(sim["acc"], dtype),
        dvl=jnp.asarray(sim["dvl"], dtype),
        pressure=jnp.asarray(sim["pressure"], dtype),
        truth_pos=jnp.asarray(sim["pos"], dtype),
        dvl_valid=jnp.asarray(every(5.0)),
        pressure_valid=jnp.asarray(every(10.0)),
        gyro_sigma=2e-5,
        acc_sigma=2e-3,
        dvl_sigma=2e-3,
        pressure_sigma=50.0,
        acc_cov=jnp.eye(3, dtype=dtype) * (2e-3) ** 2 * 4,
        dvl_cov=jnp.eye(3, dtype=dtype) * (2e-3) ** 2 * 4,
        pressure_cov=jnp.eye(1, dtype=dtype) * 50.0**2 * 4,
        gps=jnp.stack([lat, lon], axis=-1),
        gps_valid=jnp.asarray(every(1.0 / 30.0)),
        gps_lat_sigma=1.5 / m_rad,
        gps_lon_sigma=1.5 / n_rad_cos,
        gps_cov=jnp.eye(2, dtype=dtype) * 1.5**2 * 4,
    )
    return state, params, spec


def monte_carlo_params(params, n, dtype, seed=5, scale_sigma=0.2, p_atm_sigma=100.0):
    """Banked Monte-Carlo parameter draw of the fleet accuracy artifact —
    shared by ``bench.measure_bank_ate`` and its calibrating test
    (``tests/test_fleet_ate.py``) so the artifact and the asserted bounds
    measure the SAME fleet by construction: ±``scale_sigma`` process-noise /
    water-velocity-scale factors and a ±``p_atm_sigma`` Pa atmospheric-
    pressure offset per instance, every leaf banked."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    scales = jnp.asarray(
        1.0 + scale_sigma * rng.standard_normal(n).clip(-0.9, 0.9), dtype
    )
    bp = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n, *jnp.shape(x))), params
    )
    return bp._replace(
        process_noise=bp.process_noise * scales[:, None, None],
        water_velocity_scale=bp.water_velocity_scale * scales,
        atmospheric_pressure=bp.atmospheric_pressure
        + jnp.asarray(rng.normal(scale=p_atm_sigma, size=n), dtype),
    )


def main(argv=None):
    args = parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    backend = jax.default_backend()
    dtype_name = args.dtype or ("f64" if backend == "cpu" else "f32")
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32

    from slam_uwv_kalman_filters_tpu.models import pose_driver, pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.utils import metrics
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    dt = 1.0 / args.rate
    n = int(args.minutes * 60 * args.rate)
    rng = np.random.default_rng(args.seed)
    sim = simulate_mission(n, dt, rng)
    print(f"backend={backend} dtype={dtype_name} ticks={n} "
          f"({args.minutes:.1f} min @ {args.rate:.0f} Hz)")

    cfg = default_pose_ukf_config()  # defaults already match sim noise scales
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray(sim["pos"][0], dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.25,
        imu_in_nwu_rot=jnp.asarray(sim["quat"][0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=dt,
        dtype=dtype,
    )

    # sensor schedule: DVL @5 Hz, pressure @10 Hz (with optional DVL dropout)
    every = lambda hz: (np.arange(n) % max(1, int(round(args.rate / hz)))) == 0
    dvl_valid = every(5.0)
    if args.dvl_dropout:
        t0, t1 = (float(x) for x in args.dvl_dropout.split(","))
        dvl_valid &= ~((sim["t"] >= t0) & (sim["t"] < t1))
        print(f"DVL dropout: [{t0:.0f}s, {t1:.0f}s) — coasting on IMU+pressure")
    # intermittent surface GPS fix: one projected XY fix every 30 s (the
    # vehicle briefly acquires GPS between survey legs)
    xy = sim["pos"][:, :2] + rng.normal(scale=1.5, size=(n, 2))
    inputs = pose_driver.make_inputs(
        n, dt,
        rotation_rate=sim["gyro"],
        acc=sim["acc"], acc_cov=np.eye(3) * (2e-3) ** 2 * 4, acc_valid=every(100.0),
        dvl=sim["dvl"], dvl_cov=np.eye(3) * (2e-3) ** 2 * 4, dvl_valid=dvl_valid,
        pressure=sim["pressure"], pressure_cov=np.eye(1) * 50.0**2 * 4,
        pressure_valid=every(10.0),
        xy=xy, xy_cov=np.eye(2) * 1.5**2 * 4, xy_valid=every(1.0 / 30.0),
        dtype=dtype,
    )

    t0 = time.perf_counter()
    run = jax.jit(pose_driver.run_trajectory)
    final_state, outs = run(state, params, inputs)
    jax.block_until_ready(outs)
    compile_and_run = time.perf_counter() - t0

    smoothed_pos = None
    if args.smooth:
        from slam_uwv_kalman_filters_tpu.models import pose_smoother

        t1 = time.perf_counter()
        sm = jax.jit(pose_smoother.run_trajectory_smoothed)(state, params, inputs)
        jax.block_until_ready(sm.smoothed_cov)
        print(f"smoother wall time (incl. compile): {time.perf_counter() - t1:.1f}s")
        smoothed_pos = np.asarray(sm.smoothed_mu.position)

    est_pos = np.asarray(outs.position)
    est_yaw = 2 * np.arctan2(np.asarray(outs.orientation)[:, 3], np.asarray(outs.orientation)[:, 0])
    ate = float(metrics.ate_rmse(jnp.asarray(est_pos), jnp.asarray(sim["pos"], est_pos.dtype)))
    drift = float(np.linalg.norm(est_pos[-1] - sim["pos"][-1]))
    dist = float(np.sum(np.linalg.norm(np.diff(sim["pos"], axis=0), axis=1)))
    yaw_err = np.degrees(np.abs(np.angle(np.exp(1j * (est_yaw - sim["yaw"])))))

    print(f"replay wall time (incl. compile): {compile_and_run:.1f}s "
          f"({n / compile_and_run:.0f} ticks/s)")
    print(f"trajectory length: {dist:.0f} m")
    print(f"ATE RMSE:          {ate:.3f} m  ({100 * ate / dist:.3f}% of distance)")
    print(f"final drift:       {drift:.3f} m  ({100 * drift / dist:.3f}% of distance)")
    print(f"heading error:     mean {yaw_err.mean():.3f}°, max {yaw_err.max():.3f}°")
    if smoothed_pos is not None:
        s_ate = float(metrics.ate_rmse(jnp.asarray(smoothed_pos), jnp.asarray(sim["pos"], smoothed_pos.dtype)))
        print(f"smoothed ATE RMSE: {s_ate:.3f} m  ({100 * s_ate / dist:.3f}% of distance)")
        return s_ate, dist
    return ate, dist


if __name__ == "__main__":
    main()
