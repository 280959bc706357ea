"""PoseUKF tests (SURVEY.md §7 step 7, BASELINE configs[3]): construction
semantics, gyrocompassing process model, all measurement models, χ² gating,
marker augmentation, oracle cross-check of the 53-DOF predict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle as orc
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as geo
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration, default_pose_ukf_config

RNG = np.random.default_rng(23)
CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters()


def make_filter(**kw):
    args = dict(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.01,
        imu_in_nwu_rot=mf.quat_identity(),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=CFG,
        model_parameters=MODEL,
        imu_delta_t=0.01,
    )
    args.update(kw)
    return pukf.init_from_pose(**args)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def test_init_state_and_cov_blocks():
    state, params = make_filter()
    b = pukf.POSE_MANIFOLD.block
    cov = np.asarray(state.cov)
    # reference src/PoseUKF.cpp:323-342
    np.testing.assert_allclose(cov[b("position"), b("position")], np.eye(3) * 0.01)
    np.testing.assert_allclose(cov[b("velocity"), b("velocity")], np.eye(3))
    np.testing.assert_allclose(cov[b("acceleration"), b("acceleration")], 10 * np.eye(3))
    np.testing.assert_allclose(cov[b("gravity"), b("gravity")], [[0.05**2]])
    np.testing.assert_allclose(
        cov[b("water_velocity"), b("water_velocity")], CFG.water_velocity.limits**2 * np.eye(2)
    )
    # gravity initialised from the WGS-84 model at the configured location
    np.testing.assert_allclose(
        float(state.mu.gravity[0]),
        float(geo.wgs84_gravity(CFG.location.latitude, CFG.location.altitude)),
        atol=1e-12,
    )
    # (x,y,ψ) extraction from the 6×6 model matrices
    np.testing.assert_allclose(
        np.asarray(state.mu.inertia), np.asarray(dyn.extract_xy_yaw(MODEL.inertia_matrix))
    )
    # off-diagonal cross blocks start at zero
    np.testing.assert_allclose(cov[b("position"), b("velocity")], 0.0)


def test_process_noise_from_config_values():
    q = np.asarray(pukf.process_noise_from_config(CFG, 0.01))
    b = pukf.POSE_MANIFOLD.block
    jerk = np.asarray(CFG.max_jerk)
    np.testing.assert_allclose(
        np.diag(q[b("position"), b("position")]), 1.5 * (0.01**4 * ((1 / 6) * 0.25 * jerk) ** 2)
    )
    np.testing.assert_allclose(
        np.diag(q[b("velocity"), b("velocity")]), 1.5 * (0.01**2 * (0.5 * 0.25 * jerk) ** 2)
    )
    np.testing.assert_allclose(np.diag(q[b("acceleration"), b("acceleration")]), (0.25 * jerk) ** 2)
    np.testing.assert_allclose(q[b("gravity"), b("gravity")], [[1e-12]])
    tau = CFG.rotation_rate.bias_tau
    gi = np.asarray(CFG.rotation_rate.bias_instability)
    np.testing.assert_allclose(
        np.diag(q[b("bias_gyro"), b("bias_gyro")]), (2.0 / (tau * 0.01)) * gi**2
    )


# ---------------------------------------------------------------------------
# process model: gyrocompassing + IMU mechanization
# ---------------------------------------------------------------------------


def test_stationary_with_perfect_earthrate_gyro_keeps_heading():
    """A stationary vehicle whose gyro measures exactly the earth rotation
    (R⁻¹·ω_e) must keep its orientation: the process model subtracts the
    earth rate (src/PoseUKF.cpp:30-32) — the gyrocompassing property."""
    state, params = make_filter()
    lat = CFG.location.latitude
    w_e = geo.earth_rotation_nav(jnp.asarray(lat))
    rr = mf.quat_rotate_inv(state.mu.orientation, w_e)  # perfect FOG reading
    state = pukf.integrate_rotation_rate(state, rr)
    q0 = np.asarray(state.mu.orientation)
    step = jax.jit(lambda s: pukf.predict(s, params, 0.01))
    for _ in range(100):
        state = step(state)
    # orientation unchanged to high precision (1 s of propagation)
    assert abs(float(jnp.dot(state.mu.orientation, jnp.asarray(q0)))) > 1.0 - 1e-10
    # a zero-reading gyro instead yields a heading drift at earth rate
    state2, _ = make_filter()
    for _ in range(100):
        state2 = step(state2)
    ang = np.linalg.norm(np.asarray(mf.so3_boxminus(state2.mu.orientation, jnp.asarray(q0))))
    np.testing.assert_allclose(ang, geo.EARTHW * 1.0, rtol=1e-3)


def test_imu_mechanization_integrates():
    """Velocity integrates acceleration; position integrates velocity."""
    state, params = make_filter()
    acc = jnp.array([0.2, -0.1, 0.05])
    state = state._replace(mu=state.mu._replace(acceleration=acc))
    step = jax.jit(lambda s: pukf.predict(s, params, 0.01))
    for _ in range(100):
        state = step(state)
    np.testing.assert_allclose(np.asarray(state.mu.velocity), np.asarray(acc) * 1.0, atol=1e-6)
    # position ≈ ½at² (Euler: slightly less)
    np.testing.assert_allclose(
        np.asarray(state.mu.position), 0.5 * np.asarray(acc) * 1.0, rtol=0.05
    )


def test_markov_decay_toward_offsets():
    state, params = make_filter()
    state = state._replace(
        mu=state.mu._replace(
            bias_gyro=jnp.array([1e-3, 0, 0]), water_velocity=jnp.array([0.2, -0.1])
        )
    )
    bg_tau = float(params.gyro_bias_tau)
    wv_tau = float(params.water_velocity_tau)
    step = jax.jit(lambda s: pukf.predict(s, params, 0.01))
    for _ in range(100):
        state = step(state)
    # e-fold decay factors over 1 s
    np.testing.assert_allclose(
        float(state.mu.bias_gyro[0]), 1e-3 * np.exp(-1.0 / bg_tau), rtol=1e-3
    )
    np.testing.assert_allclose(
        float(state.mu.water_velocity[0]), 0.2 * np.exp(-1.0 / wv_tau), rtol=1e-2
    )


def test_predict_matches_numpy_oracle():
    """53-DOF unscented predict == independent NumPy oracle (process model
    re-derived in oracle form) to ~1e-9."""
    state, params = make_filter()
    rr = jnp.array([0.01, -0.02, 0.03])
    state = pukf.integrate_rotation_rate(state, rr)

    man = orc.OracleManifold(
        [
            ("position", orc.EuclidPart(3)),
            ("orientation", orc.SO3Part()),
            ("velocity", orc.EuclidPart(3)),
            ("acceleration", orc.EuclidPart(3)),
            ("bias_gyro", orc.EuclidPart(3)),
            ("bias_acc", orc.EuclidPart(3)),
            ("gravity", orc.EuclidPart(1)),
            ("inertia", orc.Mat33Part()),
            ("lin_damping", orc.Mat33Part()),
            ("quad_damping", orc.Mat33Part()),
            ("water_velocity", orc.EuclidPart(2)),
            ("water_velocity_below", orc.EuclidPart(2)),
            ("bias_adcp", orc.EuclidPart(2)),
            ("water_density", orc.EuclidPart(1)),
        ]
    )
    mu_o = {k: np.asarray(getattr(state.mu, k)) for k, _ in man.parts}
    dt = 0.01
    lat0 = CFG.location.latitude
    m_rad = float(params.projection.m_rad)
    taus = {
        "bias_gyro": (float(params.gyro_bias_tau), np.asarray(params.gyro_bias_offset)),
        "bias_acc": (float(params.acc_bias_tau), np.asarray(params.acc_bias_offset)),
        "inertia": (float(params.inertia_tau), np.asarray(params.inertia_offset)),
        "lin_damping": (float(params.lin_damping_tau), np.asarray(params.lin_damping_offset)),
        "quad_damping": (float(params.quad_damping_tau), np.asarray(params.quad_damping_offset)),
        "water_velocity": (float(params.water_velocity_tau), 0.0),
        "water_velocity_below": (float(params.water_velocity_tau), 0.0),
        "bias_adcp": (float(params.adcp_bias_tau), 0.0),
        "water_density": (float(params.water_density_tau), float(params.water_density_offset)),
    }

    def f_oracle(s):
        out = {k: np.copy(v) for k, v in s.items()}
        out["position"] = s["position"] + dt * s["velocity"]
        lat = lat0 + s["position"][0] / m_rad
        w_e = geo.EARTHW * np.array([np.cos(lat), 0.0, np.sin(lat)])
        ang = orc.q_rot(s["orientation"], np.asarray(rr) - s["bias_gyro"]) - w_e
        out["orientation"] = orc.so3_boxplus(s["orientation"], ang, dt)
        out["velocity"] = s["velocity"] + dt * s["acceleration"]
        for k, (tau, off) in taus.items():
            out[k] = s[k] + dt * (-1.0 / tau) * (s[k] - off)
        return out

    # effective Q replicating predictionStepImpl (:446-460)
    q0 = np.asarray(params.process_noise)
    q = q0.copy()
    b = pukf.POSE_MANIFOLD.block
    rot = np.asarray(mf.quat_to_matrix(state.mu.orientation))
    q[b("orientation"), b("orientation")] = rot @ q0[b("orientation"), b("orientation")] @ rot.T
    sv = np.asarray(state.mu.velocity) * np.array([1.0, 1.0, 10.0])
    extra = float(params.water_velocity_scale) * float(sv @ sv) * dt * np.eye(2)
    for name in ("water_velocity", "water_velocity_below"):
        q[b(name), b(name)] = q0[b(name), b(name)] + extra
    q *= dt**2

    mu_o2, cov_o2 = orc.oracle_predict(man, mu_o, np.asarray(state.cov), f_oracle, q)
    state2 = pukf.predict(state, params, dt)

    np.testing.assert_allclose(np.asarray(state2.mu.position), mu_o2["position"], atol=1e-12)
    np.testing.assert_allclose(
        np.abs(np.dot(np.asarray(state2.mu.orientation), mu_o2["orientation"])), 1.0, atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(state2.cov), cov_o2, atol=1e-9)


# ---------------------------------------------------------------------------
# measurement models
# ---------------------------------------------------------------------------


def test_velocity_update_pulls_velocity():
    state, params = make_filter()
    q = mf.quat_exp(jnp.array([0.0, 0.0, 0.5]))
    state = state._replace(mu=state.mu._replace(orientation=q))
    z_imu = jnp.array([1.0, 0.0, 0.0])  # surge in IMU frame
    state, info = pukf.update_velocity(state, params, z_imu, jnp.eye(3) * 1e-4)
    # expected nav velocity = R(q)·z
    np.testing.assert_allclose(
        np.asarray(state.mu.velocity), np.asarray(mf.quat_rotate(q, z_imu)), atol=1e-2
    )


def test_acceleration_update_includes_gravity_and_bias():
    state, params = make_filter()
    g = float(state.mu.gravity[0])
    # stationary, level: expected specific force = (0,0,g) + bias
    z = jnp.array([0.0, 0.0, g])
    state, info = pukf.update_acceleration(state, params, z, jnp.eye(3) * 1e-4)
    assert bool(info.accepted)
    np.testing.assert_allclose(float(info.mahalanobis2), 0.0, atol=1e-6)


def test_pressure_update_co_estimates_depth():
    state, params = make_filter()
    rho = float(state.mu.water_density[0])
    g = float(state.mu.gravity[0])
    depth = -7.0
    z = jnp.array([float(params.atmospheric_pressure) - depth * g * rho])
    state, info = pukf.update_pressure(state, params, z, jnp.array([[1.0]]))
    np.testing.assert_allclose(float(state.mu.position[2]), depth, atol=0.2)


def test_geographic_position_projects_and_gates():
    # prior loose enough (100 m 1σ) that a 100 m fix is χ²-consistent
    state, params = make_filter(imu_in_nwu_pos_cov=jnp.eye(3) * 1e4)
    # a GPS fix 100 m north of the anchor
    lat = CFG.location.latitude + 100.0 / float(params.projection.m_rad)
    lon = CFG.location.longitude
    state1, info = pukf.update_geographic_position(
        state, params, jnp.asarray(lat), jnp.asarray(lon), jnp.eye(2) * 25.0
    )
    assert bool(info.accepted)
    assert float(state1.mu.position[0]) > 50.0
    # an absurd fix (100 km away) must be χ²-rejected
    lat_bad = CFG.location.latitude + 1e5 / float(params.projection.m_rad)
    state2, info2 = pukf.update_geographic_position(
        state, params, jnp.asarray(lat_bad), jnp.asarray(lon), jnp.eye(2) * 25.0
    )
    assert not bool(info2.accepted)
    np.testing.assert_allclose(np.asarray(state2.mu.position), np.asarray(state.mu.position))


def test_water_velocity_update_blend_and_gate():
    state, params = make_filter()
    state = state._replace(
        mu=state.mu._replace(
            velocity=jnp.array([1.0, 0.0, 0.0]),
            water_velocity=jnp.array([0.3, 0.0]),
            water_velocity_below=jnp.array([0.1, 0.0]),
        )
    )
    # expected at cell_weighting w: w·(v−wvb) + (1−w)·(v−wv) + bias
    w = 0.7
    expected = w * (1.0 - 0.1) + (1 - w) * (1.0 - 0.3)
    z = jnp.array([expected, 0.0])
    _, info = pukf.update_water_velocity(state, params, z, jnp.eye(2) * 1e-4, w)
    assert bool(info.accepted)
    np.testing.assert_allclose(float(info.mahalanobis2), 0.0, atol=1e-6)
    # far-off ADCP reading is gated (χ²-95)
    _, info2 = pukf.update_water_velocity(
        state, params, jnp.array([50.0, 50.0]), jnp.eye(2) * 1e-4, w
    )
    assert not bool(info2.accepted)


def test_body_efforts_update_consistent_at_truth():
    state, params = make_filter()
    state = state._replace(
        mu=state.mu._replace(velocity=jnp.array([0.8, 0.1, 0.0])),
        rotation_rate=jnp.array([0.0, 0.0, 0.05]),
    )
    rr_body = pukf.get_rotation_rate(state, params)
    z = pukf._efforts_measurement(state.mu, params, rr_body)
    _, info = pukf.update_body_efforts(state, params, z, jnp.eye(6) * 1.0)
    assert bool(info.accepted)
    # innovation at the mean-consistent measurement is small relative to S
    assert float(info.mahalanobis2) < 1.0
    # only_affect_velocity variant runs and stays consistent
    _, info2 = pukf.update_body_efforts(state, params, z, jnp.eye(6) * 1.0, only_affect_velocity=True)
    assert float(info2.mahalanobis2) < 1.0


def test_delayed_position_shift():
    state, params = make_filter()
    state = state._replace(mu=state.mu._replace(position=jnp.array([10.0, 5.0, 0.0])))
    # measurement taken when the vehicle was at (8, 4): the shift re-anchors it
    state2, info = pukf.update_delayed_position(
        state, params, jnp.array([8.5, 4.2]), jnp.eye(2) * 0.01, jnp.array([8.0, 4.0])
    )
    # shifted measurement = (8.5,4.2) + (10−8, 5−4) = (10.5, 5.2); with prior
    # var == meas var (both 0.01) the posterior is the exact midpoint
    np.testing.assert_allclose(np.asarray(state2.mu.position[:2]), [10.25, 5.1], atol=1e-6)


def test_visual_features_recover_position():
    """59-DOF marker augmentation pulls the filter position toward truth."""
    state, params = make_filter(imu_in_nwu_pos_cov=jnp.eye(3) * 0.25)
    cam = CameraConfiguration(fx=400.0, fy=400.0, cx=320.0, cy=240.0)
    true_pos = jnp.array([0.2, -0.1, 0.05])

    marker_p = true_pos + jnp.array([0.0, 0.0, 4.0])
    marker_q = mf.quat_identity()
    half = 0.2
    corners = jnp.array(
        [[-half, -half, 0.0], [half, -half, 0.0], [half, half, 0.0], [-half, half, 0.0]]
    )

    def project(c):
        f_nav = mf.affine_apply(marker_q, marker_p, c)
        f_cam = f_nav - true_pos  # identity orientation, camera at IMU
        u = cam.fx * f_cam[0] / f_cam[2] + cam.cx
        v = cam.fy * f_cam[1] / f_cam[2] + cam.cy
        return jnp.array([u, v])

    pixels = jnp.stack([project(c) for c in corners])
    pixel_covs = jnp.tile(jnp.eye(2)[None] * 0.25, (4, 1, 1))

    for _ in range(5):
        state, info = pukf.update_visual_features(
            state,
            params,
            pixels,
            pixel_covs,
            corners,
            marker_p,
            marker_q,
            jnp.eye(6) * 1e-6,
            cam,
            jnp.zeros(3),
            mf.quat_identity(),
        )
    np.testing.assert_allclose(
        np.asarray(state.mu.position[:2]), np.asarray(true_pos[:2]), atol=0.03
    )
    assert state.cov.shape == (53, 53)


def test_reset_and_rotation_rate():
    state, params = make_filter()
    state = pukf.integrate_rotation_rate(state, jnp.array([0.1, 0.0, 0.0]))
    new_q = mf.quat_exp(jnp.array([0.0, 0.0, 1.0]))
    state = pukf.reset_with_external_pose(state, jnp.array([5.0, 5.0, -2.0]), new_q)
    np.testing.assert_allclose(np.asarray(state.mu.position), [5.0, 5.0, -2.0])
    rr = pukf.get_rotation_rate(state, params)
    # bias-free: rr = raw − R⁻¹ω_e
    w_e = geo.earth_rotation_nav(
        jnp.asarray(CFG.location.latitude + 5.0 / float(params.projection.m_rad))
    )
    expected = jnp.array([0.1, 0.0, 0.0]) - mf.quat_rotate_inv(new_q, w_e)
    np.testing.assert_allclose(np.asarray(rr), np.asarray(expected), atol=1e-12)


def test_class_wrapper_smoke():
    f = pukf.PoseUKF(
        np.zeros(3), np.eye(3) * 0.01, np.array([1.0, 0, 0, 0]), np.eye(3) * 1e-4, CFG, MODEL
    )
    f.integrate_rotation_rate(np.array([0.0, 0.0, 0.01]))
    f.prediction_step(0.01)
    f.integrate_velocity(np.array([0.1, 0.0, 0.0]), np.eye(3) * 1e-3)
    f.integrate_z_position(np.array([-2.0]), np.array([[0.01]]))
    info = f.integrate_pressure(
        np.array([float(f.params.atmospheric_pressure) + 20000.0]), np.array([[100.0**2]])
    )
    assert np.isfinite(float(info.mahalanobis2))
    with pytest.raises(ValueError):
        f.integrate_velocity(np.array([np.nan, 0, 0]), np.eye(3))
    assert f.sigma.shape == (53, 53)


def test_set_process_noise_covariance_all_wrappers():
    """The base class's raw-Q setter (setProcessNoiseCovariance,
    src/PoseUKF.cpp:438, src/VelocityUKF.cpp:54-56) on every filter wrapper."""
    from slam_uwv_kalman_filters_tpu.models import bottom_ukf as bukf
    from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as iukf
    from slam_uwv_kalman_filters_tpu.models import velocity_ukf as vukf

    f = pukf.PoseUKF(
        np.zeros(3), np.eye(3) * 0.01, np.array([1.0, 0, 0, 0]), np.eye(3) * 1e-4, CFG, MODEL
    )
    q = np.eye(53) * 1e-5
    f.set_process_noise_covariance(q)
    np.testing.assert_array_equal(np.asarray(f.params.process_noise), q)

    v = vukf.VelocityUKF(
        vukf.VelocityState(velocity=jnp.zeros(3), z_position=jnp.zeros(1)), np.eye(4) * 0.1
    )
    with pytest.raises(RuntimeError):
        v.set_process_noise_covariance(np.eye(4))
    v.setup_motion_model(MODEL)
    v.set_process_noise_covariance(np.eye(4) * 1e-4)
    np.testing.assert_array_equal(np.asarray(v.params.process_noise), np.eye(4) * 1e-4)

    b = bukf.BottomUKF(
        bukf.BottomState(distance=jnp.array([10.0]), normal=jnp.array([0.0, 0.0, 1.0])),
        np.diag([1.0, 0.05, 0.05]),
    )
    b.set_process_noise_covariance(np.eye(3) * 1e-3)
    np.testing.assert_array_equal(np.asarray(b.params.process_noise), np.eye(3) * 1e-3)

    i = iukf.IndirectPoseUKF((0.05,) * 3, (0.02,) * 3, 30.0)
    i.set_process_noise_covariance(np.eye(6) * 1e-6)
    np.testing.assert_array_equal(np.asarray(i.params.process_noise), np.eye(6) * 1e-6)


def test_update_bank_rejects_banked_params():
    """A measurement model closed over a banked parameter set cannot be
    evaluated per instance by a state-only vmap: update_bank refuses it
    unless the model declares it reads no parameters."""
    state, params = make_filter()
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    bstate = bankmod.replicate(state, 2)
    bparams = bankmod.replicate(params, 2)
    z = jnp.zeros((2, 3))
    r = jnp.eye(3)
    with pytest.raises(ValueError, match="banked parameter set"):
        pukf.update_bank(bstate, bparams, z, r, lambda s: s.velocity)
    out, _ = pukf.update_bank(
        bstate, bparams, z, r, lambda s: s.velocity, params_independent=True
    )
    assert out.cov.shape == (2, 53, 53)


def test_visual_features_info_stacked_per_corner():
    """update_visual_features reports every corner's NIS, not just the last
    one's — an outlier corner must stay visible to metrics monitoring."""
    state, params = make_filter()
    cam = CFG.visual_landmarks.camera_config
    corners = jnp.asarray(
        [[0.1, 0.1, 0.0], [-0.1, 0.1, 0.0], [-0.1, -0.1, 0.0], [0.1, -0.1, 0.0]]
    )
    marker_p = jnp.array([1.0, 0.0, 2.0])
    marker_q = mf.quat_exp(jnp.array([0.0, jnp.pi / 2, 0.0]))
    pixels = jnp.tile(jnp.array([cam.cx, cam.cy])[None], (4, 1))
    pixel_covs = jnp.tile(jnp.eye(2)[None] * 0.25, (4, 1, 1))
    _, info = pukf.update_visual_features(
        state, params, pixels, pixel_covs, corners, marker_p, marker_q,
        jnp.eye(6) * 1e-6, cam, jnp.zeros(3), mf.quat_identity(),
    )
    assert info.mahalanobis2.shape == (4,)
    assert info.accepted.shape == (4,)
    assert np.all(np.isfinite(np.asarray(info.mahalanobis2)))


def test_wrapper_noise_setters_pin_state_dtype():
    """set_process_noise_from_config / set_process_noise_covariance keep Q at
    the filter's state dtype (regression: a float64 Q on a float32 filter
    promoted the covariance on the next predict)."""
    state, params = make_filter()
    f32_state = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        state.mu,
    )
    f = pukf.PoseUKF.from_state(f32_state, state.cov.astype(jnp.float32), params)
    f.set_process_noise_from_config(CFG, 0.01)
    assert f.params.process_noise.dtype == jnp.float32
    f.set_process_noise_covariance(np.eye(53) * 1e-8)
    assert f.params.process_noise.dtype == jnp.float32
    f.prediction_step(0.01)
    assert f.state.cov.dtype == jnp.float32
