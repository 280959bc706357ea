"""ICRA'18-style model-aided inertial localization run (BASELINE configs[3]):
synthetic ground truth with earth-rate-aware IMU, DVL, pressure and ADCP
streams replayed through the scan driver; asserts the ATE bound and filter
consistency. This is the acceptance scenario of BASELINE.md."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_driver as drv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as geo
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils import metrics
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters()
RNG = np.random.default_rng(99)


def simulate_truth(T, dt):
    """Lawnmower-ish survey: surge at 1 m/s with yaw-rate segments at constant
    depth. Returns nav-frame truth + ideal sensor streams (f64 NumPy)."""
    lat0 = CFG.location.latitude
    g = float(geo.wgs84_gravity(lat0, CFG.location.altitude))
    proj_m = float(geo.make_projection(lat0, CFG.location.longitude).m_rad)

    pos = np.zeros((T + 1, 3))
    pos[0] = [0.0, 0.0, -5.0]
    q = np.zeros((T + 1, 4))
    q[0] = [1.0, 0, 0, 0]
    vel = np.zeros((T + 1, 3))
    acc = np.zeros((T, 3))
    gyro = np.zeros((T, 3))
    accel_meas = np.zeros((T, 3))

    surge = 1.0
    import oracle as orc

    for k in range(T):
        t = k * dt
        yaw_rate = 0.15 if (t % 40.0) < 8.0 else 0.0
        R = orc.q_to_mat(q[k])
        v_body = np.array([surge, 0.0, 0.0])
        vel[k] = R @ v_body
        # nav-frame acceleration from rotating body velocity: a = ω×v
        w_nav = np.array([0.0, 0.0, yaw_rate])
        acc[k] = np.cross(w_nav, vel[k])
        # truth propagation (same integrator family as the filter)
        pos[k + 1] = pos[k] + dt * vel[k]
        q[k + 1] = orc.so3_boxplus(q[k], w_nav, dt)
        vel[k + 1] = vel[k] + dt * acc[k]

        # ideal gyro: body rate + earth rate (the FOG senses earth rotation)
        lat = lat0 + pos[k][0] / proj_m
        w_e = geo.EARTHW * np.array([np.cos(lat), 0.0, np.sin(lat)])
        gyro[k] = R.T @ (w_nav + w_e)
        # ideal accelerometer: specific force in body frame
        accel_meas[k] = R.T @ (acc[k] + np.array([0.0, 0.0, g]))

    return dict(pos=pos, q=q, vel=vel, gyro=gyro, accel=accel_meas, g=g)


def test_icra18_style_trajectory_ate():
    T = 1500  # 15 s at 100 Hz — enough for two turn segments
    dt = 0.01
    truth = simulate_truth(T, dt)

    # noisy sensors
    gyro_n = truth["gyro"] + RNG.normal(0, 3e-5, (T, 3))
    acc_n = truth["accel"] + RNG.normal(0, 2e-3, (T, 3))
    dvl_valid = (np.arange(T) % 20) == 19  # 5 Hz
    rho = CFG.hydrostatics.water_density
    p_atm = CFG.hydrostatics.atmospheric_pressure
    dvl = np.zeros((T, 3))
    for k in np.where(dvl_valid)[0]:
        import oracle as orc

        dvl[k] = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1] + RNG.normal(0, 0.01, 3)
    press_valid = (np.arange(T) % 50) == 49  # 2 Hz
    press = p_atm - truth["pos"][1:, 2:3] * truth["g"] * rho + RNG.normal(0, 50.0, (T, 1))
    adcp_valid = (np.arange(T) % 100) == 99  # 1 Hz, zero currents in truth
    adcp = np.zeros((T, 2))
    for k in np.where(adcp_valid)[0]:
        import oracle as orc

        v_imu = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1]
        adcp[k] = v_imu[:2] + RNG.normal(0, 0.02, 2)

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

    run = jax.jit(drv.run_trajectory)
    final, outs = run(state, params, inputs)

    est = np.asarray(outs.position)
    tru = truth["pos"][1:]
    ate = float(metrics.ate_rmse(jnp.asarray(est), jnp.asarray(tru)))
    final_err = np.linalg.norm(est[-1] - tru[-1])
    heading_err = abs(
        float(metrics.heading_error(outs.orientation[-1], jnp.asarray(truth["q"][-1])))
    )

    # BASELINE acceptance: model-aided inertial localization stays within a
    # tight ATE bound with 5 Hz DVL + 2 Hz pressure aiding over 15 s
    assert ate < 0.15, f"ATE {ate:.3f} m too large"
    assert final_err < 0.3, f"final error {final_err:.3f} m"
    assert heading_err < 0.02, f"heading error {heading_err:.4f} rad"
    # velocity tracked through the turns
    v_err = np.linalg.norm(np.asarray(outs.velocity) - truth["vel"][1:], axis=1)
    assert float(np.median(v_err)) < 0.05
    # covariance stayed finite and bounded
    assert np.all(np.isfinite(np.asarray(outs.cov_trace)))


def test_dvl_dropout_model_aiding():
    """README.md:10 capability: with DVL dropout, the motion-model effort
    measurement keeps velocity bounded vs. pure inertial drift."""
    T = 800
    dt = 0.01
    truth = simulate_truth(T, dt)
    gyro_n = truth["gyro"]
    acc_n = truth["accel"] + RNG.normal(0, 2e-3, (T, 3))

    # efforts consistent with steady surge: tau = D_lin v + D_quad |v|v
    tau = np.zeros((T, 6))
    import oracle as orc

    for k in range(T):
        R = orc.q_to_mat(truth["q"][k])
        vb = R.T @ truth["vel"][k]
        w_nav_z = 0.15 if ((k * dt) % 40.0) < 8.0 else 0.0
        vel6 = np.concatenate([vb, R.T @ np.array([0, 0, w_nav_z])])
        # truth["accel"] is the body-frame specific force R⁻¹(a+[0,0,g]);
        # the effort model wants body-frame acceleration R⁻¹a
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

    # DVL only for the first 2 s, then dropout; efforts at 10 Hz throughout
    dvl_valid = ((np.arange(T) % 20) == 19) & (np.arange(T) < 200)
    dvl = np.zeros((T, 3))
    for k in np.where(dvl_valid)[0]:
        dvl[k] = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1]
    eff_valid = (np.arange(T) % 10) == 9

    inputs = drv.make_inputs(
        T,
        dt,
        gyro_n,
        acc=acc_n,
        acc_cov=np.eye(3) * 4e-5,
        dvl=dvl,
        dvl_cov=np.eye(3) * 1e-4,
        dvl_valid=dvl_valid,
        efforts=tau,
        efforts_cov=np.diag(np.asarray(CFG.model_noise_parameters.body_efforts_std) ** 2),
        efforts_valid=eff_valid,
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
    v_err_end = np.linalg.norm(np.asarray(outs.velocity[-1]) - truth["vel"][-1])
    # model aiding keeps velocity error bounded through 6 s of DVL dropout
    assert v_err_end < 0.2, f"velocity drift {v_err_end:.3f} m/s despite model aiding"


def test_pose_step_bank_matches_vmap_pose_step():
    """Bank-level tick (generic dispatch on CPU) == vmap of the per-instance
    tick when dt/cell-weighting are shared."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_uwv_kalman_filters_tpu.models import pose_driver, pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    rng = np.random.default_rng(5)
    n = 3
    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters()
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=cfg,
        model_parameters=model,
        imu_delta_t=0.01,
    )
    bstate = bankmod.replicate(state, n)
    bstate = bstate._replace(
        mu=bstate.mu._replace(velocity=jnp.asarray(rng.normal(scale=0.2, size=(n, 3))))
    )
    # one tick with per-vehicle streams: DVL valid for 2 of 3, pressure for 1
    inp = pose_driver.PoseInputs(
        dt=jnp.full((n,), 0.05),
        rotation_rate=jnp.asarray(rng.normal(scale=0.02, size=(n, 3))),
        acc=jnp.asarray(rng.normal(scale=0.1, size=(n, 3))),
        acc_cov=jnp.tile(jnp.eye(3)[None] * 1e-2, (n, 1, 1)),
        acc_valid=jnp.asarray([True, True, True]),
        dvl=jnp.asarray(rng.normal(scale=0.2, size=(n, 3))),
        dvl_cov=jnp.tile(jnp.eye(3)[None] * 1e-3, (n, 1, 1)),
        dvl_valid=jnp.asarray([True, False, True]),
        pressure=jnp.full((n, 1), 101325.0 + 2e5),
        pressure_cov=jnp.tile(jnp.eye(1)[None] * 2500.0, (n, 1, 1)),
        pressure_valid=jnp.asarray([True, False, False]),
        xy=jnp.zeros((n, 2)),
        xy_cov=jnp.tile(jnp.eye(2)[None], (n, 1, 1)),
        xy_valid=jnp.asarray([False, True, False]),
        adcp=jnp.zeros((n, 2)),
        adcp_cov=jnp.tile(jnp.eye(2)[None] * 1e-2, (n, 1, 1)),
        adcp_cell_weighting=jnp.full((n,), 0.7),
        adcp_valid=jnp.asarray([True, True, False]),
        efforts=jnp.asarray(rng.normal(scale=1.0, size=(n, 6))),
        efforts_cov=jnp.tile(jnp.eye(6)[None] * 1e-1, (n, 1, 1)),
        efforts_valid=jnp.asarray([False, True, True]),
    )
    out_bank, _ = pose_driver.pose_step_bank(bstate, params, inp)
    out_ref, _ = jax.vmap(lambda s, i: pose_driver.pose_step(s, params, i))(bstate, inp)
    np.testing.assert_allclose(np.asarray(out_bank.cov), np.asarray(out_ref.cov), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out_bank.mu.position), np.asarray(out_ref.mu.position), atol=1e-12
    )


def test_make_inputs_constant_vectors():
    """Constant per-tick values tile across the schedule like constant
    covariances always did (regression: a (3,) constant rotation_rate was
    passed through untiled and broke the scan with a shape error)."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv

    n = 5
    inp = drv.make_inputs(
        n, 0.01, (0.0, 0.0, 0.1),
        dvl=(0.3, 0.0, 0.0), dvl_cov=jnp.eye(3) * 1e-3,
        adcp=(0.1, 0.0), adcp_cov=jnp.eye(2) * 1e-2,
        adcp_cell_weighting=0.7, adcp_valid=True,
    )
    assert inp.rotation_rate.shape == (n, 3)
    np.testing.assert_array_equal(np.asarray(inp.rotation_rate[3]), [0.0, 0.0, 0.1])
    assert inp.dvl.shape == (n, 3) and inp.adcp.shape == (n, 2)
    assert inp.adcp_cell_weighting.shape == (n,)
    np.testing.assert_array_equal(np.asarray(inp.adcp_valid), [True] * n)
    # a wrong-length stream still fails loudly
    with pytest.raises(ValueError, match="expected"):
        drv.make_inputs(n, 0.01, np.zeros((n + 1, 3)))


def test_pose_step_bank_banked_params():
    """Bank tick with a per-instance (Monte-Carlo sweep) parameter set must
    equal vmap of the per-instance tick over (state, params) — regression:
    the body-efforts tail closed over the banked params as constants and
    crashed; the pressure phase rejected banked params outright."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_uwv_kalman_filters_tpu.models import pose_driver, pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    rng = np.random.default_rng(11)
    n = 3
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=dyn.default_uwv_parameters(),
        imu_delta_t=0.01,
    )
    bstate = bankmod.replicate(state, n)
    bstate = bstate._replace(
        mu=bstate.mu._replace(velocity=jnp.asarray(rng.normal(scale=0.2, size=(n, 3))))
    )
    scales = jnp.asarray([0.5, 1.0, 2.0])
    pbank = jax.vmap(
        lambda s: params._replace(
            process_noise=params.process_noise * s,
            gyro_bias_tau=params.gyro_bias_tau * s,
        )
    )(scales)

    inp = pose_driver.make_inputs(
        1, 0.05, rng.normal(scale=0.02, size=(1, 3)),
        dvl=rng.normal(scale=0.2, size=(1, 3)), dvl_cov=jnp.eye(3) * 1e-3,
        pressure=np.full((1, 1), 101325.0 + 2e5), pressure_cov=jnp.eye(1) * 2500.0,
        efforts=rng.normal(scale=1.0, size=(1, 6)), efforts_cov=jnp.eye(6) * 1e-1,
    )
    # broadcast the single tick across the bank axis
    inp_bank = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[0], (n,) + a.shape[1:]), inp
    )

    out_bank, _ = pose_driver.pose_step_bank(bstate, pbank, inp_bank)
    out_ref, _ = jax.vmap(pose_driver.pose_step)(bstate, pbank, inp_bank)
    np.testing.assert_allclose(np.asarray(out_bank.cov), np.asarray(out_ref.cov), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out_bank.mu.velocity), np.asarray(out_ref.mu.velocity), atol=1e-12
    )
    # the sweep axis actually differentiates the instances
    assert not np.allclose(np.asarray(out_bank.cov[0]), np.asarray(out_bank.cov[2]))


def test_absent_sensor_groups_match_all_invalid_masks():
    """A schedule whose sensor groups are None (absent — their update phases
    are not even traced) must produce exactly the state a dense schedule with
    all-invalid validity masks produces: absence and never-valid are the same
    semantics, absence is just cheaper (r4 optional-stream driver API)."""
    import jax

    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv

    T = 6
    dtype = jnp.float64
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.01,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=CFG,
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=0.05,
        dtype=dtype,
    )
    rng = np.random.default_rng(17)
    gyro = rng.normal(scale=0.02, size=(T, 3))
    acc = rng.normal(scale=0.05, size=(T, 3)) + np.array([0, 0, 9.81])
    dvl = rng.normal(scale=0.2, size=(T, 3))

    dense = drv.make_inputs(
        T, 0.05, gyro,
        acc=acc, acc_cov=np.eye(3) * 4e-5,
        dvl=dvl, dvl_cov=np.eye(3) * 1e-3, dvl_valid=rng.random(T) < 0.7,
        # xy/adcp/pressure/efforts present but never valid
        pressure=np.full((T, 1), 101325.0), pressure_valid=np.zeros(T, bool),
        xy=rng.normal(size=(T, 2)), xy_valid=np.zeros(T, bool),
        adcp=rng.normal(scale=0.05, size=(T, 2)), adcp_valid=np.zeros(T, bool),
        efforts=rng.normal(size=(T, 6)), efforts_valid=np.zeros(T, bool),
        dtype=dtype,
    )
    lean = dense._replace(
        pressure=None, pressure_cov=None, pressure_valid=None,
        xy=None, xy_cov=None, xy_valid=None,
        adcp=None, adcp_cov=None, adcp_cell_weighting=None, adcp_valid=None,
        efforts=None, efforts_cov=None, efforts_valid=None,
    )

    fs_d, out_d = drv.run_trajectory(state, params, dense)
    fs_l, out_l = drv.run_trajectory(state, params, lean)
    np.testing.assert_array_equal(np.asarray(fs_l.cov), np.asarray(fs_d.cov))
    np.testing.assert_array_equal(
        np.asarray(out_l.position), np.asarray(out_d.position)
    )
    np.testing.assert_array_equal(
        np.asarray(out_l.dvl_nis), np.asarray(out_d.dvl_nis)
    )
    assert not np.any(np.asarray(out_l.adcp_accepted))

    # same equivalence on the bank tick
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    B = 2
    bstate = bankmod.replicate(state, B)
    bank_dense = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x)[:, None, ...], (T, B, *np.shape(x)[1:])),
        dense,
    )
    bank_lean = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x)[:, None, ...], (T, B, *np.shape(x)[1:])),
        lean,
    )
    fs_bd, _ = drv.run_trajectory_bank(bstate, params, bank_dense)
    fs_bl, _ = drv.run_trajectory_bank(bstate, params, bank_lean)
    np.testing.assert_array_equal(np.asarray(fs_bl.cov), np.asarray(fs_bd.cov))


@pytest.mark.parametrize("bank", [False, True], ids=["solo", "bank"])
def test_masked_update_skips_when_no_instance_has_data(bank):
    """_masked_update runs the update only when some instance has the
    measurement: with none, the state passes through bit-exact and the info
    is all zeros; with some, only those instances change."""
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=CFG,
        model_parameters=dyn.default_uwv_parameters(),
        imu_delta_t=0.01,
    )
    n = 3
    if bank:
        s = bankmod.replicate(state, n)
        fn, z, valid = pukf.update_velocity_bank, jnp.full((n, 3), 0.5), jnp.zeros(n, bool)
        some = jnp.array([True, False, True])
    else:
        s = state
        fn, z, valid, some = pukf.update_velocity, jnp.full(3, 0.5), jnp.asarray(False), jnp.asarray(True)
    r = jnp.eye(3) * 1e-3
    run = jax.jit(lambda s, v: drv._masked_update(s, v, fn, s, params, z, r))
    out, info = run(s, valid)
    np.testing.assert_array_equal(np.asarray(out.cov), np.asarray(s.cov))
    assert not np.asarray(info.mahalanobis2).any()
    out, info = run(s, some)
    moved = np.abs(np.asarray(out.mu.velocity) - np.asarray(s.mu.velocity)).reshape(-1, 3).max(axis=1)
    np.testing.assert_array_equal(moved > 0.1, np.atleast_1d(np.asarray(some)))
