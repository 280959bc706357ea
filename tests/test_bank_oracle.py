"""The generic bank path in f32 against the independent f64 NumPy oracle.

Every PoseUKF bank entry point (each sensor model, gated and ungated, shared
and banked parameters, the prediction) runs a heterogeneous f32 bank and is
compared, instance by instance, with ``tests/oracle.py`` in f64 on the same
scenario; the VelocityUKF bank uses the oracle filter of that module. The
oracle's measurement models below are re-derived in NumPy from the
reference (``src/PoseUKF.cpp``), not imported from the package.

Tolerances. Means are compared in metres / radians / SI units at 2e-4 of
each field's scale; covariances element-wise after normalising by
√(Pᵢᵢ·Pⱼⱼ) of the PRIOR covariance (raw entries span 1e-11..1e1, and
P − K·S·Kᵀ is the difference of prior-sized terms, so that is the scale of
its f32 error) at 2e-3: f32's 6e-8 unit roundoff amplified by the ~1e3
condition of the equilibrated 53×53 correlation matrix and 107-term sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle as orc
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.models import velocity_ukf as vukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as geo
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.ops import ukf
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

CFG = default_pose_ukf_config()
NB = 3
MEAN_RTOL = 2e-4
COV_TOL = 2e-3

POSE_ORACLE = orc.OracleManifold(
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


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree
    )


def _pose_bank(seed=0):
    """Heterogeneous f64 bank: perturbed means and a fully correlated
    covariance that keeps the raw-unit variance spread of the initial one."""
    rng = np.random.default_rng(seed)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=mf.quat_identity(),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=CFG,
        model_parameters=dyn.default_uwv_parameters(),
        imu_delta_t=0.01,
    )
    b = bankmod.replicate(state, NB)
    d = np.sqrt(np.diag(np.asarray(state.cov)))
    covs = []
    for _ in range(NB):
        w = rng.normal(size=(53, 53))
        corr = 0.8 * np.eye(53) + 0.2 * (w @ w.T) / 53
        s = 1.0 / np.sqrt(np.diag(corr))
        covs.append(d[:, None] * (corr * s[:, None] * s[None, :]) * d[None, :])
    mu = b.mu._replace(
        position=b.mu.position + rng.normal(scale=1.0, size=(NB, 3)),
        velocity=b.mu.velocity + rng.normal(scale=0.3, size=(NB, 3)),
        acceleration=b.mu.acceleration + rng.normal(scale=0.1, size=(NB, 3)),
        water_velocity=b.mu.water_velocity + rng.normal(scale=0.05, size=(NB, 2)),
        orientation=jax.vmap(mf.so3_boxplus)(
            b.mu.orientation, jnp.asarray(rng.normal(scale=0.2, size=(NB, 3)))
        ),
    )
    b = b._replace(
        mu=mu,
        cov=jnp.asarray(np.stack(covs)),
        rotation_rate=jnp.asarray(rng.normal(scale=0.02, size=(NB, 3))),
    )
    return b, params


def _oracle_mu(bstate, i):
    return {k: np.asarray(getattr(bstate.mu, k)[i], np.float64) for k, _ in POSE_ORACLE.parts}


def _assert_pose_matches(out32, mu_o, cov_o, i, prior):
    for name, _ in POSE_ORACLE.parts:
        got = np.asarray(getattr(out32.mu, name)[i], np.float64)
        want = np.ravel(mu_o[name])
        if name == "orientation":
            np.testing.assert_allclose(abs(float(got @ want)), 1.0, atol=1e-6)
            continue
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(np.ravel(got), want, atol=MEAN_RTOL * scale, err_msg=name)
    got = np.asarray(out32.cov[i], np.float64)
    s = np.sqrt(np.maximum(np.diag(cov_o), np.diag(np.asarray(prior))))
    err = np.abs(got - cov_o) / (s[:, None] * s[None, :])
    assert err.max() < COV_TOL, f"cov deviates {err.max():.2e} (correlation scale)"


# --- oracle measurement models (src/PoseUKF.cpp:86-196), NumPy f64 ----------


def _h_velocity(s):
    return orc.q_rot(orc.q_conj(s["orientation"]), s["velocity"])


def _h_acceleration(s):
    g = np.array([0.0, 0.0, s["gravity"][0]])
    return orc.q_rot(orc.q_conj(s["orientation"]), s["acceleration"] + g) + s["bias_acc"]


def _h_pressure(p_atm, lever):
    def h(s):
        z = (s["position"] + orc.q_rot(s["orientation"], lever))[2]
        return np.array([p_atm - z * s["gravity"][0] * s["water_density"][0]])

    return h


def _h_water_velocity(cw):
    def h(s):
        rinv = lambda v: orc.q_rot(orc.q_conj(s["orientation"]), v)
        below = rinv(s["velocity"] - np.append(s["water_velocity_below"], 0.0))
        at = rinv(s["velocity"] - np.append(s["water_velocity"], 0.0))
        return cw * below[:2] + (1.0 - cw) * at[:2] + s["bias_adcp"]

    return h


def _h_efforts(params, rr):
    m = params.model
    idx = np.ix_([0, 1, 5], [0, 1, 5])
    t = np.asarray(params.imu_in_body, np.float64)

    def h(s):
        mats = []
        for full, block in (
            (m.inertia_matrix, s["inertia"]),
            (m.damping_linear, s["lin_damping"]),
            (m.damping_quadratic, s["quad_damping"]),
        ):
            full = np.array(full, np.float64)
            full[idx] = block
            mats.append(full)
        rinv = lambda v: orc.q_rot(orc.q_conj(s["orientation"]), v)
        vel = rinv(s["velocity"]) - np.cross(rr, t) - rinv(np.append(s["water_velocity"], 0.0))
        acc = rinv(s["acceleration"]) - np.cross(rr, np.cross(rr, t))
        return orc.oracle_calc_efforts(
            mats[0], mats[1], mats[2], float(m.weight), float(m.buoyancy),
            np.asarray(m.cog, np.float64), np.asarray(m.cob, np.float64),
            np.concatenate([acc, np.zeros(3)]), np.concatenate([vel, rr]), s["orientation"],
        )

    return h


def _pose_update_case(name, b, params, rng):
    """(bank call on the f32 bank, [per-instance oracle (h, z, R, gate)])."""
    z3 = lambda scale: rng.normal(scale=scale, size=(NB, 3))
    if name == "velocity":
        z, r = z3(0.3), np.eye(3) * 1e-3
        call = lambda bs, p: pukf.update_velocity_bank(bs, p, z, r)
        return call, [(_h_velocity, z[i], r, None) for i in range(NB)]
    if name == "acceleration":
        z, r = z3(0.05) + [0, 0, 9.81], np.eye(3) * 4e-5
        call = lambda bs, p: pukf.update_acceleration_bank(bs, p, z, r)
        return call, [(_h_acceleration, z[i], r, None) for i in range(NB)]
    if name == "z_position":
        z, r = rng.normal(size=(NB, 1)), np.eye(1) * 1e-2
        call = lambda bs, p: pukf.update_z_position_bank(bs, p, z, r)
        return call, [(lambda s: s["position"][2:3], z[i], r, None) for i in range(NB)]
    if name in ("xy_position", "xy_position_gated", "xy_position_gate_rejects"):
        pos = np.asarray(b.mu.position[:, :2])
        off = 1e3 if name == "xy_position_gate_rejects" else 0.2
        z, r = pos + rng.normal(scale=off, size=(NB, 2)), np.eye(2) * 0.04
        gate = None if name == "xy_position" else ukf.D2P95
        call = lambda bs, p: pukf.update_xy_position_bank(bs, p, z, r, gate)
        return call, [(lambda s: s["position"][:2], z[i], r, gate) for i in range(NB)]
    if name in ("pressure", "pressure_banked_params"):
        lever = np.array([0.1, -0.2, 0.3])
        p_atm = np.full(NB, float(params.atmospheric_pressure))
        if name == "pressure_banked_params":
            p_atm = p_atm + rng.normal(scale=100.0, size=NB)
        z = (p_atm - np.asarray(b.mu.position[:, 2]) * 9.81 * 1025.0)[:, None] + 30.0
        r = np.eye(1) * 2500.0

        def call(bs, p):
            if name == "pressure_banked_params":
                p = bankmod.replicate(p, NB)._replace(atmospheric_pressure=jnp.asarray(p_atm, jnp.float32))
            return pukf.update_pressure_bank(bs, p, z, r, lever)

        return call, [(_h_pressure(p_atm[i], lever), z[i], r, None) for i in range(NB)]
    if name in ("water_velocity", "water_velocity_per_instance_cells"):
        cw = 0.7 if name == "water_velocity" else rng.uniform(0.1, 0.9, NB)
        z, r = rng.normal(scale=0.1, size=(NB, 2)), np.eye(2) * 1e-2
        call = lambda bs, p: pukf.update_water_velocity_bank(bs, p, z, r, cw)
        cws = np.broadcast_to(cw, (NB,))
        return call, [(_h_water_velocity(cws[i]), z[i], r, ukf.D2P95) for i in range(NB)]
    if name in ("body_efforts", "body_efforts_per_instance_rates"):
        rr = (
            np.array([0.01, -0.02, 0.03])
            if name == "body_efforts"
            else rng.normal(scale=0.02, size=(NB, 3))
        )
        z, r = rng.normal(scale=2.0, size=(NB, 6)), np.eye(6) * 0.1
        call = lambda bs, p: pukf.update_body_efforts_bank(bs, p, z, r, rr)
        rrs = np.broadcast_to(rr, (NB, 3))
        return call, [(_h_efforts(params, rrs[i]), z[i], r, None) for i in range(NB)]
    if name == "geographic_position":
        proj = params.projection
        pos = np.asarray(b.mu.position[:, :2]) + rng.normal(scale=0.3, size=(NB, 2))
        lat, lon = geo.nav_to_world(proj, jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]))
        # a fix and a projection anchor in f32 radians carry ~0.3 m of
        # rounding: the oracle projects the same rounded values, in f64
        lat, lon = np.float32(lat), np.float32(lon)
        proj32 = jax.tree_util.tree_map(lambda a: jnp.float64(np.float32(a)), proj)
        x, y = geo.world_to_nav(proj32, jnp.float64(lat), jnp.float64(lon))
        lever, r = np.array([0.4, 0.0, -1.0]), np.eye(2) * 0.25
        call = lambda bs, p: pukf.update_geographic_position_bank(bs, p, lat, lon, r, lever)
        cases = []
        for i in range(NB):
            q = np.asarray(b.mu.orientation[i])
            zi = np.array([x[i], y[i]]) - orc.q_rot(q, lever)[:2]
            cases.append((lambda s: s["position"][:2], zi, r, ukf.D2P95))
        return call, cases
    if name == "delayed_position":
        delayed = np.asarray(b.mu.position[:, :2]) - rng.normal(scale=0.5, size=(NB, 2))
        z, r = rng.normal(scale=0.5, size=(NB, 2)), np.eye(2) * 0.04
        call = lambda bs, p: pukf.update_delayed_position_bank(bs, p, z, r, delayed)
        shifted = z + np.asarray(b.mu.position[:, :2]) - delayed
        return call, [(lambda s: s["position"][:2], shifted[i], r, None) for i in range(NB)]
    raise ValueError(name)


POSE_UPDATES = [
    "velocity",
    "acceleration",
    "z_position",
    "xy_position",
    "xy_position_gated",
    "xy_position_gate_rejects",
    "pressure",
    "pressure_banked_params",
    "water_velocity",
    "water_velocity_per_instance_cells",
    "body_efforts",
    "body_efforts_per_instance_rates",
    "geographic_position",
    "delayed_position",
]


@pytest.mark.parametrize("name", POSE_UPDATES)
def test_pose_update_bank_f32_matches_oracle(name):
    b, params = _pose_bank(seed=POSE_UPDATES.index(name))
    call, cases = _pose_update_case(name, b, params, np.random.default_rng(1))
    out, info = jax.jit(call)(_f32(b), _f32(params))
    assert out.cov.dtype == jnp.float32
    for i, (h, z, r, gate) in enumerate(cases):
        mu_o, cov_o, m2, acc = orc.oracle_update(
            POSE_ORACLE, _oracle_mu(b, i), np.asarray(b.cov[i]), z, h, r, gate
        )
        assert bool(info.accepted[i]) == acc
        np.testing.assert_allclose(float(info.mahalanobis2[i]), m2, rtol=2e-3, atol=1e-4)
        _assert_pose_matches(out, mu_o, cov_o, i, b.cov[i])
    if name == "xy_position_gate_rejects":
        assert not np.asarray(info.accepted).any()


def _oracle_pose_predict(b, params, i, dt, wv_tau=None, q_scale=1.0):
    """f64 oracle of ``predictionStepImpl`` (src/PoseUKF.cpp:12-84,446-474)."""
    mu = _oracle_mu(b, i)
    rr = np.asarray(b.rotation_rate[i])
    lat0, m_rad = CFG.location.latitude, float(params.projection.m_rad)
    wv_tau = float(params.water_velocity_tau) if wv_tau is None else wv_tau
    taus = {
        "bias_gyro": (float(params.gyro_bias_tau), np.asarray(params.gyro_bias_offset)),
        "bias_acc": (float(params.acc_bias_tau), np.asarray(params.acc_bias_offset)),
        "inertia": (float(params.inertia_tau), np.asarray(params.inertia_offset)),
        "lin_damping": (float(params.lin_damping_tau), np.asarray(params.lin_damping_offset)),
        "quad_damping": (float(params.quad_damping_tau), np.asarray(params.quad_damping_offset)),
        "water_velocity": (wv_tau, 0.0),
        "water_velocity_below": (wv_tau, 0.0),
        "bias_adcp": (float(params.adcp_bias_tau), 0.0),
        "water_density": (float(params.water_density_tau), float(params.water_density_offset)),
    }

    def f(s):
        out = {k: np.copy(v) for k, v in s.items()}
        out["position"] = s["position"] + dt * s["velocity"]
        lat = lat0 + s["position"][0] / m_rad
        w_e = geo.EARTHW * np.array([np.cos(lat), 0.0, np.sin(lat)])
        ang = orc.q_rot(s["orientation"], rr - s["bias_gyro"]) - w_e
        out["orientation"] = orc.so3_boxplus(s["orientation"], ang, dt)
        out["velocity"] = s["velocity"] + dt * s["acceleration"]
        for k, (tau, off) in taus.items():
            out[k] = s[k] + dt * (-1.0 / tau) * (s[k] - off)
        return out

    q0 = np.asarray(params.process_noise) * q_scale
    q = q0.copy()
    blk = pukf.POSE_MANIFOLD.block
    rot = orc.q_to_mat(mu["orientation"])
    o = blk("orientation")
    q[o, o] = rot @ q0[o, o] @ rot.T
    sv = mu["velocity"] * np.array([1.0, 1.0, 10.0])
    extra = float(params.water_velocity_scale) * float(sv @ sv) * dt * np.eye(2)
    for name in ("water_velocity", "water_velocity_below"):
        q[blk(name), blk(name)] = q0[blk(name), blk(name)] + extra
    return orc.oracle_predict(POSE_ORACLE, mu, np.asarray(b.cov[i]), f, q * dt**2)


@pytest.mark.parametrize("banked", [False, True], ids=["shared_params", "banked_params"])
def test_pose_predict_bank_f32_matches_oracle(banked):
    b, params = _pose_bank(seed=20 + banked)
    dt = 0.01
    taus = np.array([10.0, 100.0, 1000.0])
    scales = np.array([0.5, 1.0, 2.0])
    p = params
    if banked:
        p = bankmod.replicate(params, NB)._replace(
            water_velocity_tau=jnp.asarray(taus),
            process_noise=p.process_noise[None] * jnp.asarray(scales)[:, None, None],
        )
    out = jax.jit(lambda bs, pp: pukf.predict_bank(bs, pp, dt))(_f32(b), _f32(p))
    for i in range(NB):
        kw = dict(wv_tau=taus[i], q_scale=scales[i]) if banked else {}
        mu_o, cov_o = _oracle_pose_predict(b, params, i, dt, **kw)
        _assert_pose_matches(out, mu_o, cov_o, i, b.cov[i])


# --- VelocityUKF: the oracle filter of tests/oracle.py ----------------------


def _velocity_bank(seed):
    rng = np.random.default_rng(seed)
    model = dyn.default_uwv_parameters()
    mus = [
        {"velocity": rng.normal(scale=0.3, size=3), "z_position": rng.normal(size=1)}
        for _ in range(NB)
    ]
    covs = []
    for _ in range(NB):
        w = rng.normal(size=(4, 4))
        covs.append(0.05 * np.eye(4) + 0.01 * w @ w.T)
    tau = np.array([60.0, 5.0, -3.0, 0.0, 0.5, 1.0])
    gyro = np.array([0.0, 0.01, 0.05])
    states = []
    for m, c in zip(mus, covs):
        s, params = vukf.init(
            vukf.VelocityState(velocity=jnp.asarray(m["velocity"]), z_position=jnp.asarray(m["z_position"])),
            jnp.asarray(c), model,
        )
        s = vukf.integrate_body_efforts(s, jnp.asarray(tau))
        s = vukf.integrate_gyro(s, jnp.asarray(gyro))
        states.append(s)
    bstate = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    m = model
    oracles = []
    for mu, c in zip(mus, covs):
        o = orc.OracleVelocityUKF(
            mu, c, np.asarray(m.inertia_matrix), np.asarray(m.damping_linear),
            np.asarray(m.damping_quadratic), float(m.weight), float(m.buoyancy),
            np.asarray(m.cog), np.asarray(m.cob),
        )
        o.Q = np.asarray(params.process_noise)
        o.set_efforts(tau)
        o.set_gyro(gyro)
        oracles.append(o)
    return bstate, params, oracles


@pytest.mark.parametrize("op", ["predict", "update_dvl", "update_pressure"])
def test_velocity_bank_f32_matches_oracle(op):
    bstate, params, oracles = _velocity_bank(seed=["predict", "update_dvl", "update_pressure"].index(op))
    rng = np.random.default_rng(5)
    if op == "predict":
        out = jax.jit(lambda bs, p: vukf.predict_bank(bs, p, 0.05))(_f32(bstate), _f32(params))
        for o in oracles:
            o.predict(0.05)
    elif op == "update_dvl":
        z, r = rng.normal(scale=0.3, size=(NB, 3)), np.eye(3) * 1e-3
        out, _ = jax.jit(lambda bs: vukf.update_dvl_bank(bs, z, r))(_f32(bstate))
        for o, zi in zip(oracles, z):
            o.update_dvl(zi, r)
    else:
        z, r = rng.normal(size=(NB, 1)), np.eye(1) * 1e-2
        out, _ = jax.jit(lambda bs: vukf.update_pressure_bank(bs, z, r))(_f32(bstate))
        for o, zi in zip(oracles, z):
            o.update_pressure(zi, r)
    for i, o in enumerate(oracles):
        np.testing.assert_allclose(np.asarray(out.mu.velocity[i]), o.mu["velocity"], atol=1e-4)
        np.testing.assert_allclose(np.asarray(out.mu.z_position[i]), o.mu["z_position"], atol=1e-4)
        np.testing.assert_allclose(np.asarray(out.cov[i]), o.cov, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["velocity", "acceleration", "z_position", "water_velocity"])
def test_pose_update_bank_banked_params_f32_matches_oracle(name):
    """Models that read no parameters serve banked (Monte-Carlo sweep)
    parameter sets unchanged: same oracle result as with shared params."""
    b, params = _pose_bank(seed=40 + len(name))
    call, cases = _pose_update_case(name, b, params, np.random.default_rng(2))
    bparams = bankmod.replicate(params, NB)
    out, info = jax.jit(call)(_f32(b), _f32(bparams))
    for i, (h, z, r, gate) in enumerate(cases):
        mu_o, cov_o, m2, acc = orc.oracle_update(
            POSE_ORACLE, _oracle_mu(b, i), np.asarray(b.cov[i]), z, h, r, gate
        )
        assert bool(info.accepted[i]) == acc
        _assert_pose_matches(out, mu_o, cov_o, i, b.cov[i])


def test_velocity_predict_bank_banked_params_f32_matches_oracle():
    """A sweep over the vehicle model (per-instance inertia) through
    VelocityUKF.predict_bank, each instance against its own oracle filter."""
    bstate, params, oracles = _velocity_bank(seed=9)
    scales = np.array([0.8, 1.0, 1.25])
    m = params.model
    bmodel = m._replace(inertia_matrix=jnp.asarray(m.inertia_matrix)[None] * scales[:, None, None])
    bparams = params._replace(model=bmodel)
    out = jax.jit(lambda bs, p: vukf.predict_bank(bs, p, 0.05))(_f32(bstate), _f32(bparams))
    for i, o in enumerate(oracles):
        M = np.asarray(m.inertia_matrix) * scales[i]
        o.dyn = (M,) + o.dyn[1:]
        o.predict(0.05)
        np.testing.assert_allclose(np.asarray(out.mu.velocity[i]), o.mu["velocity"], atol=1e-4)
        np.testing.assert_allclose(np.asarray(out.cov[i]), o.cov, rtol=1e-3, atol=1e-6)


# --- BottomUKF / IndirectPoseUKF: f32 bank against the f64 solo path --------
# (no NumPy oracle of their S²/augmented manifolds exists; the f64 solo
# functions are the reference semantics, checked by their own test files)


def _bottom_bank(seed):
    from slam_uwv_kalman_filters_tpu.models import bottom_ukf as bukf

    rng = np.random.default_rng(seed)
    states = []
    for _ in range(NB):
        n = mf.s2_normalize(jnp.asarray([0.1, -0.1, 1.0]) + jnp.asarray(rng.normal(scale=0.1, size=3)))
        s, params = bukf.init(
            bukf.BottomState(distance=jnp.asarray([10.0 + rng.normal()]), normal=n),
            jnp.diag(jnp.asarray([1.0, 0.05, 0.05])),
        )
        states.append(bukf.set_velocity(s, jnp.asarray(rng.normal(scale=0.5, size=3))))
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states), params


def _indirect_bank(seed):
    from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as ipu

    rng = np.random.default_rng(seed)
    state, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, initial_position_error_std=(0.3,) * 3)
    b = bankmod.replicate(state, NB)
    b = b._replace(mu=b.mu._replace(
        position_error=jnp.asarray(rng.normal(scale=0.2, size=(NB, 3))),
        orientation_error=jax.vmap(mf.quat_exp)(jnp.asarray(rng.normal(scale=0.05, size=(NB, 3)))),
    ))
    return b, params


def _small_case(name):
    """(f64 bank, bank call, per-instance solo call) of one small-filter op."""
    from slam_uwv_kalman_filters_tpu.models import bottom_ukf as bukf
    from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as ipu
    from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration

    rng = np.random.default_rng(len(name))
    if name.startswith("bottom"):
        b, params = _bottom_bank(seed=3)
        beam, origin = np.array([0.1, 0.0, -1.0]), np.array([0.0, 0.2, 0.0])
        if name == "bottom_predict":
            return b, lambda bs: bukf.predict_bank(bs, _f32(params), 0.1), lambda s: bukf.predict(s, params, 0.1)
        if name == "bottom_predict_banked_params":
            bp = params._replace(process_noise=params.process_noise[None] * jnp.asarray([0.5, 1.0, 2.0])[:, None, None])
            return b, lambda bs: bukf.predict_bank(bs, _f32(bp), 0.1), ("banked", bp)
        if name == "bottom_range":
            z, r = 9.5 + rng.normal(size=NB), np.eye(1) * 1e-2
            return (
                b,
                lambda bs: bukf.update_range_bank(bs, z, r, beam, origin)[0],
                lambda s, i: bukf.update_range(s, z[i : i + 1], r, beam, origin)[0],
            )
        if name == "bottom_normal":
            z = np.stack([np.asarray(mf.s2_normalize(jnp.asarray([0.0, 0.1, 1.0]) + rng.normal(scale=0.05, size=3))) for _ in range(NB)])
            r = np.eye(2) * 1e-2
            return (
                b,
                lambda bs: bukf.update_normal_bank(bs, z, r)[0],
                lambda s, i: bukf.update_normal(s, z[i], r)[0],
            )
    b, params = _indirect_bank(seed=4)
    if name == "indirect_predict":
        return b, lambda bs: ipu.predict_bank(bs, _f32(params), 0.5), lambda s: ipu.predict(s, params, 0.5)
    if name == "indirect_predict_banked_params":
        bp = params._replace(orientation_error_tau=jnp.asarray([10.0, 30.0, 90.0]))
        return b, lambda bs: ipu.predict_bank(bs, _f32(bp), 0.5), ("banked", bp)
    cam = CameraConfiguration()
    feats = np.array([[330.0, 236.0], [300.0, 250.0]]) + rng.normal(scale=2.0, size=(NB, 2, 2))
    marker = (
        np.eye(2)[None] * 4.0 * np.ones((2, 1, 1)), np.array([[0.1, 0.1, 0.0], [-0.1, 0.1, 0.0]]),
        np.array([0.0, 0.0, 3.0]), np.array([1.0, 0, 0, 0]), np.eye(6) * 1e-4, cam,
        np.zeros(3), np.array([1.0, 0, 0, 0]),
    )
    return (
        b,
        lambda bs: ipu.update_markers_bank(bs, feats, *marker)[0],
        lambda s, i: ipu.update_markers(s, jnp.asarray(feats[i]), *map(_asarray, marker))[0],
    )


def _asarray(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


SMALL_CASES = [
    "bottom_predict",
    "bottom_predict_banked_params",
    "bottom_range",
    "bottom_normal",
    "indirect_predict",
    "indirect_predict_banked_params",
    "indirect_markers",
]


@pytest.mark.parametrize("name", SMALL_CASES)
def test_small_filter_bank_f32_matches_f64_solo(name):
    from slam_uwv_kalman_filters_tpu.models import bottom_ukf as bukf
    from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as ipu

    b, bank_call, solo = _small_case(name)
    out = jax.jit(bank_call)(_f32(b))
    assert out.cov.dtype == jnp.float32
    for i in range(NB):
        s = jax.tree_util.tree_map(lambda a: a[i], b)
        if isinstance(solo, tuple):  # banked parameters: instance i's own set
            bp = solo[1]
            if name.startswith("bottom"):
                ref = bukf.predict(s, bp._replace(process_noise=bp.process_noise[i]), 0.1)
            else:
                ref = ipu.predict(s, bp._replace(orientation_error_tau=bp.orientation_error_tau[i]), 0.5)
        elif name.endswith("predict"):
            ref = solo(s)
        else:
            ref = solo(s, i)
        for got, want in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a[i], out.mu)),
                             jax.tree_util.tree_leaves(ref.mu)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)
        want = np.asarray(ref.cov)
        np.testing.assert_allclose(np.asarray(out.cov[i]), want, rtol=1e-3, atol=1e-5 * np.abs(want).max())
