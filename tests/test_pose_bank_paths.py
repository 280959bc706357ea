"""Bank==solo consistency for the event-rate PoseUKF measurement paths.

Round-3 additions: GPS (`update_geographic_position_bank`), the three
delayed-position variants and the visual-marker update gain bank entries so a
Monte-Carlo fleet can run a full ICRA'18 mission (reference anchors:
``/root/reference/src/PoseUKF.cpp:567-579`` GPS, ``:514-557`` delayed,
``:613-654`` markers). Each test runs a heterogeneous bank through the bank
path and asserts instance i matches the solo update of instance i.
"""

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn, manifolds as mf
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils import delayed_states
from slam_uwv_kalman_filters_tpu.utils.config import (
    CameraConfiguration,
    default_pose_ukf_config,
)

RNG = np.random.default_rng(31)
NB = 3


def _make_bank(n=NB, dtype=jnp.float64):
    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters(dtype=dtype)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=model,
        imu_delta_t=0.01,
        dtype=dtype,
    )
    bstate = bankmod.replicate(state, n)
    mu = bstate.mu._replace(
        position=bstate.mu.position + jnp.asarray(RNG.normal(scale=1.0, size=(n, 3)), dtype),
        velocity=bstate.mu.velocity + jnp.asarray(RNG.normal(scale=0.3, size=(n, 3)), dtype),
        orientation=jax.vmap(lambda q, v: mf.so3_boxplus(q, v))(
            bstate.mu.orientation, jnp.asarray(RNG.normal(scale=0.2, size=(n, 3)), dtype)
        ),
    )
    return bstate._replace(mu=mu), params


def _instance(bstate, i):
    return jax.tree_util.tree_map(lambda a: a[i], bstate)


def _assert_state_matches(bank_out, solo_out, i, atol=1e-11):
    np.testing.assert_allclose(
        np.asarray(bank_out.cov[i]), np.asarray(solo_out.cov), atol=atol
    )
    for name in pukf.PoseState._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(bank_out.mu, name)[i]),
            np.asarray(getattr(solo_out.mu, name)),
            atol=atol,
            err_msg=name,
        )


def test_geographic_position_bank_matches_solo():
    bstate, params = _make_bank()
    lat0 = float(params.projection.lat0)
    lon0 = float(params.projection.lon0)
    lat = jnp.asarray(lat0 + RNG.normal(scale=2e-6, size=NB))
    lon = jnp.asarray(lon0 + RNG.normal(scale=2e-6, size=NB))
    r = jnp.eye(2, dtype=jnp.float64) * 0.25
    gps_in_body = jnp.asarray([0.4, 0.0, -1.2])

    out, info = pukf.update_geographic_position_bank(
        bstate, params, lat, lon, r, gps_in_body
    )
    for i in range(NB):
        solo, solo_info = pukf.update_geographic_position(
            _instance(bstate, i), params, lat[i], lon[i], r, gps_in_body
        )
        _assert_state_matches(out, solo, i)
        np.testing.assert_allclose(
            float(info.mahalanobis2[i]), float(solo_info.mahalanobis2), rtol=1e-9
        )
        assert bool(info.accepted[i]) == bool(solo_info.accepted)


def test_geographic_position_bank_gate_masks_per_instance():
    """One instance's wild fix is rejected by the χ²-95 gate while its
    neighbors accept — the masked-update contract of the bank layer."""
    bstate, params = _make_bank()
    from slam_uwv_kalman_filters_tpu.ops import geodesy as geo

    # fixes at each instance's own position (innovation ≈ 0) ...
    lat, lon = geo.nav_to_world(
        params.projection, bstate.mu.position[:, 0], bstate.mu.position[:, 1]
    )
    lat = lat.at[1].add(0.01)  # ... except instance 1: ~1100 km off
    r = jnp.eye(2, dtype=jnp.float64) * 0.25

    out, info = pukf.update_geographic_position_bank(bstate, params, lat, lon, r)
    acc = np.asarray(info.accepted)
    assert acc[0] and acc[2] and not acc[1]
    np.testing.assert_array_equal(np.asarray(out.cov[1]), np.asarray(bstate.cov[1]))


def test_delayed_position_bank_matches_solo():
    bstate, params = _make_bank()
    z = jnp.asarray(RNG.normal(scale=0.5, size=(NB, 2)))
    delayed = jnp.asarray(RNG.normal(scale=0.3, size=(NB, 2)))
    r = jnp.eye(2, dtype=jnp.float64) * 0.1

    out, _ = pukf.update_delayed_position_bank(bstate, params, z, r, delayed)
    for i in range(NB):
        solo, _ = pukf.update_delayed_position(
            _instance(bstate, i), params, z[i], r, delayed[i]
        )
        _assert_state_matches(out, solo, i)


def test_delayed_position_with_augmentation_bank_matches_solo():
    bstate, params = _make_bank()
    z = jnp.asarray(RNG.normal(scale=0.5, size=(NB, 2)))
    delayed = jnp.asarray(RNG.normal(scale=0.3, size=(NB, 2)))
    r = jnp.eye(2, dtype=jnp.float64) * 0.1
    dcov = jnp.eye(2, dtype=jnp.float64) * 0.05

    out, _ = pukf.update_delayed_position_with_augmentation_bank(
        bstate, params, z, r, delayed, dcov
    )
    for i in range(NB):
        solo, _ = pukf.update_delayed_position_with_augmentation(
            _instance(bstate, i), params, z[i], r, delayed[i], dcov
        )
        _assert_state_matches(out, solo, i)


def test_delayed_position_buffered_bank_matches_solo():
    bstate, params = _make_bank()
    buf1 = delayed_states.make_buffer(16, 2, 5.0, dtype=jnp.float64)
    bbuf = bankmod.replicate(buf1, NB)

    # record three ticks of per-instance positions into the bank buffers
    ts = delayed_states.from_seconds(0.0)
    walk = bstate
    for k in range(3):
        ts = ts + delayed_states.from_seconds(0.5)
        walk = walk._replace(
            mu=walk.mu._replace(position=walk.mu.position + 0.1 * (k + 1))
        )
        bbuf = pukf.push_delayed_state_bank(bbuf, walk, ts)

    z = jnp.asarray(RNG.normal(scale=0.2, size=(NB, 2)))
    r = jnp.eye(2, dtype=jnp.float64) * 0.1
    out, info, found = pukf.update_delayed_position_buffered_bank(
        walk, params, bbuf, ts, z, r, 0.6
    )
    assert bool(jnp.all(found))
    for i in range(NB):
        solo, solo_info, solo_found = pukf.update_delayed_position_buffered(
            _instance(walk, i), params, _instance(bbuf, i), ts, z[i], r, 0.6
        )
        assert bool(found[i]) == bool(solo_found)
        _assert_state_matches(out, solo, i)
        np.testing.assert_allclose(
            float(info.mahalanobis2[i]), float(solo_info.mahalanobis2), rtol=1e-9
        )

    # beyond-horizon delay: every instance reports found=False, state untouched
    out2, info2, found2 = pukf.update_delayed_position_buffered_bank(
        walk, params, bbuf, ts, z, r, 100.0
    )
    assert not bool(jnp.any(found2))
    assert not bool(jnp.any(info2.accepted))
    np.testing.assert_array_equal(np.asarray(out2.cov), np.asarray(walk.cov))


def test_visual_features_bank_matches_solo():
    bstate, params = _make_bank()
    cam = CameraConfiguration()
    k = 4
    feats = jnp.asarray(
        RNG.normal(loc=(cam.cx, cam.cy), scale=40.0, size=(NB, k, 2))
    )
    fcovs = jnp.tile(jnp.eye(2) * 4.0, (NB, k, 1, 1))
    fpos = jnp.asarray(
        [[0.1, 0.1, 0.0], [-0.1, 0.1, 0.0], [-0.1, -0.1, 0.0], [0.1, -0.1, 0.0]]
    )
    marker_pos = jnp.asarray([2.0, 0.0, 1.0])
    marker_rot = jnp.asarray([1.0, 0, 0, 0])
    cov_marker = jnp.eye(6) * 1e-4
    cam_p = jnp.zeros(3)
    cam_q = jnp.asarray([1.0, 0, 0, 0])

    out, info = pukf.update_visual_features_bank(
        bstate, params, feats, fcovs, fpos, marker_pos, marker_rot,
        cov_marker, cam, cam_p, cam_q,
    )
    assert info.mahalanobis2.shape == (NB, k)
    for i in range(NB):
        solo, solo_info = pukf.update_visual_features(
            _instance(bstate, i), params, feats[i], fcovs[i], fpos,
            marker_pos, marker_rot, cov_marker, cam, cam_p, cam_q,
        )
        _assert_state_matches(out, solo, i, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(info.mahalanobis2[i]),
            np.asarray(solo_info.mahalanobis2),
            rtol=1e-8,
        )


def test_visual_features_bank_shared_detections_broadcast():
    """Shared (K,…) detections broadcast across the bank — the replicated
    instances of a fresh bank then produce identical posteriors."""
    bstate, params = _make_bank()
    # make the bank homogeneous so broadcast detections give equal outputs
    bstate = bankmod.replicate(_instance(bstate, 0), NB)
    cam = CameraConfiguration()
    feats = jnp.asarray([[330.0, 236.0], [310.0, 260.0]])
    fcovs = jnp.tile(jnp.eye(2) * 4.0, (2, 1, 1))
    fpos = jnp.asarray([[0.1, 0.1, 0.0], [-0.1, 0.1, 0.0]])

    out, info = pukf.update_visual_features_bank(
        bstate, params, feats, fcovs, fpos,
        jnp.asarray([2.0, 0.0, 1.0]), jnp.asarray([1.0, 0, 0, 0]),
        jnp.eye(6) * 1e-4, cam, jnp.zeros(3), jnp.asarray([1.0, 0, 0, 0]),
    )
    np.testing.assert_array_equal(np.asarray(out.cov[0]), np.asarray(out.cov[1]))
    np.testing.assert_array_equal(
        np.asarray(info.mahalanobis2[0]), np.asarray(info.mahalanobis2[1])
    )


def test_body_efforts_bank_per_instance_rates_matches_solo():
    """(B,3) per-instance compensated body rates == vmapped solo efforts
    update (the exact ``PoseUKF.cpp:581-602`` semantics at bank scale), in
    f64 and, to f32 roundoff, at the deployment dtype."""
    bstate, params = _make_bank()
    # heterogeneous cached gyro rates so per-instance compensation differs
    bstate = bstate._replace(
        rotation_rate=jnp.asarray(RNG.normal(scale=0.05, size=(NB, 3)))
    )
    z = jnp.asarray(RNG.normal(scale=2.0, size=(NB, 6)))
    r = jnp.eye(6, dtype=jnp.float64) * 0.1
    rr_bank = pukf.get_rotation_rate_bank(bstate, params)
    for i in range(NB):
        np.testing.assert_allclose(
            np.asarray(rr_bank[i]),
            np.asarray(pukf.get_rotation_rate(_instance(bstate, i), params)),
            atol=1e-14,
        )

    out, _ = pukf.update_body_efforts_bank(bstate, params, z, r, rr_bank)
    for i in range(NB):
        solo, _ = pukf.update_body_efforts(_instance(bstate, i), params, z[i], r)
        _assert_state_matches(out, solo, i)

    # the f32 bank path with per-instance rates agrees with the f64 result
    f32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), bstate)
    out32, _ = pukf.update_body_efforts_bank(
        f32, params, z.astype(jnp.float32), r.astype(jnp.float32),
        rr_bank.astype(jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(out32.cov), np.asarray(out.cov), atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(out32.mu.velocity), np.asarray(out.mu.velocity), atol=2e-4
    )
