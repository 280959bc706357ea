"""Tests for config round-trips, delayed-state buffer, metrics, and the
PoseUKF delayed-measurement paths."""

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.utils import delayed_states as ds
from slam_uwv_kalman_filters_tpu.utils import metrics
from slam_uwv_kalman_filters_tpu.utils.config import (
    CameraConfiguration,
    PoseUKFConfig,
    config_from_dict,
    config_to_dict,
    default_pose_ukf_config,
    load_config,
    save_config,
)

CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters()


def test_config_json_roundtrip(tmp_path):
    p = tmp_path / "cfg.json"
    save_config(CFG, p)
    cfg2 = load_config(p)
    assert cfg2 == CFG
    assert cfg2.rotation_rate.bias_instability == CFG.rotation_rate.bias_instability
    assert cfg2.visual_landmarks.camera_config.fx == CFG.visual_landmarks.camera_config.fx


def test_config_dict_roundtrip():
    d = config_to_dict(CFG)
    assert isinstance(d["max_jerk"], list)
    cfg2 = config_from_dict(d)
    assert cfg2 == CFG


def test_delayed_buffer_push_and_lookup():
    buf = ds.make_buffer(capacity=8, dim=2, maximum_delay=2.0)
    for k in range(12):  # wraps around
        ts = ds.from_seconds(0.1 * k)
        buf = ds.push(buf, ts, jnp.array([float(k), -float(k)]), jnp.eye(2) * (k + 1.0))
    # closest to t=0.95s is entry k=9 or 10 (ties break low) — within horizon
    v, c, found = ds.closest(buf, ds.from_seconds(0.97))
    assert bool(found)
    np.testing.assert_allclose(np.asarray(v), [10.0, -10.0])
    # entries 0..3 were overwritten by the wrap: nearest to t=0 is k=4
    v2, _, found2 = ds.closest(buf, ds.from_seconds(0.0))
    assert bool(found2)  # 0.4s away ≤ 2s horizon
    np.testing.assert_allclose(np.asarray(v2), [4.0, -4.0])
    # far beyond the horizon: not found
    _, _, found3 = ds.closest(buf, ds.from_seconds(100.0))
    assert not bool(found3)
    # empty buffer: not found
    empty = ds.make_buffer(4, 2, 1.0)
    _, _, found4 = ds.closest(empty, ds.from_seconds(0.0))
    assert not bool(found4)


def test_delayed_buffer_jit_scan():
    buf = ds.make_buffer(capacity=16, dim=2, maximum_delay=5.0)

    def body(b, k):
        b = ds.push(b, ds.from_seconds(k * 0.1), jnp.stack([k * 1.0, 0.0]), jnp.eye(2))
        return b, None

    buf, _ = jax.lax.scan(body, buf, jnp.arange(10, dtype=jnp.float64))
    v, _, found = jax.jit(ds.closest)(buf, ds.from_seconds(0.5))
    assert bool(found)
    np.testing.assert_allclose(np.asarray(v), [5.0, 0.0])


def pose_filter(**kw):
    args = dict(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.01,
        imu_in_nwu_rot=mf.quat_identity(),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=CFG,
        model_parameters=MODEL,
    )
    args.update(kw)
    return pukf.init_from_pose(**args)


def test_pose_delayed_buffered_update():
    state, params = pose_filter()
    buf = ds.make_buffer(capacity=64, dim=2, maximum_delay=5.0)
    ts = jnp.asarray(0, jnp.int64)
    # drive forward, recording xy into the buffer each step
    state = state._replace(mu=state.mu._replace(velocity=jnp.array([1.0, 0.0, 0.0])))
    for k in range(20):
        state = pukf.predict(state, params, 0.1)
        ts = ts + ds.from_seconds(0.1)
        buf = pukf.push_delayed_state(buf, state, ts)
    # a fix measured 1 s ago: true position then was ~(1.0, 0)
    z = jnp.array([1.05, 0.02])
    state2, info, found = pukf.update_delayed_position_buffered(
        state, params, buf, ts, z, jnp.eye(2) * 0.01, 1.0
    )
    assert bool(found) and bool(info.accepted)
    # shift anchors the fix at ~ current + (z − delayed) ≈ 2.0 + 0.05
    np.testing.assert_allclose(float(state2.mu.position[0]), 2.05, atol=0.05)
    # beyond the buffer horizon: untouched
    state3, info3, found3 = pukf.update_delayed_position_buffered(
        state, params, buf, ts, z, jnp.eye(2) * 0.01, 100.0
    )
    assert not bool(found3)
    np.testing.assert_allclose(
        np.asarray(state3.mu.position), np.asarray(state.mu.position), atol=0
    )


def test_pose_delayed_augmented_update():
    state, params = pose_filter(imu_in_nwu_pos_cov=jnp.eye(3) * 1.0)
    state = state._replace(mu=state.mu._replace(position=jnp.array([2.0, 0.0, 0.0])))
    z = jnp.array([1.2, 0.1])  # delayed fix
    delayed_pos = jnp.array([1.0, 0.0])  # where we believed we were then
    state2, info = pukf.update_delayed_position_with_augmentation(
        state, params, z, jnp.eye(2) * 0.01, delayed_pos, jnp.eye(2) * 0.04
    )
    assert state2.cov.shape == (53, 53)
    # correction direction: fix says we were 0.2 further along x
    assert float(state2.mu.position[0]) > 2.0
    # with large delayed-position uncertainty the correction shrinks
    state3, _ = pukf.update_delayed_position_with_augmentation(
        state, params, z, jnp.eye(2) * 0.01, delayed_pos, jnp.eye(2) * 100.0
    )
    assert abs(float(state3.mu.position[0]) - 2.0) < abs(float(state2.mu.position[0]) - 2.0)


def test_metrics():
    S = jnp.eye(2) * 4.0
    nu = jnp.array([2.0, 0.0])
    np.testing.assert_allclose(float(metrics.nis(nu, S)), 1.0)
    P = jnp.diag(jnp.array([1.0, 4.0]))
    np.testing.assert_allclose(float(metrics.nees(jnp.array([1.0, 2.0]), P)), 2.0)
    np.testing.assert_allclose(float(metrics.covariance_condition(P)), 4.0)
    est = jnp.zeros((10, 3))
    tru = jnp.ones((10, 3))
    np.testing.assert_allclose(float(metrics.ate_rmse(est, tru)), np.sqrt(3.0))
    q1 = mf.quat_exp(jnp.array([0.0, 0.0, 0.3]))
    q2 = mf.quat_identity()
    np.testing.assert_allclose(float(metrics.heading_error(q1, q2)), 0.3, atol=1e-12)


def test_delayed_buffer_without_x64():
    """On 32-bit-only runtimes (the f32 accelerator path) the buffer must degrade to
    int32 millisecond ticks instead of crashing on an int64 sentinel
    (regression: closest() raised OverflowError with x64 disabled)."""
    with jax.enable_x64(False):
        assert ds.ticks_per_second() == 1_000
        buf = ds.make_buffer(8, 2, maximum_delay=1.0, dtype=jnp.float32)
        assert buf.timestamps.dtype == jnp.int32
        for k in range(5):
            buf = ds.push(buf, ds.from_seconds(0.1 * k), jnp.full(2, float(k)),
                          jnp.eye(2, dtype=jnp.float32))
        v, c, found = ds.closest(buf, ds.from_seconds(0.21))
        assert bool(found)
        np.testing.assert_allclose(np.asarray(v), [2.0, 2.0])
        _, _, found_far = ds.closest(buf, ds.from_seconds(5.0))
        assert not bool(found_far)
    assert ds.ticks_per_second() == 1_000_000  # restored with x64


def test_from_seconds_ms_exact_without_x64():
    """x32 path: concrete host values must convert in f64, not through f32
    (regression: s*1000 through float32 drifted ±121 ms near the ~24-day
    int32-ms wraparound horizon, breaking closest() matching)."""
    with jax.enable_x64(False):
        for days in (0.5, 5.0, 20.0):
            s = days * 86400.0 + 0.123
            t = int(ds.from_seconds(s))
            assert t == round(s * 1000), f"{days} days: {t} != {round(s*1000)}"
        # traced path: whole/frac split keeps the product exact to the
        # input's own f32 resolution (exact for sub-2^24-s whole seconds)
        t2 = int(jax.jit(ds.from_seconds)(jnp.float32(16000.25)))
        assert t2 == 16000250


def test_measurement_valid_batched_rank_aware():
    """(B,d,d) covariance banks: only the DIAGONAL must be non-negative, and
    the mask is per-instance (regression: negative off-diagonal correlations
    invalidated the whole bank)."""
    from slam_uwv_kalman_filters_tpu.utils import validation

    cov = jnp.tile(jnp.array([[1.0, -0.5], [-0.5, 1.0]])[None], (3, 1, 1))
    mu = jnp.zeros((3, 2))
    mask = validation.measurement_valid(mu, cov)
    assert mask.shape == (3,)
    assert bool(mask.all()), "negative off-diagonals are legitimate"
    # one bad instance (NaN mean) → only that instance masked
    mu_bad = mu.at[1, 0].set(jnp.nan)
    mask2 = validation.measurement_valid(mu_bad, cov)
    np.testing.assert_array_equal(np.asarray(mask2), [True, False, True])
    # negative variance → invalid; scalar API unchanged
    cov_bad = cov.at[2, 0, 0].set(-1.0)
    np.testing.assert_array_equal(
        np.asarray(validation.measurement_valid(mu, cov_bad)), [True, True, False]
    )
    assert bool(validation.measurement_valid(jnp.zeros(2), jnp.eye(2)))
    assert not bool(validation.measurement_valid(jnp.zeros(2), -jnp.eye(2)))


def test_covariance_condition_degenerate_f32():
    """A collapsed covariance reports inf, never NaN (regression: the 1e-300
    guard underflowed to 0.0 in float32 → 0/0 on the f32 deployment path)."""
    c = metrics.covariance_condition(jnp.zeros((3, 3), jnp.float32))
    assert np.isinf(float(c)) and not np.isnan(float(c))
    c2 = metrics.covariance_condition(jnp.diag(jnp.array([1.0, 4.0], jnp.float32)))
    np.testing.assert_allclose(float(c2), 4.0)


def test_trace_host_tracer_level(tmp_path):
    """host_tracer_level must actually reach the profiler (regression: the
    kwarg was accepted and silently dropped)."""
    from slam_uwv_kalman_filters_tpu.utils import tracing

    with tracing.trace(str(tmp_path), host_tracer_level=1):
        jax.block_until_ready(jnp.ones(8) * 2.0)
    assert any(tmp_path.rglob("*")), "no trace output written"


def test_measurement_valid_ambiguous_and_banked_shapes():
    """Shape-dispatch regressions: a (B,d) variance bank with B==d must be
    read per-instance (not as one (d,d) matrix), and a (B,) scalar bank needs
    banked=True to avoid collapsing to a single bool."""
    from slam_uwv_kalman_filters_tpu.utils import validation

    # B == d == 3: per-instance variance vectors, one negative entry
    mu = jnp.zeros((3, 3))
    var = jnp.ones((3, 3)).at[0, 1].set(-4.0)
    mask = validation.measurement_valid(mu, var)
    np.testing.assert_array_equal(np.asarray(mask), [False, True, True])
    # shared (d,d) matrix for a (B,d) bank with B != d still broadcasts
    mask2 = validation.measurement_valid(jnp.zeros((4, 3)), jnp.eye(3))
    assert np.asarray(mask2).shape in ((), (4,)) and bool(np.all(mask2))
    # (B,) scalar-measurement bank: explicit banked=True gives per-instance
    z = jnp.array([0.0, jnp.nan, 1.0])
    r = jnp.array([1.0, 1.0, -1.0])
    mask3 = validation.measurement_valid(z, r, banked=True)
    np.testing.assert_array_equal(np.asarray(mask3), [True, False, False])


def test_check_measurement_variance_vector_negative_raises():
    from slam_uwv_kalman_filters_tpu.utils import validation

    try:
        validation.check_measurement(np.zeros(2), np.array([1.0, -1.0]))
        assert False, "expected ValueError for negative variance vector"
    except ValueError:
        pass


def test_covariance_condition_uses_magnitudes():
    """An indefinite covariance (negative eigenvalue from f32 cancellation)
    must report a HUGE condition number, not read as well-conditioned."""
    c = jnp.diag(jnp.array([-1000.0, 1.0]))
    assert float(metrics.covariance_condition(c)) == 1000.0
    # interior zero eigenvalue → inf even when not the signed-smallest
    c0 = jnp.diag(jnp.array([-5.0, 0.0, 3.0]))
    assert np.isinf(float(metrics.covariance_condition(c0)))


def test_delayed_states_rejects_mismatched_tick_dtype():
    """A buffer built under one x64 setting queried with the other setting's
    integer ticks must raise, not silently wrap/mix units."""
    buf = ds.make_buffer(4, 2, 1.0)
    wrong = jnp.zeros((), jnp.int32 if buf.timestamps.dtype == jnp.int64 else jnp.int64)
    try:
        ds.closest(buf, wrong)
        assert False, "expected TypeError for mismatched tick dtype"
    except TypeError:
        pass


def test_throughput_rate_before_start_raises():
    from slam_uwv_kalman_filters_tpu.utils.tracing import Throughput

    t = Throughput()
    t.add(5)
    try:
        t.rate()
        assert False, "expected RuntimeError before start()"
    except RuntimeError:
        pass
