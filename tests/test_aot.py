"""AOT export round-trip: a serialized filter step must reproduce the live
jitted step exactly, after crossing a bytes boundary (the ship-to-vehicle
artifact path, ``utils/aot.py``)."""

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.models import pose_driver as drv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.utils import aot
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config


def _filter(dtype):
    return pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.01,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=0.01,
        dtype=dtype,
    )


def test_exported_step_round_trip():
    dtype = jnp.float64
    state, params = _filter(dtype)
    state = pukf.integrate_rotation_rate(state, jnp.array([0.0, 0.0, 0.01], dtype))
    z = jnp.array([0.3, 0.0, 0.0], dtype)
    r = jnp.eye(3, dtype=dtype) * 1e-3

    def step(s, zz):
        s = pukf.predict(s, params, 0.01)
        s, info = pukf.update_velocity(s, params, zz, r)
        return s, info.mahalanobis2

    exported = aot.export_step(step, state, z)
    blob = aot.serialize(exported)
    assert isinstance(blob, (bytes, bytearray)) and len(blob) > 1000
    call = aot.deserialize(blob)

    ref_state, ref_nis = jax.jit(step)(state, z)
    out_state, out_nis = call(state, z)
    np.testing.assert_array_equal(np.asarray(out_state.cov), np.asarray(ref_state.cov))
    np.testing.assert_array_equal(
        np.asarray(out_state.mu.position), np.asarray(ref_state.mu.position)
    )
    np.testing.assert_array_equal(np.asarray(out_nis), np.asarray(ref_nis))

    # chained: the deserialized step drives a short mission on its own
    s = state
    for _ in range(5):
        s, _ = call(s, z)
    assert bool(jnp.isfinite(s.cov).all())


def test_exported_file_round_trip(tmp_path):
    dtype = jnp.float64
    state, params = _filter(dtype)

    def predict(s):
        return pukf.predict(s, params, 0.01)

    exported = aot.export_step(predict, state)
    path = str(tmp_path / "step.jaxexport")
    aot.save(path, exported)
    call = aot.load(path)
    ref = jax.jit(predict)(state)
    out = call(state)
    np.testing.assert_array_equal(np.asarray(out.cov), np.asarray(ref.cov))


def test_exported_bank_step_round_trip():
    """A bank-level predict + gated update (the online host's step, with
    UpdateInfo results) survives the bytes boundary with equal outputs."""
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    dtype = jnp.float32
    state, params = _filter(dtype)
    bs = bankmod.replicate(state, 4)
    z = jnp.zeros((4, 2), dtype)

    def step(bs, z):
        bs = pukf.predict_bank(bs, params, 0.01)
        return pukf.update_xy_position_bank(bs, params, z, jnp.eye(2, dtype=dtype) * 0.1, 5.991)

    call = aot.deserialize(aot.serialize(aot.export_step(step, bs, z)))
    ref = jax.jit(step)(bs, z)
    out = call(bs, z)
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
