"""Parallel-layer tests (SURVEY.md §4 items 3-4): bank replication/masking,
mesh sharding on the 8-device virtual CPU mesh, checkpoint round-trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.models import velocity_ukf as vukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.parallel import bank, checkpoint, sharding
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters()


def pose_filter():
    return pukf.init_from_pose(
        jnp.zeros(3), jnp.eye(3) * 0.01, mf.quat_identity(), jnp.eye(3) * 1e-4, CFG, MODEL
    )


def test_replicate_and_bank_size():
    state, params = pose_filter()
    b = bank.replicate(state, 16)
    assert bank.bank_size(b) == 16
    assert b.cov.shape == (16, 53, 53)
    assert b.mu.orientation.shape == (16, 4)


def test_masked_update_per_instance_validity():
    state, params = pose_filter()
    n = 4
    bstate = bank.replicate(state, n)
    zs = jnp.tile(jnp.array([1.0, 0.0, 0.0])[None], (n, 1))
    Rs = jnp.tile((jnp.eye(3) * 1e-4)[None], (n, 1, 1))
    valid = jnp.array([True, False, True, False])

    upd = bank.vmap_filter(pukf.update_velocity)
    bstate2, info = bank.masked(upd)(bstate, valid, params, zs, Rs)

    moved = np.linalg.norm(np.asarray(bstate2.mu.velocity), axis=1)
    assert moved[0] > 0.5 and moved[2] > 0.5
    np.testing.assert_allclose(moved[1], 0.0, atol=0)
    np.testing.assert_allclose(np.asarray(bstate2.cov[1]), np.asarray(bstate.cov[1]), atol=0)


def test_param_sweep_vmap():
    """Per-instance parameter sweep: different water_velocity_tau per filter
    (the Monte-Carlo tuning axis) — vmap over BOTH state and params."""
    state, params = pose_filter()
    n = 3
    taus = jnp.array([10.0, 100.0, 1000.0])
    pbank = bank.replicate(params, n)
    pbank = pbank._replace(water_velocity_tau=taus)
    sbank = bank.replicate(state, n)
    wv = jnp.tile(jnp.array([0.2, 0.0])[None], (n, 1))
    sbank = sbank._replace(mu=sbank.mu._replace(water_velocity=wv))

    step = bank.vmap_filter(pukf.predict, params_axis=0, data_axes=None)
    out = step(sbank, pbank, 0.1)
    decays = np.asarray(out.mu.water_velocity[:, 0])
    # faster tau ⇒ faster decay toward 0
    assert decays[0] < decays[1] < decays[2] < 0.2


def test_sharded_bank_on_virtual_mesh():
    """8 virtual CPU devices (conftest): shard a VelocityUKF bank, run a
    jitted predict+update step with in-jit sharding constraints, reduce."""
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    mesh = sharding.make_mesh()
    n = 32  # 4 per device

    mu = vukf.VelocityState(velocity=jnp.zeros(3), z_position=jnp.zeros(1))
    state, params = vukf.init(mu, jnp.eye(4) * 0.1, MODEL)
    bstate = sharding.shard_bank(bank.replicate(state, n), mesh)
    taus = jnp.asarray(np.random.default_rng(1).normal(size=(n, 6)) * 20.0)
    taus = jax.device_put(taus, sharding.bank_sharding(mesh))

    @jax.jit
    def step(bs, taus):
        bs = jax.vmap(vukf.integrate_body_efforts)(bs, taus)
        bs = jax.vmap(lambda s: vukf.predict(s, params, 0.1))(bs)
        bs = sharding.with_bank_constraint(bs, mesh)
        stats = sharding.ensemble_mean(bs.mu.velocity)  # cross-device reduction
        return bs, stats

    bs2, stats = step(bstate, taus)
    assert bs2.cov.shape == (n, 4, 4)
    # sharding preserved on outputs
    assert len(bs2.cov.sharding.device_set) == 8
    # reduction matches unsharded computation
    solo = jax.vmap(lambda s, t: vukf.predict(vukf.integrate_body_efforts(s, t), params, 0.1))(
        bank.replicate(state, n), taus
    )
    np.testing.assert_allclose(
        np.asarray(stats), np.asarray(solo.mu.velocity.mean(axis=0)), atol=1e-12
    )


def test_ensemble_moments_and_acceptance():
    x = jnp.asarray(np.random.default_rng(2).normal(size=(100, 3)))
    mean, cov = sharding.ensemble_moments(x)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(x).mean(0), atol=1e-12)
    np.testing.assert_allclose(np.asarray(cov), np.cov(np.asarray(x).T, bias=True), atol=1e-10)
    acc = sharding.acceptance_rate(jnp.array([True, True, False, True]))
    np.testing.assert_allclose(float(acc), 0.75)


def test_checkpoint_roundtrip():
    import tempfile

    state, params = pose_filter()
    bstate = bank.replicate(state, 4)
    # perturb so the restore is meaningful
    bstate = bstate._replace(cov=bstate.cov + 1e-3)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(f"{d}/bank.npz", bstate)
        template = bank.replicate(state, 4)
        restored = checkpoint.restore(f"{d}/bank.npz", template)
    np.testing.assert_allclose(np.asarray(restored.cov), np.asarray(bstate.cov), atol=0)
    np.testing.assert_allclose(
        np.asarray(restored.mu.orientation), np.asarray(bstate.mu.orientation), atol=0
    )
    # resume == the reference's second ctor: construct-from-state
    resumed = pukf.init_from_state(
        jax.tree_util.tree_map(lambda a: a[0], restored.mu),
        restored.cov[0],
        params,
    )
    np.testing.assert_allclose(np.asarray(resumed.cov), np.asarray(bstate.cov[0]), atol=0)


def test_checkpoint_npz_rejects_mismatched_template(tmp_path):
    """The .npz checkpoint stores flattened leaves only; a template with a
    different leaf count fails loudly, and dtypes round-trip unchanged."""
    import pytest

    state, _ = pose_filter()
    f32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), bank.replicate(state, 2))
    checkpoint.save(tmp_path / "bank.npz", f32)
    restored = checkpoint.restore(tmp_path / "bank.npz", f32)
    assert restored.cov.dtype == np.float32
    np.testing.assert_array_equal(restored.cov, np.asarray(f32.cov))
    assert not (tmp_path / "bank.npz.tmp").exists()  # published atomically
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(tmp_path / "bank.npz", {"only": np.zeros(3)})


def test_init_multihost_single_process():
    """Single-process path: idempotent, returns process index 0."""
    from slam_uwv_kalman_filters_tpu.parallel import sharding as shmod

    assert shmod.init_multihost() == 0
    assert shmod.init_multihost() == 0  # idempotent


def test_bank_shard_map_runs_step_per_device():
    """A bank-level PoseUKF step wrapped in bank_shard_map matches the
    unsharded result on the 8-device CPU mesh."""
    import jax.numpy as jnp
    import numpy as np

    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod, sharding as shmod
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters()
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=cfg,
        model_parameters=model,
    )
    n = 16
    bstate = bankmod.replicate(state, n)
    mesh = shmod.make_mesh()
    sharded = shmod.shard_bank(bstate, mesh)

    def step(bs):
        return pukf.predict_bank(bs, params, 0.05)

    out_sharded = jax.jit(shmod.bank_shard_map(step, mesh))(sharded)
    out_ref = step(bstate)
    np.testing.assert_allclose(np.asarray(out_sharded.cov), np.asarray(out_ref.cov), atol=1e-12)
    assert len(out_sharded.cov.sharding.device_set) == len(jax.devices())


@pytest.mark.parametrize("wrap", ["jit", "mission_shard_map"])
def test_shard_time_bank_mission_runs_per_device(wrap):
    """The mission over a bank placed by shard_bank and inputs placed by
    shard_time_bank: per-instance streams are sharded on the bank axis and
    shared ones replicated, the tick outputs stay sharded, and the result
    equals the unsharded run, under a plain jit and in mission_shard_map
    (whose compiled scan must gather nothing: a plain jit does on the GPU).
    Ticks 80..99 fire every sensor once and skip most."""
    import bench
    from jax.sharding import NamedSharding, PartitionSpec as P

    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv

    mesh = sharding.make_mesh()
    n, t = 16, 20
    state, params, meas = bench.pose_setup(jnp.float64)
    inputs = bench.steady_state_inputs(meas, n, t, jnp.float64, jax.random.PRNGKey(3), t0=80)
    placed = sharding.shard_time_bank(inputs, mesh, n)
    time_bank = NamedSharding(mesh, P(None, "bank"))
    assert placed.acc.sharding.is_equivalent_to(time_bank, 3)
    assert placed.acc_cov.sharding.is_fully_replicated
    assert placed.dvl_valid.sharding.is_fully_replicated

    def mission(bs, inp):
        return drv.run_trajectory_bank(bs, params, inp)

    run = jax.jit(mission if wrap == "jit" else sharding.mission_shard_map(mission, mesh, n))
    bs = sharding.shard_bank(bank.replicate(state, n), mesh)
    if wrap == "mission_shard_map":
        assert "all-gather" not in run.lower(bs, placed).compile().as_text()
    final, outs = run(bs, placed)
    for leaf in jax.tree_util.tree_leaves(outs):
        assert leaf.sharding.is_equivalent_to(time_bank, leaf.ndim)
    ref, ref_outs = jax.jit(mission)(bank.replicate(state, n), inputs)
    np.testing.assert_allclose(np.asarray(final.cov), np.asarray(ref.cov), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(outs.position), np.asarray(ref_outs.position), atol=1e-9)
    np.testing.assert_allclose(np.asarray(outs.dvl_nis), np.asarray(ref_outs.dvl_nis), rtol=1e-6)
    assert np.asarray(outs.dvl_nis)[-1].all() and not np.asarray(outs.dvl_nis)[:-1].any()


def test_save_sharded_scalar_and_replicated_leaves(tmp_path):
    """save_sharded must handle rank-0 leaves (ring-buffer heads, counters)
    and keep replicated leaves single-copy (regression: 0-d leaves crashed
    the concatenate; a replicated leaf on k local devices was saved k×)."""
    mesh = sharding.make_mesh()
    tree = {
        "bank": jax.device_put(jnp.arange(32.0).reshape(16, 2), sharding.bank_sharding(mesh)),
        "params": jax.device_put(jnp.eye(3), sharding.replicated(mesh)),  # 8 shards, same data
        "head": jax.device_put(jnp.asarray(7, jnp.int32), sharding.replicated(mesh)),
    }
    checkpoint.save_sharded(tmp_path / "t.npz", tree)
    host_template = {
        "bank": np.zeros((16, 2)),
        "params": np.zeros((3, 3)),
        "head": np.zeros((), np.int32),
    }
    restored = checkpoint.restore_sharded(tmp_path / "t.npz", host_template)
    np.testing.assert_array_equal(restored["bank"], np.arange(32.0).reshape(16, 2))
    np.testing.assert_array_equal(restored["params"], np.eye(3))  # NOT (24, 3)
    assert restored["head"] == 7


def test_restore_sharded_place_and_shape_validation(tmp_path):
    """place=True re-assembles leaves onto the template's sharding; a
    template with the wrong bank size fails loudly (regression: mismatched
    shards were adopted silently)."""
    import pytest

    mesh = sharding.make_mesh()
    bank_arr = jax.device_put(
        jnp.arange(64.0).reshape(32, 2), sharding.bank_sharding(mesh)
    )
    checkpoint.save_sharded(tmp_path / "b.npz", {"bank": bank_arr})

    placed = checkpoint.restore_sharded(
        tmp_path / "b.npz", {"bank": jnp.zeros_like(bank_arr)}, place=True
    )
    assert placed["bank"].sharding == bank_arr.sharding
    np.testing.assert_array_equal(np.asarray(placed["bank"]), np.asarray(bank_arr))

    wrong = {"bank": np.zeros((16, 2))}
    with pytest.raises(ValueError, match="local shape"):
        checkpoint.restore_sharded(tmp_path / "b.npz", wrong)


def test_init_multihost_failure_handling(monkeypatch):
    """A failed bootstrap raises when a process group was requested (incl.
    process_id alone); with no arguments no group is formed and the run
    proceeds single-process (regression: silent each-host-its-own-bank)."""
    import pytest

    from slam_uwv_kalman_filters_tpu.parallel import sharding as shmod

    calls = []

    def boom(*a, **k):
        calls.append(a)
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False, raising=False)

    with pytest.raises(RuntimeError):
        shmod.init_multihost(process_id=0)  # explicit → loud
    with pytest.raises(RuntimeError):
        shmod.init_multihost("localhost:1234", 2, 0)
    assert len(calls) == 2
    assert shmod.init_multihost() == 0  # single process → no group
    assert len(calls) == 2


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_checkpoint_roundtrip_preserves_leaf_dtypes(tmp_path, dtype):
    """Ring-buffer heads (int), gate flags (bool) and f32 banks come back
    with their own dtype and value, None leaves included."""
    tree = {"x": np.arange(6).reshape(2, 3).astype(dtype), "none": None, "s": np.asarray(3, dtype)}
    checkpoint.save(tmp_path / "t.npz", tree)
    out = checkpoint.restore(tmp_path / "t.npz", tree)
    assert out["none"] is None
    for k in ("x", "s"):
        assert out[k].dtype == dtype
        np.testing.assert_array_equal(out[k], tree[k])
