"""Failure-detection / elastic-recovery tests (SURVEY.md §5: the automated
layer on top of the reference's manual gates + resetFilterWithExternalPose)."""

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu.parallel import bank, checkpoint, failover
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

CFG = default_pose_ukf_config()
MODEL = dyn.default_uwv_parameters()


def pose_filter():
    return pukf.init_from_pose(
        jnp.zeros(3), jnp.eye(3) * 0.01, mf.quat_identity(), jnp.eye(3) * 1e-4, CFG, MODEL
    )


def corrupt(bstate, *, nan_at=(), neg_var_at=(), blowup_at=()):
    cov = np.asarray(bstate.cov).copy()
    vel = np.asarray(bstate.mu.velocity).copy()
    for i in nan_at:
        vel[i, 0] = np.nan
    for i in neg_var_at:
        cov[i, 5, 5] = -1e-6
    for i in blowup_at:
        cov[i] *= 1e9
    return bstate._replace(mu=bstate.mu._replace(velocity=jnp.asarray(vel)), cov=jnp.asarray(cov))


def test_health_mask_detects_nan_negvar_blowup():
    state, params = pose_filter()
    b = corrupt(bank.replicate(state, 6), nan_at=(1,), neg_var_at=(3,), blowup_at=(4,))
    mask = np.asarray(failover.health_mask(b))
    np.testing.assert_array_equal(mask, [True, False, True, False, True, True])
    # the blow-up only trips the optional trace cap
    mask_cap = np.asarray(failover.health_mask(b, max_cov_trace=1e6))
    np.testing.assert_array_equal(mask_cap, [True, False, True, False, False, True])


def test_guarded_step_rolls_back_only_dead_instances():
    state, params = pose_filter()
    n = 4
    bstate = bank.replicate(state, n)

    def step(bs, z):
        bs = pukf.predict_bank(bs, params, 0.01)
        # instance 2 receives a NaN measurement → NaN state after the update
        r = jnp.tile((jnp.eye(3) * 1e-3)[None], (n, 1, 1))
        bs, info = jax.vmap(lambda s, zi, ri: pukf.update_velocity(s, params, zi, ri))(bs, z, r)
        return bs, info

    z = jnp.tile(jnp.array([0.3, 0.0, 0.0])[None], (n, 1))
    z = z.at[2, 0].set(jnp.nan)

    # both paths unjitted: op-by-op dispatch makes the comparison bit-exact
    # (a jitted-vs-unjitted comparison differs in fusion rounding)
    out_raw, _ = step(bstate, z)
    assert not bool(jnp.all(jnp.isfinite(out_raw.mu.velocity[2])))

    out, healthy, info = failover.guarded(step)(bstate, z)
    np.testing.assert_array_equal(np.asarray(healthy), [True, True, False, True])
    # dead instance froze at its pre-step state
    np.testing.assert_array_equal(np.asarray(out.cov[2]), np.asarray(bstate.cov[2]))
    np.testing.assert_array_equal(
        np.asarray(out.mu.velocity[2]), np.asarray(bstate.mu.velocity[2])
    )
    # healthy instances are bit-identical to the unguarded step
    for i in (0, 1, 3):
        np.testing.assert_array_equal(np.asarray(out.cov[i]), np.asarray(out_raw.cov[i]))


def test_reseed_where_single_donor_and_bank_donor():
    state, params = pose_filter()
    b = corrupt(bank.replicate(state, 4), nan_at=(1, 3))
    dead = ~failover.health_mask(b)

    # single-instance donor (construct-from-state resume semantics)
    healed = failover.reseed_where(b, dead, state)
    assert bool(jnp.all(failover.health_mask(healed)))
    np.testing.assert_array_equal(np.asarray(healed.mu.velocity[1]), np.asarray(state.mu.velocity))
    # untouched instances keep their (possibly evolved) values
    np.testing.assert_array_equal(np.asarray(healed.cov[0]), np.asarray(b.cov[0]))

    # bank-snapshot donor (checkpoint-based restart)
    snap = bank.replicate(state, 4)
    snap = snap._replace(mu=snap.mu._replace(position=snap.mu.position + 7.0))
    healed2 = failover.reseed_where(b, dead, snap)
    np.testing.assert_array_equal(np.asarray(healed2.mu.position[3]), np.asarray(snap.mu.position[3]))
    np.testing.assert_array_equal(np.asarray(healed2.mu.position[0]), np.asarray(b.mu.position[0]))


def test_self_healing_step_with_checkpoint_snapshot(tmp_path):
    """End-to-end checkpoint-based restart: save a healthy snapshot, poison a
    later step, and watch the dead instance restart from the snapshot."""
    state, params = pose_filter()
    n = 3
    bstate = bank.replicate(state, n)

    checkpoint.save(tmp_path / "bank.npz", bstate)
    snapshot = checkpoint.restore(tmp_path / "bank.npz", bstate)

    def step(bs, z):
        bs = pukf.predict_bank(bs, params, 0.01)
        r = jnp.tile((jnp.eye(3) * 1e-3)[None], (n, 1, 1))
        bs, info = jax.vmap(lambda s, zi, ri: pukf.update_velocity(s, params, zi, ri))(bs, z, r)
        return bs, info

    healing = jax.jit(failover.self_healing_step(step))
    z = jnp.tile(jnp.array([0.3, 0.0, 0.0])[None], (n, 1))

    bstate2, info, _ = healing(bstate, snapshot, z)
    assert int(info.n_reseeded) == 0

    bstate3, info, _ = healing(bstate2, snapshot, z.at[1].set(jnp.nan))
    assert int(info.n_reseeded) == 1
    np.testing.assert_array_equal(np.asarray(info.healthy), [True, False, True])
    assert bool(jnp.all(failover.health_mask(bstate3)))
    # restarted instance is exactly the snapshot
    np.testing.assert_array_equal(np.asarray(bstate3.cov[1]), np.asarray(snapshot.cov[1]))
    # survivors kept stepping
    assert float(jnp.linalg.norm(bstate3.mu.velocity[0])) > 0.0


def test_guarded_accepts_bare_state_step():
    """A step returning a bare filter state (a NamedTuple — which IS a tuple)
    must not be mistaken for a (state, aux) pair."""
    state, params = pose_filter()
    bstate = bank.replicate(state, 2)
    out, healthy = failover.guarded(lambda bs: pukf.predict_bank(bs, params, 0.01))(bstate)
    np.testing.assert_array_equal(np.asarray(healthy), [True, True])
    assert out.cov.shape == (2, 53, 53)
    # same contract in bank.masked
    upd = lambda bs: pukf.predict_bank(bs, params, 0.01)
    masked_out = bank.masked(upd)(bstate, jnp.array([True, False]))
    np.testing.assert_array_equal(np.asarray(masked_out.cov[1]), np.asarray(bstate.cov[1]))
    assert float(jnp.max(jnp.abs(masked_out.cov[0] - bstate.cov[0]))) > 0.0


def test_guarded_scrubs_aux_rows_of_dead_instances():
    """aux for a rolled-back instance must not leak the diverged step's NaN
    telemetry into driver-side reductions (numbers→0, booleans→False)."""
    from typing import NamedTuple

    class TinyState(NamedTuple):
        mu: jnp.ndarray  # (B, 2)
        cov: jnp.ndarray  # (B, 2, 2)

    bs0 = TinyState(mu=jnp.zeros((3, 2)), cov=jnp.tile(jnp.eye(2)[None], (3, 1, 1)))

    def step(bs):
        # instance 1 diverges: NaN state, NaN metric, accepted=True
        v = bs._replace(mu=bs.mu.at[1].set(jnp.nan))
        metric = jnp.array([1.0, jnp.nan, 3.0])
        accepted = jnp.array([True, True, True])
        return v, (metric, accepted)

    out, healthy, (metric, accepted) = failover.guarded(step)(bs0)
    np.testing.assert_array_equal(np.asarray(healthy), [True, False, True])
    np.testing.assert_allclose(np.asarray(metric), [1.0, 0.0, 3.0])
    np.testing.assert_array_equal(np.asarray(accepted), [True, False, True])
    assert np.isfinite(np.asarray(out.mu)).all()
    # a scalar (non-banked) aux leaf passes through untouched
    def step2(bs):
        return bs._replace(mu=bs.mu.at[0].set(jnp.nan)), jnp.asarray(7.0)

    _, _, aux2 = failover.guarded(step2)(bs0)
    assert float(aux2) == 7.0


def test_masked_update_scrubs_info_of_invalid_instances():
    """bank.masked must mask the info record too — a discarded update's
    accepted flag / NaN NIS must not surface (phantom acceptances)."""
    from slam_uwv_kalman_filters_tpu.ops.ukf import UpdateInfo

    def update(state, z):
        info = UpdateInfo(
            mahalanobis2=jnp.array([0.5, jnp.nan]),
            accepted=jnp.array([True, True]),
            innovation=jnp.full((2, 3), jnp.nan),
        )
        return state + z, info

    state = jnp.zeros((2, 4))
    valid = jnp.array([True, False])
    out, info = bank.masked(update)(state, valid, jnp.ones((2, 4)))
    np.testing.assert_allclose(np.asarray(out[1]), 0.0)  # state rolled back
    np.testing.assert_allclose(np.asarray(out[0]), 1.0)
    assert not bool(info.accepted[1]) and bool(info.accepted[0])
    assert float(info.mahalanobis2[1]) == 0.0
    assert np.isfinite(np.asarray(info.innovation[1])).all()
