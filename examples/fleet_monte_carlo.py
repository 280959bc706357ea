"""Fleet-scale Monte-Carlo filter bank — the capability the reference lacks.

The reference runs ONE filter per process (SURVEY.md §2.4). Here a bank of N
independent PoseUKF instances — a vehicle fleet, a tuning sweep, a parameter
ensemble — is a single pytree with a leading bank axis:

* every instance starts from a perturbed initial state (Monte-Carlo over
  initialization error),
* the whole bank steps in lock-step under one ``jit(vmap(step))``,
* the bank is sharded over all available devices with a 1-D ``bank`` mesh
  (``parallel.sharding``) — per-instance steps are communication-free and
  XLA inserts collectives only at the ensemble-statistics reduction,
* ensemble NEES/consistency statistics stream back each second.

Run:
    python examples/fleet_monte_carlo.py --bank 8192          # one GPU
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/fleet_monte_carlo.py --bank 256 --seconds 2 --cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bank", type=int, default=8192)
    p.add_argument("--seconds", type=float, default=10.0, help="simulated mission time")
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod, sharding as shmod
    from slam_uwv_kalman_filters_tpu.utils import metrics
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    dtype = jnp.float32
    devices = jax.devices()
    mesh = shmod.make_mesh(devices)
    print(f"backend={jax.default_backend()} devices={len(devices)} bank={args.bank}")

    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters(dtype=dtype)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.25,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg, model_parameters=model, imu_delta_t=1.0 / args.rate, dtype=dtype,
    )
    state = pukf.integrate_rotation_rate(state, jnp.zeros(3, dtype))

    # Monte-Carlo initialization: every instance starts with an error drawn
    # from the stated initial covariance — NEES over the bank then validates
    # filter consistency (it should hover around the state dimension).
    rng = np.random.default_rng(args.seed)
    bstate = bankmod.replicate(state, args.bank)
    pos_err = jnp.asarray(rng.normal(scale=0.5, size=(args.bank, 3)), dtype)
    bstate = bstate._replace(mu=bstate.mu._replace(position=bstate.mu.position + pos_err))
    bstate = shmod.shard_bank(bstate, mesh)

    true_v = jnp.asarray([0.5, 0.0, 0.0], dtype)
    dt = 1.0 / args.rate
    n_ticks = int(args.rate)  # ticks actually run per simulated second
    dvl_every = max(1, round(args.rate / 5))  # ~5 Hz; every tick at low rates

    def second_of_steps(bs, z_dvl, truth_pos):
        """One simulated second: rate× (predict + masked DVL @~5 Hz)."""
        def tick(carry, k):
            bs = carry
            bs = pukf.predict_bank(bs, params, dt)
            bs2, _ = pukf.update_velocity_bank(bs, params, z_dvl, jnp.eye(3, dtype=dtype) * 1e-4)
            do_dvl = (k % dvl_every) == 0
            bs = jax.tree_util.tree_map(lambda a, b: jnp.where(do_dvl, a, b), bs2, bs)
            return bs, None
        bs, _ = jax.lax.scan(tick, bs, jnp.arange(n_ticks))
        # ensemble statistics — the one cross-device reduction: mean/spread
        # plus position NEES against the known truth (should hover near 3)
        mean_pos = bs.mu.position.mean(axis=0)
        spread = bs.mu.position.std(axis=0).max()
        mean_nees = jax.vmap(metrics.nees)(
            bs.mu.position - truth_pos[None], bs.cov[:, :3, :3]
        ).mean()
        return bs, (mean_pos, spread, mean_nees)

    step = jax.jit(second_of_steps)
    z = jnp.tile(true_v[None], (args.bank, 1))
    t_sim = 1.0  # simulated seconds elapsed (truth moves at true_v from t=0)

    t0 = time.perf_counter()
    bstate, stats = step(bstate, z, true_v * t_sim)
    jax.block_until_ready(bstate)
    print(f"compile + first second: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    n_sec = int(args.seconds)
    for s in range(n_sec):
        t_sim += 1.0
        bstate, (mean_pos, spread, mean_nees) = step(bstate, z, true_v * t_sim)
        if s % max(1, n_sec // 5) == 0:
            print(f"t={s + 1:3d}s  ensemble mean pos={np.asarray(mean_pos).round(3)}  "
                  f"spread={float(spread):.3f} m  position NEES={float(mean_nees):.2f}")
    jax.block_until_ready(bstate)
    wall = time.perf_counter() - t0
    steps = args.bank * n_ticks * n_sec
    print(f"throughput: {steps / wall / 1e3:.0f}k filter-steps/s over {len(devices)} device(s)")

    # consistency: velocity converged for every instance in the bank
    v = np.asarray(bstate.mu.velocity)
    worst = np.abs(v - np.asarray(true_v)).max()
    print(f"worst-instance velocity error: {worst:.4f} m/s")
    assert worst < 0.05, "bank diverged"

    # ---- elastic recovery (parallel.failover): poison a few instances and
    # let the self-healing step restart them from the last healthy snapshot —
    # the pod-job answer to the reference's manual resetFilterWithExternalPose
    from slam_uwv_kalman_filters_tpu.parallel import failover

    snapshot = bstate  # stands in for the last checkpoint.restore(...)
    vel = np.asarray(bstate.mu.velocity).copy()
    dead_idx = rng.choice(args.bank, size=max(1, args.bank // 100), replace=False)
    vel[dead_idx, 0] = np.nan  # simulated corruption (e.g. a bad sensor burst)
    poisoned = bstate._replace(mu=bstate.mu._replace(velocity=jnp.asarray(vel)))

    heal = jax.jit(
        failover.self_healing_step(
            lambda bs, z: pukf.update_velocity_bank(
                pukf.predict_bank(bs, params, dt), params, z, jnp.eye(3, dtype=dtype) * 1e-4
            )
        )
    )
    healed, info, _ = heal(poisoned, snapshot, z)
    n_reseeded = int(info.n_reseeded)
    print(f"failover: {n_reseeded}/{args.bank} poisoned instances restarted from snapshot")
    assert n_reseeded == len(dead_idx)
    assert bool(jnp.all(failover.health_mask(healed))), "heal left dead instances"
    print("FLEET OK")


if __name__ == "__main__":
    main()
