"""Monte-Carlo noise-tuning sweep — vmap over PARAMETER SETS, not just states.

Filter tuning is the classic consumption of batch throughput (BASELINE.md
configs: "Monte-Carlo parameter sweep"): every candidate noise configuration
runs the same trajectory, and the best candidate is the one whose normalized
innovation squared (NIS) is statistically consistent — E[NIS] ≈ m for an
m-dimensional measurement.

Because ``PoseUKFParams`` is a pytree of arrays, sweeping parameters is just
a second ``vmap`` axis: here CANDIDATES × the whole replay run in one jit.
The same pattern tunes real missions from logged data.

Run:  JAX_PLATFORMS=cpu python examples/noise_tuning_sweep.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(candidates=8, seconds=20.0, rate=25.0, seed=0):
    import jax
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    rng = np.random.default_rng(seed)
    dt = 1.0 / rate
    n = int(seconds * rate)

    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters(dtype=dtype)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.25,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=model,
        imu_delta_t=dt,
        dtype=dtype,
    )

    # candidate grid: scale the acceleration-random-walk block of Q (the
    # max_jerk knob) over two orders of magnitude around the truth
    scales = jnp.asarray(np.logspace(-1.0, 1.0, candidates), dtype)
    acc_block = pukf.POSE_MANIFOLD.block("acceleration")
    mask = jnp.zeros((53, 53), dtype).at[acc_block, acc_block].set(1.0)

    def with_scale(s):
        q = params.process_noise * (1.0 + (s - 1.0) * mask)
        return params._replace(process_noise=q)

    params_bank = jax.vmap(with_scale)(scales)  # PoseUKFParams with leading axis

    # synthetic truth: sinusoidal acceleration ⇒ the filter must track through
    # its acceleration random walk; the DVL innovations expose a mis-tuned Q
    t = np.arange(n) * dt
    acc_true = 0.3 * np.sin(2 * np.pi * t / 5.0)
    vel_true = np.cumsum(acc_true) * dt
    dvl = np.stack([vel_true, 0 * t, 0 * t], axis=1) + rng.normal(scale=2e-3, size=(n, 3))
    dvl = jnp.asarray(dvl, dtype)
    r_dvl = jnp.eye(3, dtype=dtype) * (2e-3) ** 2 * 4

    # bank of identical initial states, one per candidate: predict_bank takes
    # the banked parameter set directly, and the DVL model reads no
    # parameters, so its bank update serves the sweep too
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    s0 = pukf.integrate_rotation_rate(state, jnp.zeros(3, dtype))
    bstate = bankmod.replicate(s0, candidates)

    def tick(bs, z):
        bs = pukf.predict_bank(bs, params_bank, dt)
        zb = jnp.broadcast_to(z, (candidates, 3))
        bs, info = pukf.update_velocity_bank(bs, params_bank, zb, r_dvl)
        return bs, info.mahalanobis2

    sweep = jax.jit(lambda bs: jax.lax.scan(tick, bs, dvl)[1].mean(axis=0))
    t0 = time.perf_counter()
    mean_nis = np.asarray(sweep(bstate))
    wall = time.perf_counter() - t0

    # consistency target: E[NIS] = measurement dim = 3
    best = int(np.argmin(np.abs(mean_nis - 3.0)))
    print(f"{candidates} candidates x {n} ticks in {wall:.1f}s (one jit)")
    for i, (sc, nis_i) in enumerate(zip(np.asarray(scales), mean_nis)):
        tag = "  <-- best (closest to E[NIS]=3)" if i == best else ""
        print(f"  Q_acc x {sc:6.2f}: mean NIS = {nis_i:8.3f}{tag}")
    assert 0 < best < candidates - 1 or abs(mean_nis[best] - 3.0) < 2.0, (
        "sweep failed to bracket a consistent tuning"
    )
    print(f"TUNING OK: best acceleration-noise scale = {float(scales[best]):.2f}")
    return float(scales[best])


if __name__ == "__main__":
    main()
