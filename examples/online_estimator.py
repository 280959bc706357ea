"""Online estimation loop — native event ingest + per-tick bank dispatch.

The deployment shape the reference's ROCK component implements by hand
(SURVEY.md §3.6: a host callback per sensor sample):

1. sensors deliver an **irregular, slightly out-of-order event stream**
   (timestamped gyro / DVL / pressure packets);
2. the native C++ STREAMING packer (``runtime.StreamPacker``, NumPy fallback
   when no compiler) stages each arriving chunk incrementally and releases
   dense tick windows with validity masks in order — the host-side work that
   would otherwise serialize Python in the ingest path;
3. the filter bank advances tick by tick with **separately-dispatched**
   jitted bank calls (``pukf.predict_bank`` / ``update_*_bank``), each
   sensor update dispatched only on the ticks it arrived.

Run:  python examples/online_estimator.py           # default device, f32
      python examples/online_estimator.py --cpu --bank 32 --rate 10
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

GYRO, DVL, PRESS = 0, 1, 2


def make_event_chunk(rng, t0_us, chunk_s, rate, true_v, depth, g, rho, p_atm):
    """One second of irregular sensor traffic, shuffled out of order."""
    dt_us = int(1e6 / rate)
    ts, ids, payloads = [], [], []
    for k in range(int(chunk_s * rate)):
        t = t0_us + k * dt_us + rng.integers(-dt_us // 4, dt_us // 4)
        ts.append(t)
        ids.append(GYRO)
        payloads.append(np.concatenate([rng.normal(scale=1e-4, size=3), np.zeros(3)]))
        if k % 10 == 0:
            ts.append(t + 1000)
            ids.append(DVL)
            payloads.append(np.concatenate([true_v + rng.normal(scale=2e-3, size=3), np.zeros(3)]))
        if k % 5 == 0:
            p = p_atm - depth * g * rho + rng.normal(scale=50.0)
            ts.append(t + 2000)
            ids.append(PRESS)
            payloads.append(np.asarray([p, 0, 0, 0, 0, 0]))
    order = rng.permutation(len(ts))  # network reordering
    return (
        np.asarray(ts, np.int64)[order],
        np.asarray(ids, np.int32)[order],
        np.stack(payloads)[order],
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bank", type=int, default=1024)
    p.add_argument("--seconds", type=int, default=10)
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument(
        "--aot", action="store_true",
        help="pre-export the tick functions (utils.aot / jax.export) and "
        "dispatch the deserialized artifacts — the ship-to-vehicle path "
        "with no tracing in the mission loop",
    )
    args = p.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu import runtime
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    dtype = jnp.float32
    rng = np.random.default_rng(args.seed)
    dt = 1.0 / args.rate
    n_ticks = int(args.rate)  # one-second chunks
    cfg = default_pose_ukf_config()
    g, rho, p_atm = 9.8209, float(cfg.hydrostatics.water_density), float(
        cfg.hydrostatics.atmospheric_pressure
    )
    true_v = np.array([0.4, -0.1, 0.0])
    depth = -12.0

    model = dyn.default_uwv_parameters(dtype=dtype)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray([0, 0, depth], dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.25,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg, model_parameters=model, imu_delta_t=dt, dtype=dtype,
    )
    state = pukf.integrate_rotation_rate(state, jnp.zeros(3, dtype))
    bs = bankmod.replicate(state, args.bank)
    print(f"backend={jax.default_backend()} bank={args.bank} "
          f"native_packer={runtime.native_available()}")

    r_dvl = jnp.eye(3, dtype=dtype) * 1e-4
    r_press = jnp.eye(1, dtype=dtype) * 2500.0

    # separately-dispatched jits (the online shape)
    @jax.jit
    def tick_predict(bs, rr):
        return pukf.predict_bank(bs._replace(rotation_rate=rr), params, dt)

    @jax.jit
    def tick_dvl(bs, z):
        return pukf.update_velocity_bank(bs, params, z, r_dvl)[0]

    @jax.jit
    def tick_press(bs, z):
        return pukf.update_pressure_bank(bs, params, z, r_press)[0]

    if args.aot:
        # the ship-to-vehicle deployment path: every tick function crosses a
        # serialized-artifact boundary before the mission loop sees it — the
        # loop below then runs deserialized steps with zero tracing
        from slam_uwv_kalman_filters_tpu.utils import aot

        rt = lambda fn, *ex: aot.deserialize(aot.serialize(aot.export_step(fn, *ex)))
        tick_predict = rt(tick_predict, bs, jnp.zeros((args.bank, 3), dtype))
        tick_dvl = rt(tick_dvl, bs, jnp.zeros((args.bank, 3), dtype))
        tick_press = rt(tick_press, bs, jnp.zeros((args.bank, 1), dtype))

    sensor_dims = np.asarray([3, 3, 1], np.int32)
    last_gyro = np.zeros(3)  # gyro is an input sensor: ticks without an event
    total_events = dropped_total = 0  # integrate the last received rate
    wall = 0.0
    steady_wall, steady_chunks = 0.0, 0
    # streaming ingest: one packer for the whole mission, one released
    # window per wall second (forced: each chunk's events are all pushed
    # before its window closes, so the flush is exact)
    packer = runtime.StreamPacker(
        sensor_dims, t0_us=0, dt_us=int(1e6 / args.rate),
        window_ticks=n_ticks, payload_stride=6,
    )
    for sec in range(args.seconds):
        t0_us = int(sec * 1e6)
        ts, ids, payloads = make_event_chunk(
            rng, t0_us, 1.0, args.rate, true_v, depth, g, rho, p_atm
        )
        total_events += len(ts)
        t_start = time.perf_counter()
        packer.push(ts, ids, payloads)
        widx, values, valid = packer.pop(force=True)
        assert widx == sec
        dropped_total = packer.dropped
        gyro_vals, _ = runtime.forward_fill(values[GYRO], valid[GYRO], last_gyro)
        last_gyro = gyro_vals[-1, :3].copy()
        # per-tick dispatch against the persistent bank state
        for k in range(n_ticks):
            rr = jnp.asarray(np.tile(gyro_vals[k, :3], (args.bank, 1)), dtype)
            bs = tick_predict(bs, rr)
            if valid[DVL, k]:
                bs = tick_dvl(bs, jnp.asarray(np.tile(values[DVL, k, :3], (args.bank, 1)), dtype))
            if valid[PRESS, k]:
                bs = tick_press(bs, jnp.asarray(np.tile(values[PRESS, k, :1], (args.bank, 1)), dtype))
        jax.block_until_ready(bs.cov)
        chunk_wall = time.perf_counter() - t_start
        wall += chunk_wall
        if sec > 0:  # exclude the compile chunk from the steady-state figure
            steady_wall += chunk_wall
            steady_chunks += 1
        if sec in (0, args.seconds - 1):
            v = np.asarray(bs.mu.velocity[0])
            print(f"t={sec + 1:3d}s  chunk wall={chunk_wall * 1e3:6.0f} ms  "
                  f"v=({v[0]:+.3f},{v[1]:+.3f},{v[2]:+.3f})")

    v = np.asarray(bs.mu.velocity[0])
    err = np.abs(v - true_v).max()
    rt = steady_chunks / steady_wall if steady_chunks else args.seconds / wall
    print(f"{total_events} events, {dropped_total} dropped; steady state "
          f"{rt:.1f}x real time at {args.rate:.0f} Hz x bank {args.bank} "
          f"(first chunk incl. compile: {wall - steady_wall:.1f}s)")
    print(f"final velocity error: {err:.4f} m/s")
    assert err < 0.02, "online estimator diverged"
    print("ONLINE OK")
    return rt


if __name__ == "__main__":
    main()
