"""Benchmark harness — PoseUKF mission-tick throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "ate_m": ..., ...}

Default metric (BASELINE.md configs[3] + north star): **full-mission
PoseUKF ticks/sec/device at the 131,072-instance bank**. One "tick" is the
ICRA'18 steady-state second divided by 100: every tick runs the 53-DOF
unscented prediction (107 sigma points through the full process model incl.
earth-rate attitude propagation) and the IMU acceleration update, and the
multi-rate aiding sensors fire on their reference schedule — DVL 5 Hz,
pressure 2 Hz, ADCP 1 Hz, body-effort (model aiding) 10 Hz
(Arnold & Medagoda, ICRA 2018, arXiv:1805.08011). The schedule is one
``lax.scan`` of ``pose_driver.run_trajectory_bank`` over per-tick inputs;
an update runs only on the ticks it fires (``pose_driver._masked_update``).

``ate_m`` closes the accuracy loop in the same artifact: a 1-minute ICRA'18
mission replay at f32 on the device, reported as ATE RMSE in metres against
simulated ground truth (north-star bound: 0.10 m).

Baseline: the reference publishes no numbers (BASELINE.md), so the stand-in
for "C++ single-core filter-updates/sec" is the committed single-instance
f64 XLA-CPU figure in BASELINE_CPU.json; ``vs_baseline`` divides by it.

The run needs a GPU: without one, or when any phase fails, it prints the
JSON line with an ``error`` field and exits non-zero. Every phase runs.
Environment knobs: BENCH_BANK (default 131072), BENCH_DEADLINE (seconds,
default 780) — past it a watchdog thread prints the partial artifact with an
``error`` field and exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

_DEADLINE_S = float(os.environ.get("BENCH_DEADLINE", "780"))
_OUT: dict = {}  # the one-line artifact, filled in as phases complete
_EMIT_ONCE = threading.Lock()


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _emit_and_exit(code: int = 0):
    """Print exactly ONE JSON line, whichever of {main thread, watchdog}
    gets here first, then exit with ``code``."""
    if not _EMIT_ONCE.acquire(blocking=False):
        while True:
            time.sleep(60.0)
    print(json.dumps(_OUT), flush=True)
    os._exit(code)


def _watchdog():
    _OUT.setdefault("error", f"BENCH_DEADLINE ({_DEADLINE_S:.0f}s) overrun")
    _emit_and_exit(3)


# ---------------------------------------------------------------------------
# the ICRA'18 steady-state mission (BASELINE configs[3])
# ---------------------------------------------------------------------------

# one second of the reference's event schedule at 100 Hz IMU: tick k runs
# predict + acceleration always, plus whichever aiding sensors fire at k
FULL_TICKS = 100
MISSION_TICKS = 300  # one timed run: three mission seconds
DVL_EVERY, PRESSURE_EVERY, ADCP_EVERY, EFFORTS_EVERY = 20, 50, 100, 10  # 5/2/1/10 Hz


def pose_setup(dtype):
    """(state, params, measurement constants) of the steady-state mission."""
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn, geodesy as geo
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    cfg = default_pose_ukf_config()
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.01,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=0.01,
        dtype=dtype,
    )
    g = float(geo.wgs84_gravity(cfg.location.latitude, cfg.location.altitude))
    meas = dict(
        gyro=np.array([0.0, 0.0, 0.01]),
        acc=np.array([0.0, 0.0, g]),
        acc_cov=np.eye(3) * 4e-5,
        dvl=np.array([0.3, 0.0, 0.0]),
        dvl_cov=np.eye(3) * 1e-3,
        press=np.array([float(cfg.hydrostatics.atmospheric_pressure)]),
        press_cov=np.eye(1) * 2500.0,
        adcp=np.array([0.0, 0.0]),
        adcp_cov=np.eye(2) * 1e-3,
        eff=np.zeros(6),
        eff_cov=np.eye(6) * 1.0,
    )
    return state, params, meas


def steady_state_inputs(meas, bank_n: int, ticks: int, dtype, key, t0: int = 0):
    """(T, bank, ...) ``PoseInputs`` of ticks ``t0 .. t0+ticks-1`` of the
    steady-state schedule. Every instance sees its own sensor noise, drawn
    on the device from ``key``; covariances, validity flags and the
    prediction interval are shared across the bank (one value per tick), so
    the per-tick input is 18 floats per instance."""
    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv

    k = np.arange(t0, t0 + ticks)
    keys = jax.random.split(key, 6)

    def noisy(i, value, sigma):
        value = jnp.asarray(value, dtype)
        noise = jax.random.normal(keys[i], (ticks, bank_n, value.shape[0]), dtype)
        return value + jnp.asarray(sigma, dtype) * noise

    def every(n):
        return jnp.asarray(k % n == n - 1)

    def cov(m):
        return jnp.broadcast_to(jnp.asarray(m, dtype), (ticks, *np.shape(m)))

    return drv.PoseInputs(
        dt=jnp.full((ticks, 1), 0.01, dtype),
        rotation_rate=noisy(0, meas["gyro"], 2e-5),
        acc=noisy(1, meas["acc"], 2e-3),
        acc_cov=cov(meas["acc_cov"]),
        acc_valid=jnp.ones((ticks,), bool),
        dvl=noisy(2, meas["dvl"], 2e-3),
        dvl_cov=cov(meas["dvl_cov"]),
        dvl_valid=every(DVL_EVERY),
        pressure=noisy(3, meas["press"], 50.0),
        pressure_cov=cov(meas["press_cov"]),
        pressure_valid=every(PRESSURE_EVERY),
        xy=None,
        xy_cov=None,
        xy_valid=None,
        adcp=noisy(4, meas["adcp"], 1e-2),
        adcp_cov=cov(meas["adcp_cov"]),
        adcp_cell_weighting=jnp.full((ticks,), 0.5, dtype),
        adcp_valid=every(ADCP_EVERY),
        efforts=noisy(5, meas["eff"], 0.5),
        efforts_cov=cov(meas["eff_cov"]),
        efforts_valid=every(EFFORTS_EVERY),
    )


def mission_fn(params):
    """Jitted ``run_trajectory_bank`` over the given params; donates the bank
    state so the 131k-instance covariance is updated in place."""
    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv

    return jax.jit(lambda bs, inp: drv.run_trajectory_bank(bs, params, inp), donate_argnums=0)


def bench_mission(bank_n: int, ticks: int, dtype=jnp.float32, key=None):
    """Cold compile + one warm run of ``ticks`` mission ticks at ``bank_n``.
    Returns (mission-ticks/s, compile seconds, run seconds, final state,
    tick outputs)."""
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    state, params, meas = pose_setup(dtype)
    key = jax.random.PRNGKey(0) if key is None else key
    inputs = steady_state_inputs(meas, bank_n, ticks, dtype, key)
    run = mission_fn(params)
    bstate = bankmod.replicate(state, bank_n)
    t0 = time.perf_counter()
    compiled = run.lower(bstate, inputs).compile()
    compile_s = time.perf_counter() - t0
    # warm: the first execution also runs the GPU autotuner
    bstate, outs = compiled(_fresh(bstate), inputs)
    jax.block_until_ready(bstate.cov)
    t1 = time.perf_counter()
    bstate, outs = compiled(bstate, inputs)
    jax.block_until_ready((bstate.cov, outs.position))
    run_s = time.perf_counter() - t1
    return bank_n * ticks / run_s, compile_s, run_s, bstate, outs


def _fresh(tree):
    """A materialized copy of a (possibly broadcast) pytree, safe to donate."""
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def measure_mission_ate():
    """1-minute ICRA'18 mission replay at f32 on the default device."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import icra18_mission

    ate, dist = icra18_mission.main(["--minutes", "1.0", "--dtype", "f32"])
    return float(ate), float(dist)


def _small_filter_step(name: str, dtype):
    """(bank state, jitted bank step) of one small filter at BASELINE
    configs[0..2]: VelocityUKF thrusters + DVL, BottomUKF range, and
    IndirectPoseUKF one-corner marker update."""
    from slam_uwv_kalman_filters_tpu.models import bottom_ukf as bukf
    from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as ipu
    from slam_uwv_kalman_filters_tpu.models import velocity_ukf as vukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration

    if name == "velocity":
        mu = vukf.VelocityState(velocity=jnp.zeros(3, dtype), z_position=jnp.zeros(1, dtype))
        state, params = vukf.init(mu, jnp.eye(4, dtype=dtype) * 0.1, dyn.default_uwv_parameters(dtype))
        state = vukf.integrate_body_efforts(state, jnp.array([60.0, 0, 0, 0, 0, 1.0], dtype))
        z, r = jnp.array([0.3, 0.0, 0.0], dtype), jnp.eye(3, dtype=dtype) * 1e-3

        def step(bs):
            bs = vukf.predict_bank(bs, params, 0.05)
            return vukf.update_dvl_bank(bs, jnp.broadcast_to(z, (bs.cov.shape[0], 3)), r)[0]

    elif name == "bottom":
        mu = bukf.BottomState(distance=jnp.array([10.0], dtype), normal=jnp.array([0.0, 0.0, 1.0], dtype))
        state, params = bukf.init(mu, jnp.diag(jnp.array([1.0, 0.05, 0.05], dtype)))
        state = bukf.set_velocity(state, jnp.array([0.5, 0.0, -0.1], dtype))
        beam, origin = jnp.array([0.0, 0.0, -1.0], dtype), jnp.zeros(3, dtype)

        def step(bs):
            bs = bukf.predict_bank(bs, params, 0.1)
            z = jnp.full((bs.cov.shape[0], 1), 9.9, dtype)
            return bukf.update_range_bank(bs, z, jnp.eye(1, dtype=dtype) * 1e-2, beam, origin)[0]

    elif name == "indirect":
        state, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, dtype=dtype)
        cam = CameraConfiguration()
        marker = (
            jnp.array([[330.0, 236.0]], dtype), jnp.eye(2, dtype=dtype)[None] * 4.0,
            jnp.array([[0.1, 0.1, 0.0]], dtype), jnp.array([2.0, 0.0, 1.0], dtype),
            jnp.array([1.0, 0, 0, 0], dtype), jnp.eye(6, dtype=dtype) * 1e-4, cam,
            jnp.zeros(3, dtype), jnp.array([1.0, 0, 0, 0], dtype),
        )

        def step(bs):
            bs = ipu.predict_bank(bs, params, 0.1)
            return ipu.update_markers_bank(bs, *marker)[0]

    else:
        raise ValueError(name)
    return state, jax.jit(step)


def bench_small_filter(name: str, bank_n: int = 65536, iters: int = 20, dtype=jnp.float32):
    """filter-steps/s of one small filter's bank predict + update."""
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    state, step = _small_filter_step(name, dtype)
    bs = step(_fresh(bankmod.replicate(state, bank_n)))  # compile + warm
    jax.block_until_ready(bs.cov)
    t0 = time.perf_counter()
    for _ in range(iters):
        bs = step(bs)
    jax.block_until_ready(bs.cov)
    if not bool(jnp.isfinite(bs.cov).all()):
        raise RuntimeError(f"{name} bank diverged: non-finite covariance")
    return bank_n * iters / (time.perf_counter() - t0)


def load_canonical_baseline(scenario: str):
    """Committed single-core baseline (BASELINE_CPU.json)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_CPU.json")
    with open(path) as f:
        return float(json.load(f)["scenarios"][scenario]["steps_per_sec"])


def main():
    watchdog = threading.Timer(_DEADLINE_S + 30.0, _watchdog)
    watchdog.daemon = True
    watchdog.start()
    dev = jax.devices()[0]
    _OUT["device"] = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    if dev.platform != "gpu":
        _OUT["error"] = f"no GPU: JAX's default device is {dev.platform}"
        _emit_and_exit(2)

    from slam_uwv_kalman_filters_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    bank_n = int(os.environ.get("BENCH_BANK", "131072"))
    ticks = MISSION_TICKS
    _log(f"device={dev.device_kind} bank={bank_n} ticks={ticks} deadline={_DEADLINE_S:.0f}s")

    value, compile_s, run_s, bstate, _ = bench_mission(bank_n, ticks)
    if not bool(jnp.isfinite(bstate.cov).all()):
        raise RuntimeError("pose_full bench diverged: non-finite covariance")
    _log(f"mission: {value:.0f} ticks/s (compile {compile_s:.1f}s, run {run_s:.2f}s)")
    baseline = load_canonical_baseline("pose_full")
    _OUT.update(
        {
            "metric": "pose_full_mission_ticks_per_sec_per_device",
            "value": value,
            "unit": "mission-ticks/s",
            "vs_baseline": value / baseline,
            "bank": bank_n,
            "ticks": ticks,
            "compile_s": compile_s,
            "peak_bytes_in_use": dev.memory_stats().get("peak_bytes_in_use"),
        }
    )
    del bstate

    ate, dist = measure_mission_ate()
    _log(f"mission ATE (f32): {ate:.4f} m over {dist:.0f} m")
    _OUT.update({"ate_m": ate, "ate_dtype": "float32", "ate_bound_m": 0.10})
    if not ate < 0.10:
        raise RuntimeError(f"solo f32 ATE {ate:.4f} m exceeds the 0.10 m bound")

    scenarios = {}
    for name in ("velocity", "bottom", "indirect"):
        v = bench_small_filter(name)
        _log(f"{name}: {v:.0f} steps/s")
        scenarios[name] = {
            "value": v,
            "unit": "filter-steps/s",
            "bank": 65536,
            "vs_baseline": v / load_canonical_baseline(name),
        }
    _OUT["scenarios"] = scenarios
    watchdog.cancel()
    _emit_and_exit(0)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # the artifact contract: one JSON line, then fail
        _OUT["error"] = f"{type(e).__name__}: {e}"[:300]
        _log(f"bench failed: {e!r}")
        _emit_and_exit(1)
