#!/usr/bin/env python3
"""Smoke test of the filter engine on one NVIDIA GPU — the quickest proof
that the system starts and runs correctly on the card.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded-bank phase only

Phases on one card, in order (each prints its seconds; any failure exits
non-zero and prints no result):

1. sigma-delta parity: ``ops/kernels.sigma_deltas_banked`` (equilibrated
   batched Cholesky + ± interleave) on this card, at bank 131,072, against
   an f64 NumPy factor at n = 53 and n = 59 on raw-unit covariances
   (variances 1e-11..1e1). Bounds, relative
   to √(Pᵢᵢ·Pⱼⱼ) and √Pᵢᵢ: L·Lᵀ reproduces the correlation matrix to 1e-5,
   deltas agree with the f64 deltas to 1e-4 (f32 unit roundoff 6e-8 times
   the ~1e2 growth of a 53-step factorization);
2. the flagship mission: the 53-DOF PoseUKF bank at 131,072 instances, f32,
   ICRA'18 steady-state schedule (predict + IMU acceleration at 100 Hz, DVL
   5 Hz, pressure 2 Hz, ADCP 1 Hz, body efforts 10 Hz) through
   ``pose_driver.run_trajectory_bank`` as one ``lax.scan`` — compile
   seconds, ticks/s, peak device memory; finite outputs, and its first 8
   instances equal a bank-of-8 run of the same inputs;
3. one predict + update bank step of VelocityUKF, BottomUKF and
   IndirectPoseUKF at 65,536 instances, checked against the same step on
   the host CPU for 4 instances;
4. an 8-instance, 200-tick mission in f32 on the card against the same
   mission in f64 on the CPU (computed in a CPU-only child process);
5. the 1-minute solo ICRA'18 mission at f32: ATE below 0.10 m;
6. an ``utils/aot.export_step`` round trip of the bank step: lowered to
   StableHLO, compiled again from it and run on the card, outputs equal to
   the jitted call (turning the artifact into bytes needs ``flatbuffers``,
   which a GPU host need not have; ``tests/test_aot.py`` covers the bytes).

With ``--cards 4``: a 1-D ``bank`` mesh over the four cards, the flagship
mission under ``jit`` with the bank and its inputs placed by
``NamedSharding`` (``parallel/sharding.shard_bank`` / ``shard_time_bank``)
and the scan in ``sharding.mission_shard_map``, so each card runs its own
shard (the compiled program must move no bank data between cards: no
all-gather, all-to-all or collective-permute, and its tick outputs stay
sharded; a plain ``jit`` all-gathers on the H100), ``ensemble_mean``, a
mid-mission
``save_sharded``/``restore_sharded`` round trip, all compared with the same
bank on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

BANK = 131072
SMALL_BANK = 65536
CHECK_INSTANCES = 8
REF_TICKS = 200
ATE_BOUND_M = 0.10


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Log:
    """Per-phase timing lines, each tagged with the card."""

    def __init__(self, card: str):
        self.card = card
        self.t0 = time.perf_counter()

    def __call__(self, phase: str, **fields):
        parts = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{phase}] {parts} | card={self.card} | t+{time.perf_counter() - self.t0:.1f}s", flush=True)


def _fmt(v):
    return f"{v:.6g}" if isinstance(v, float) else str(v)


def _per_instance(x) -> bool:
    """A (T, bank, m) per-instance input stream (not a shared per-tick one)."""
    return x.ndim == 3 and x.shape[1] in (BANK, CHECK_INSTANCES)


def _peak_gb(dev) -> float:
    return dev.memory_stats()["peak_bytes_in_use"] / 1e9


# ---------------------------------------------------------------------------
# phase 1: sigma-delta parity
# ---------------------------------------------------------------------------


def raw_unit_covs(key, bank_n: int, n: int):
    """(bank, n, n) f32 covariances built on the device: random correlation
    matrices scaled by standard deviations spread over 10^-5.5 .. 10^0.5."""
    import jax
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu.ops.linalg_small import mm

    kw, kd = jax.random.split(key)
    w = jax.random.normal(kw, (bank_n, n, n), jnp.float32)
    corr = 0.7 * jnp.eye(n, dtype=jnp.float32) + (0.3 / n) * mm(w, jnp.swapaxes(w, 1, 2))
    s = jax.lax.rsqrt(jnp.diagonal(corr, axis1=1, axis2=2))
    d = s * jnp.sqrt(10.0 ** jax.random.uniform(kd, (bank_n, n), jnp.float32, -11.0, 1.0))
    return corr * d[:, :, None] * d[:, None, :]


def check_deltas(deltas, covs, label):
    """f64 NumPy check of f32 deltas on a sample of instances; returns the
    two worst relative errors."""
    deltas = np.asarray(deltas, np.float64)
    covs = np.asarray(covs, np.float64)
    d = np.sqrt(np.diagonal(covs, axis1=1, axis2=2))
    lc = deltas[:, 1::2, :] / d[:, None, :]  # rows: columns of chol(corr)
    corr = covs / (d[:, :, None] * d[:, None, :])
    recon_err = np.abs(np.einsum("bji,bjk->bik", lc, lc) - corr).max()
    ref = np.zeros_like(deltas)
    for b in range(covs.shape[0]):
        lt = np.linalg.cholesky(covs[b]).T
        ref[b, 1::2], ref[b, 2::2] = lt, -lt
    delta_err = (np.abs(deltas - ref) / d[:, None, :]).max()
    if not (recon_err < 1e-5 and delta_err < 1e-4 and np.all(deltas[:, 0] == 0.0)):
        raise AssertionError(f"{label}: L·Lᵀ err {recon_err:.2e}, delta err {delta_err:.2e}")
    return recon_err, delta_err


def phase_sigma_parity(log):
    import jax
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu.ops import kernels

    sample = np.unique(np.concatenate([np.arange(256), np.linspace(0, BANK - 1, 256).astype(int)]))
    for n in (53, 59):
        t0 = time.perf_counter()
        covs = raw_unit_covs(jax.random.PRNGKey(n), BANK, n)
        fn = jax.jit(kernels.sigma_deltas_banked)
        tc = time.perf_counter()
        compiled = fn.lower(covs).compile()
        compile_s = time.perf_counter() - tc
        deltas = jax.block_until_ready(compiled(covs))
        tr = time.perf_counter()
        deltas = jax.block_until_ready(compiled(covs))
        call_ms = 1e3 * (time.perf_counter() - tr)
        if not bool(jnp.isfinite(deltas).all()):
            raise AssertionError(f"n={n}: non-finite sigma deltas")
        recon, derr = check_deltas(deltas[sample], covs[sample], f"n={n}")
        log(
            "sigma_parity", n=n, bank=BANK, llt_rel_err=float(recon), delta_rel_err=float(derr), bounds="1e-5/1e-4",
            compile_s=compile_s, call_ms=call_ms, seconds=time.perf_counter() - t0,
        )
        del covs, deltas


# ---------------------------------------------------------------------------
# phase 2: the flagship mission
# ---------------------------------------------------------------------------


def phase_mission(log, dev):
    import jax
    import jax.numpy as jnp

    import bench
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    t0 = time.perf_counter()
    rate, compile_s, run_s, bstate, outs = bench.bench_mission(BANK, bench.MISSION_TICKS)
    finite = all(
        bool(jnp.isfinite(x).all()) for x in (bstate.cov, bstate.mu.position, outs.position)
    )
    if not finite:
        raise AssertionError("flagship mission produced non-finite values")
    big = np.asarray(bstate.mu.position[:CHECK_INSTANCES])
    big_trace = np.asarray(jnp.trace(bstate.cov[:CHECK_INSTANCES], axis1=1, axis2=2))
    peak = _peak_gb(dev)
    log(
        "mission", bank=BANK, ticks=bench.MISSION_TICKS, mission_seconds=bench.MISSION_TICKS / 100,
        compile_s=compile_s, run_s=run_s, ticks_per_s=rate, peak_gb=peak,
    )
    del bstate, outs

    # the same inputs for the first 8 instances, as a bank of 8
    state, params, meas = bench.pose_setup(jnp.float32)
    inputs = bench.steady_state_inputs(meas, BANK, bench.MISSION_TICKS, jnp.float32, jax.random.PRNGKey(0))
    inputs8 = jax.tree_util.tree_map(
        lambda x: x[:, :CHECK_INSTANCES] if _per_instance(x) else x, inputs
    )
    del inputs
    # bench_mission ran the schedule twice (warm-up, then timed) from the
    # initial state; so does the bank of 8
    run8 = bench.mission_fn(params)
    small, _ = run8(bench._fresh(bankmod.replicate(state, CHECK_INSTANCES)), inputs8)
    small, _ = run8(small, inputs8)
    pos_err = np.abs(np.asarray(small.mu.position) - big).max()
    trace_rel = np.abs(np.asarray(jnp.trace(small.cov, axis1=1, axis2=2)) / big_trace - 1.0).max()
    if not (pos_err < 1e-3 and trace_rel < 1e-3):
        raise AssertionError(f"bank 8 vs bank {BANK}: position {pos_err:.2e} m, trace {trace_rel:.2e}")
    log("mission_bank_invariance", instances=CHECK_INSTANCES, position_err_m=float(pos_err),
        cov_trace_rel_err=float(trace_rel), bounds="1e-3 m / 1e-3", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 3: the three small filters
# ---------------------------------------------------------------------------


def phase_small_filters(log, dev):
    import jax
    import jax.numpy as jnp

    import bench
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    cpu = jax.devices("cpu")[0]
    for name in ("velocity", "bottom", "indirect"):
        t0 = time.perf_counter()
        state, step = bench._small_filter_step(name, jnp.float32)
        bs = bench._fresh(bankmod.replicate(state, SMALL_BANK))
        tc = time.perf_counter()
        out = jax.block_until_ready(step(bs))
        first_s = time.perf_counter() - tc
        if not bool(jnp.isfinite(out.cov).all()):
            raise AssertionError(f"{name}: non-finite covariance")
        with jax.default_device(cpu):
            ref = step(bankmod.replicate(jax.device_put(state, cpu), 4))
        err = np.abs(np.asarray(out.cov[:4]) - np.asarray(ref.cov)).max()
        scale = np.abs(np.asarray(ref.cov)).max()
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{name}: GPU vs CPU covariance differs by {err:.2e}")
        log("small_filter", filter=name, bank=SMALL_BANK, compile_and_step_s=first_s,
            cov_err_vs_cpu=float(err / scale), bound="1e-4", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 4: f32 on the card against f64 on the CPU
# ---------------------------------------------------------------------------


def reference_mission_inputs(dtype):
    """8 instances x 200 ticks of the steady-state schedule with NumPy-drawn
    per-instance noise, so the card and the CPU replay identical inputs."""
    import jax.numpy as jnp

    import bench

    _, _, meas = bench.pose_setup(dtype)
    rng = np.random.default_rng(11)
    t, b = REF_TICKS, CHECK_INSTANCES
    k = np.arange(t)
    noisy = lambda v, s: jnp.asarray(v + s * rng.standard_normal((t, b, len(v))), dtype)
    cov = lambda m: jnp.asarray(np.broadcast_to(m, (t, *m.shape)), dtype)
    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv

    return drv.PoseInputs(
        dt=jnp.full((t, 1), 0.01, dtype),
        rotation_rate=noisy(meas["gyro"], 2e-5),
        acc=noisy(meas["acc"], 2e-3), acc_cov=cov(meas["acc_cov"]),
        acc_valid=jnp.ones((t,), bool),
        dvl=noisy(meas["dvl"], 2e-3), dvl_cov=cov(meas["dvl_cov"]),
        dvl_valid=jnp.asarray(k % bench.DVL_EVERY == bench.DVL_EVERY - 1),
        pressure=noisy(meas["press"], 50.0), pressure_cov=cov(meas["press_cov"]),
        pressure_valid=jnp.asarray(k % bench.PRESSURE_EVERY == bench.PRESSURE_EVERY - 1),
        xy=None, xy_cov=None, xy_valid=None,
        adcp=noisy(meas["adcp"], 1e-2), adcp_cov=cov(meas["adcp_cov"]),
        adcp_cell_weighting=jnp.full((t,), 0.5, dtype),
        adcp_valid=jnp.asarray(k % bench.ADCP_EVERY == bench.ADCP_EVERY - 1),
        efforts=noisy(meas["eff"], 0.5), efforts_cov=cov(meas["eff_cov"]),
        efforts_valid=jnp.asarray(k % bench.EFFORTS_EVERY == bench.EFFORTS_EVERY - 1),
    )


def reference_mission(dtype):
    """Final (positions, velocities, covariance traces) of the 8-instance
    reference mission at ``dtype`` on JAX's default device."""
    import jax.numpy as jnp

    import bench
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    state, params, _ = bench.pose_setup(dtype)
    final, _ = bench.mission_fn(params)(
        bench._fresh(bankmod.replicate(state, CHECK_INSTANCES)), reference_mission_inputs(dtype)
    )
    return (
        np.asarray(final.mu.position, np.float64),
        np.asarray(final.mu.velocity, np.float64),
        np.asarray(jnp.trace(final.cov, axis1=1, axis2=2), np.float64),
    )


def compare_reference(f32, f64, label: str):
    """(position m, velocity m/s, relative covariance-trace) gaps between two
    ``reference_mission`` results; raises beyond 1e-3 m, 1e-4 m/s, 1e-4, and
    on any NaN. f32 roundoff amplified by 200 ticks of filter recursion gives
    3.9e-4 m, 1.8e-5..3.0e-5 m/s and 2.8e-5..3.0e-5 on the H100 and on a CPU;
    the same mission with the filter's matmuls at default precision (TF32 on
    the H100) ends in NaN, so every bound fails it (PERF.md)."""
    (pos32, vel32, trace32), (pos64, vel64, trace64) = f32, f64
    pos_err = np.abs(pos32 - pos64).max()
    vel_err = np.abs(vel32 - vel64).max()
    trace_err = np.abs(trace32 / trace64 - 1.0).max()
    if not (pos_err < 1e-3 and vel_err < 1e-4 and trace_err < 1e-4):
        raise AssertionError(
            f"{label}: position {pos_err:.2e} m, velocity {vel_err:.2e} m/s, trace {trace_err:.2e}"
        )
    return pos_err, vel_err, trace_err


def _f64_cpu_reference(path: str) -> None:
    """Entry point of the CPU-only child process of phase 4."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    pos, vel, trace = reference_mission(jnp.float64)
    np.savez(path, pos=pos, vel=vel, trace=trace)


def phase_f32_vs_f64(log):
    import jax.numpy as jnp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ref.npz")
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        here = os.path.dirname(os.path.abspath(__file__))
        subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke._f64_cpu_reference({path!r})"],
            cwd=here, env=env, check=True, timeout=900,
        )
        with np.load(path) as ref:
            pos64, vel64, trace64 = ref["pos"], ref["vel"], ref["trace"]
    pos_err, vel_err, trace_err = compare_reference(
        reference_mission(jnp.float32), (pos64, vel64, trace64), "f32 GPU vs f64 CPU"
    )
    log("f32_gpu_vs_f64_cpu", instances=CHECK_INSTANCES, ticks=REF_TICKS,
        position_err_m=float(pos_err), velocity_err_mps=float(vel_err),
        cov_trace_rel_err=float(trace_err), bounds="1e-3 m, 1e-4 m/s, 1e-4",
        seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phases 5-6: solo accuracy, AOT export
# ---------------------------------------------------------------------------


def phase_solo_ate(log):
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import icra18_mission

    ate, dist = icra18_mission.main(["--minutes", "1.0", "--dtype", "f32"])
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"solo f32 ATE {ate:.4f} m exceeds {ATE_BOUND_M} m")
    log("solo_ate", minutes=1.0, dtype="f32", ate_m=float(ate), bound_m=ATE_BOUND_M,
        track_m=float(dist), seconds=time.perf_counter() - t0)


def phase_aot(log):
    import jax
    import jax.numpy as jnp

    import bench
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
    from slam_uwv_kalman_filters_tpu.utils import aot

    t0 = time.perf_counter()
    state, params, meas = bench.pose_setup(jnp.float32)
    bank_n = 1024
    bs = bench._fresh(bankmod.replicate(state, bank_n))
    z = jnp.broadcast_to(jnp.asarray(meas["dvl"], jnp.float32), (bank_n, 3))

    def step(bs, z):
        bs = pukf.predict_bank(bs, params, 0.01)
        return pukf.update_velocity_bank(bs, params, z, meas["dvl_cov"])

    jitted = jax.jit(step)
    exported = aot.export_step(jitted, bs, z)
    if exported.platforms != ("cuda",):
        raise AssertionError(f"exported for {exported.platforms}, not the card")
    ref_state, ref_info = jitted(bs, z)
    out_state, out_info = exported.call(bs, z)
    for a, b in zip(jax.tree_util.tree_leaves((out_state, out_info)),
                    jax.tree_util.tree_leaves((ref_state, ref_info))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    log("aot_round_trip", bank=bank_n, equal=True, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_cards(log):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from slam_uwv_kalman_filters_tpu.models import pose_driver as drv
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
    from slam_uwv_kalman_filters_tpu.parallel import checkpoint, sharding

    t0 = time.perf_counter()
    ticks = 100
    state, params, meas = bench.pose_setup(jnp.float32)
    mesh = sharding.make_mesh(jax.devices()[:4])

    def inputs_for(t0_tick, sharded):
        inp = bench.steady_state_inputs(
            meas, BANK, ticks, jnp.float32, jax.random.fold_in(jax.random.PRNGKey(4), t0_tick),
            t0=t0_tick,
        )
        return sharding.shard_time_bank(inp, mesh, BANK) if sharded else inp

    def mission(bs, inp):
        return drv.run_trajectory_bank(bs, params, inp)

    bs4 = sharding.shard_bank(bench._fresh(bankmod.replicate(state, BANK)), mesh)
    inp0 = inputs_for(0, True)
    tc = time.perf_counter()
    run4 = jax.jit(sharding.mission_shard_map(mission, mesh, BANK)).lower(bs4, inp0).compile()
    compile_s = time.perf_counter() - tc
    hlo = run4.as_text()
    moves = [
        line.split("=")[1].strip()[:60]
        for line in hlo.splitlines()
        if re.search(r"(all-gather|all-to-all|collective-permute)(-start)?\(", line)
    ]
    if moves:
        raise AssertionError(f"the sharded mission moves bank data between cards: {moves}")
    ens = jax.jit(sharding.ensemble_mean)
    tc = time.perf_counter()
    half, outs = run4(bs4, inp0)
    jax.block_until_ready(half.cov)
    first_s = time.perf_counter() - tc
    time_bank = NamedSharding(mesh, P(None, "bank"))
    if not all(x.sharding.is_equivalent_to(time_bank, x.ndim) for x in jax.tree_util.tree_leaves(outs)):
        raise AssertionError("the tick outputs are not sharded over the bank")
    del outs
    del inp0
    with tempfile.TemporaryDirectory() as td:
        checkpoint.save_sharded(os.path.join(td, "mid.npz"), half)
        resumed = checkpoint.restore_sharded(os.path.join(td, "mid.npz"), half, place=True)
    if resumed.cov.sharding != half.cov.sharding:
        raise AssertionError("restored bank lost its sharding")
    tr = time.perf_counter()
    final4, _ = run4(resumed, inputs_for(ticks, True))
    jax.block_until_ready(final4.cov)
    run_s = time.perf_counter() - tr
    mean4 = np.asarray(ens(final4.mu.position))
    pos4 = np.asarray(final4.mu.position)
    trace4 = np.asarray(jnp.trace(final4.cov, axis1=1, axis2=2))
    if len(final4.cov.sharding.device_set) != 4:
        raise AssertionError("final bank is not sharded over 4 cards")
    del half, resumed, final4, bs4
    log("four_card_mission", bank=BANK, per_card=BANK // 4, ticks=2 * ticks,
        compile_s=compile_s, first_half_s=first_s, second_half_s=run_s,
        ticks_per_s=BANK * ticks / run_s,
        all_reduces=len(re.findall(r"all-reduce(-start)?\(", hlo)))

    one = jax.devices()[0]
    run1 = jax.jit(mission)
    with jax.default_device(one):
        bs1 = bench._fresh(bankmod.replicate(state, BANK))
        bs1, _ = run1(bs1, inputs_for(0, False))
        bs1, _ = run1(bs1, inputs_for(ticks, False))
        mean1 = np.asarray(sharding.ensemble_mean(bs1.mu.position))
        pos_err = np.abs(np.asarray(bs1.mu.position) - pos4).max()
        trace_rel = np.abs(np.asarray(jnp.trace(bs1.cov, axis1=1, axis2=2)) / trace4 - 1.0).max()
    mean_err = np.abs(mean1 - mean4).max()
    if not (pos_err < 1e-3 and trace_rel < 1e-3 and mean_err < 1e-4):
        raise AssertionError(
            f"4 cards vs 1 card: position {pos_err:.2e} m, trace {trace_rel:.2e}, "
            f"ensemble mean {mean_err:.2e} m"
        )
    log("four_card_vs_one_card", position_err_m=float(pos_err), cov_trace_rel_err=float(trace_rel),
        ensemble_mean_err_m=float(mean_err), bounds="1e-3 m / 1e-3 / 1e-4 m",
        seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    import jax

    from slam_uwv_kalman_filters_tpu.utils.platform import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees {len(devices)}", file=sys.stderr)
        return 2
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    log = Log(card)
    dev = devices[0]
    if args.cards == 4:
        phase_four_cards(log)
    else:
        phase_sigma_parity(log)
        phase_mission(log, dev)
        phase_small_filters(log, dev)
        phase_f32_vs_f64(log)
        phase_solo_ate(log)
        phase_aot(log)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
