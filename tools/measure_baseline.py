"""Record the canonical single-core CPU baseline (BASELINE_CPU.json).

The reference publishes no throughput numbers (BASELINE.md), so the stand-in
for "C++ single-core filter-updates/sec" is the same filter math jit-compiled
by XLA-CPU for a single f64 instance. Live re-measurement every bench run
proved too fragile on a shared host (VERDICT r2 "What's weak" #3: the
round-1 -> round-2 vs_baseline swing was denominator noise, not a speedup),
so this script takes the **median of N long runs** per scenario, stamps an
environment fingerprint, and writes the committed artifact that
``bench.py::load_canonical_baseline`` divides by. Re-run only deliberately
(new hardware, changed filter math).

Usage:  python tools/measure_baseline.py [--runs N] [--scenarios a,b,...]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402  (before bench: the baseline is single-core CPU by definition)

jax.config.update("jax_enable_x64", True)

SCENARIOS = ("pose_full", "pose", "velocity", "bottom", "indirect")


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _rate(step, state, ticks: int, repeats: int = 3) -> float:
    """Best of ``repeats`` timed passes of ``ticks`` calls of ``step``."""
    state = step(state)  # compile
    jax.block_until_ready(state)
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(ticks):
            state = step(state)
        jax.block_until_ready(state)
        best = max(best, ticks / (time.perf_counter() - t0))
    return best


def pose_full_single() -> float:
    """One f64 instance through the steady-state mission second as separate
    jitted phases, each applied only on its schedule — the reference's
    event-driven cost structure."""
    import jax.numpy as jnp

    import bench
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf

    state, params, ms = bench.pose_setup(jnp.float64)
    state = pukf.integrate_rotation_rate(state, jnp.asarray(ms["gyro"]))
    phases = {
        1: lambda s: pukf.update_acceleration(s, params, ms["acc"], ms["acc_cov"])[0],
        bench.DVL_EVERY: lambda s: pukf.update_velocity(s, params, ms["dvl"], ms["dvl_cov"])[0],
        bench.PRESSURE_EVERY: lambda s: pukf.update_pressure(s, params, ms["press"], ms["press_cov"])[0],
        bench.ADCP_EVERY: lambda s: pukf.update_water_velocity(s, params, ms["adcp"], ms["adcp_cov"], 0.5)[0],
        bench.EFFORTS_EVERY: lambda s: pukf.update_body_efforts(s, params, ms["eff"], ms["eff_cov"])[0],
    }
    predict = jax.jit(lambda s: pukf.predict(s, params, 0.01))
    phases = {every: jax.jit(fn) for every, fn in phases.items()}

    def second(s):
        for k in range(bench.FULL_TICKS):
            s = predict(s)
            for every, fn in phases.items():
                if k % every == every - 1:
                    s = fn(s)
        return s

    return bench.FULL_TICKS * _rate(second, state, ticks=3)


def single_step(scenario: str) -> float:
    """One f64 instance of a scenario's predict + update step."""
    import jax.numpy as jnp

    import bench
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod

    if scenario == "pose":
        state, params, ms = bench.pose_setup(jnp.float64)
        step = jax.jit(lambda s: pukf.update_velocity(
            pukf.predict(s, params, 0.01), params, ms["dvl"], ms["dvl_cov"])[0])
        return _rate(step, state, ticks=300)
    state, step = bench._small_filter_step(scenario, jnp.float64)
    return _rate(step, bankmod.replicate(state, 1), ticks=300)


def measure(scenario: str, runs: int) -> dict:
    samples = []
    for i in range(runs):
        v = pose_full_single() if scenario == "pose_full" else single_step(scenario)
        samples.append(v)
        print(f"  run {i + 1}/{runs}: {v:.1f} steps/s", file=sys.stderr)
    return {
        "steps_per_sec": round(statistics.median(samples), 1),
        "samples": [round(s, 1) for s in samples],
        "spread": round(max(samples) / min(samples), 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=5, help="long runs per scenario (median wins)")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--out", default=str(ROOT / "BASELINE_CPU.json"))
    args = ap.parse_args(argv)

    import jax

    out = {
        "what": (
            "canonical single-instance f64 XLA-CPU baseline (C++-semantics "
            "stand-in); median of long runs on this host. bench.py divides "
            "its device number by scenarios[*].steps_per_sec."
        ),
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "environment": {
            "cpu": _cpu_model(),
            "cores": os.cpu_count(),
            "platform": platform.platform(),
            "python": platform.python_version(),
            "jax": jax.__version__,
            "load_avg_at_start": os.getloadavg()[0],
        },
        "method": {
            "runs_per_scenario": args.runs,
            "aggregate": "median of per-run best-of-repeats",
            "single_run": "tools/measure_baseline.pose_full_single / single_step",
        },
        "scenarios": {},
    }
    for sc in args.scenarios.split(","):
        sc = sc.strip()
        print(f"measuring {sc} ...", file=sys.stderr)
        out["scenarios"][sc] = measure(sc, args.runs)

    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps({k: v["steps_per_sec"] for k, v in out["scenarios"].items()}))


if __name__ == "__main__":
    main()
