"""REAL multi-host validation: a 2-process jax.distributed job on CPU.

Single-process virtual-device tests (the 8-device conftest mesh) validate
sharding *semantics* but every collective stays in one address space. This
test spawns two OS processes, each a jax.distributed "host" with 4 virtual
devices, and runs the full sharded PoseUKF step from ``__graft_entry__`` on
the 8-device global mesh — so the ensemble-statistics reduction crosses the
process boundary exactly like inter-host traffic on a ≥2-host cluster
(BASELINE.md scaling north star; SURVEY.md §2.4, §4.4)."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multiprocess_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_stats(bank_n: int):
    """The same full step on this process's own 8-device mesh (conftest)."""
    import __graft_entry__ as ge
    from slam_uwv_kalman_filters_tpu.parallel import sharding as shmod

    bstate, (z_dvl, r_dvl, z_adcp, r_adcp), full_step, _ = ge._build(
        jnp.float64, bank_n
    )
    z_dvl = jnp.asarray(
        np.stack([[0.3 + 0.01 * i, 0.0, 0.0] for i in range(bank_n)]), jnp.float64
    )
    mesh = shmod.make_mesh()
    bsh = shmod.bank_sharding(mesh)
    gstate = shmod.shard_bank(bstate, mesh)
    data = tuple(jax.device_put(x, bsh) for x in (z_dvl, r_dvl, z_adcp, r_adcp))
    _, stats = jax.jit(full_step)(gstate, *data)
    return (
        np.asarray(jax.device_get(stats["mean_position"])),
        float(jax.device_get(stats["acceptance"])),
    )


def test_two_process_distributed_bank_step():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the worker pins its own JAX_PLATFORMS/XLA_FLAGS before importing jax
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", f"localhost:{port}"],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    stats = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("STATS "):
                parts = line.split()
                stats[int(parts[1])] = [float(v) for v in parts[2:]]
    assert set(stats) == {0, 1}, f"missing STATS lines: {outs}"

    # both hosts must see the identical (replicated) global reduction
    np.testing.assert_array_equal(np.asarray(stats[0]), np.asarray(stats[1]))

    # and it must match the same step on a single-process 8-device mesh
    # (f64; tolerance only for cross-topology reduction-order differences)
    mean_ref, acc_ref = _reference_stats(bank_n=16)
    got = np.asarray(stats[0][:3])
    np.testing.assert_allclose(got, mean_ref, rtol=1e-12, atol=1e-15)
    assert stats[0][3] == acc_ref
