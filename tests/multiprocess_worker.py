"""Worker process for the REAL multi-host test (tests/test_multiprocess.py).

Each worker is one "host" of a 2-process jax.distributed job: it owns 4
virtual CPU devices, joins the process group via
``parallel.sharding.init_multihost``, and runs the full sharded PoseUKF bank
step from ``__graft_entry__`` on the 8-device global mesh. The ensemble
reduction then crosses the process boundary — the inter-host path of a real
cluster (SURVEY.md §2.4) — which single-process virtual-device tests can never
exercise. Launched as::

    python tests/multiprocess_worker.py <pid> <nproc> <coordinator>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from slam_uwv_kalman_filters_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache(writes=False)


def main(pid: int, nproc: int, coordinator: str) -> None:
    import numpy as np
    import jax.numpy as jnp

    from slam_uwv_kalman_filters_tpu.parallel import sharding as shmod

    assert shmod.init_multihost(coordinator, nproc, pid) == pid
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.local_devices()) == 4

    import __graft_entry__ as ge

    mesh = shmod.make_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 4 * nproc
    bank_n = 2 * n_dev

    bstate, (z_dvl, r_dvl, z_adcp, r_adcp), full_step, _ = ge._build(
        jnp.float64, bank_n
    )
    # per-instance DVL so the cross-process ensemble mean is information-
    # bearing (a shard-order or shard-placement bug would shift it)
    z_dvl = jnp.asarray(
        np.stack([[0.3 + 0.01 * i, 0.0, 0.0] for i in range(bank_n)]), jnp.float64
    )

    # multi-controller data placement: every process computes the same global
    # values and contributes its addressable shards
    bsh = shmod.bank_sharding(mesh)

    def globalize(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, bsh, lambda idx: a[idx])

    gstate = jax.tree_util.tree_map(globalize, bstate)
    gz = tuple(globalize(x) for x in (z_dvl, r_dvl, z_adcp, r_adcp))

    repl = shmod.replicated(mesh)
    step = jax.jit(
        full_step,
        in_shardings=(bsh,) * 5,
        out_shardings=(bsh, {"mean_position": repl, "acceptance": repl}),
    )
    bs2, stats = step(gstate, *gz)
    jax.block_until_ready(bs2.cov)
    assert len(bs2.cov.sharding.device_set) == n_dev, "bank not sharded globally"

    mp = np.asarray(jax.device_get(stats["mean_position"]))
    acc = float(jax.device_get(stats["acceptance"]))
    print(
        "STATS", pid, " ".join(f"{v:.17g}" for v in mp), f"{acc:.17g}",
        flush=True,
    )


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
