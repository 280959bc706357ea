"""Test harness configuration.

Runs the suite on CPU with 8 virtual XLA devices (the standard JAX trick for
testing multi-device sharding without a cluster — SURVEY.md §4.4) and with x64
enabled, since correctness oracles are double precision like the reference.
Must run before the first ``import jax`` in any test module.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Tests are CPU-only by design (f64 oracles); pin the config as well as the
# environment in case the interpreter was started with another platform.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache, READ-ONLY: the suite is compile-bound (many
# 53-DOF jit shapes), so reads from a previously warmed cache make reruns
# start faster. Writes stay disabled: the PjRt executable.serialize() call
# inside the cache write path segfaulted once mid-suite on the XLA:CPU
# backend (flaky, not reproducible in isolation — jax 0.9.0), and for a
# single fresh-environment suite run writes only cost time anyway. Warm the
# cache explicitly (run the suite with JAX_TEST_CACHE_WRITES=1) if iterating
# locally.
from slam_uwv_kalman_filters_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache(writes=os.environ.get("JAX_TEST_CACHE_WRITES") == "1")
