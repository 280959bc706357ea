"""Sharding of filter banks over a device mesh.

SURVEY.md §2.4: the bank axis is embarrassingly parallel, so the natural
mapping is a 1-D ``bank`` mesh axis over every device — per-instance steps
run with zero communication, and XLA inserts collectives only at the
ensemble-statistics reduction points exposed here. This replaces the comm
backend the reference never had (it ran one filter per process).

Design notes (jax-ml.github.io/scaling-book recipe): pick a mesh, annotate
shardings on the inputs, let XLA propagate and insert collectives, profile.
There is no model/tensor axis worth sharding for 53-DOF filters — one
instance's 107×53 sigma work is tiny, so intra-filter parallelism stays
*within* a device (batched matmuls) and cross-device scaling is pure data
parallelism over the bank. The mesh follows the algorithm, not the
interconnect: a second axis would only add latency.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.linalg_small import mm

__all__ = [
    "init_multihost",
    "make_mesh",
    "bank_sharding",
    "shard_bank",
    "shard_time_bank",
    "replicated",
    "ensemble_mean",
    "ensemble_moments",
    "acceptance_rate",
    "with_bank_constraint",
    "bank_shard_map",
    "mission_shard_map",
]

BANK_AXIS = "bank"


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join a multi-process group (the NCCL/MPI-init analogue the reference
    never had, SURVEY.md §2.4). Pass all three arguments for a multi-process
    job: nothing in the environment tells JAX of a cluster, and a failed
    bootstrap raises — silently continuing would leave each process computing
    an independent full bank (all reporting process_index 0, so sharded
    checkpoints on shared storage overwrite each other). With no arguments
    this is a single-process run and no group is formed. After joining,
    ``jax.devices()`` spans every process's devices and ``make_mesh()``
    builds the global 1-D bank mesh. Returns the process index. Idempotent."""
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return jax.process_index()
    if coordinator_address is None and num_processes is None and process_id is None:
        return jax.process_index()
    jax.distributed.initialize(coordinator_address, num_processes, process_id)
    return jax.process_index()


def make_mesh(devices: Optional[Sequence[jax.Device]] = None, axis: str = BANK_AXIS) -> Mesh:
    """1-D device mesh over all (or given) devices; works identically for one
    device, one host, or several processes (jax.distributed process mesh)."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def bank_sharding(mesh: Mesh, axis: str = BANK_AXIS) -> NamedSharding:
    """Shard the leading (bank) dimension, replicate everything else."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_bank(tree: Any, mesh: Mesh, axis: str = BANK_AXIS) -> Any:
    """Place a bank pytree with its leading axis sharded over the mesh."""
    sh = bank_sharding(mesh, axis)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def _time_bank_spec(x, bank_n: int, axis: str) -> P:
    """Axis 1 of a time-major (T, bank, ...) leaf, or replicated for a
    per-tick value the bank shares."""
    return P(None, axis) if x.ndim >= 2 and x.shape[1] == bank_n else P()


def shard_time_bank(inputs: Any, mesh: Mesh, bank_n: int, axis: str = BANK_AXIS) -> Any:
    """Place time-major (T, bank, ...) mission inputs on the mesh: a leaf
    whose axis 1 is the bank (``bank_n`` long) is sharded on that axis, and
    a per-tick value shared by the bank (flags, covariances, the interval)
    is replicated; a shared leaf that happens to be ``bank_n`` long on axis 1
    is sharded too, which changes its layout, not its values. These are the
    input specs of :func:`mission_shard_map`."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, _time_bank_spec(x, bank_n, axis))),
        inputs,
    )


def with_bank_constraint(tree: Any, mesh: Mesh, axis: str = BANK_AXIS) -> Any:
    """In-jit sharding constraint pinning the bank layout (keeps XLA from
    resharding between predict/update phases)."""
    sh = bank_sharding(mesh, axis)
    return jax.tree_util.tree_map(lambda a: jax.lax.with_sharding_constraint(a, sh), tree)


# ---------------------------------------------------------------------------
# ensemble-statistics reduction points (the only cross-chip communication)
# ---------------------------------------------------------------------------


def _shard_map():
    """``shard_map`` and its keyword that turns replication checking off
    (renamed check_rep → check_vma in jax 0.8); it must be off because steps
    close over replicated parameter pytrees."""
    import inspect

    try:
        from jax import shard_map  # jax >= 0.8
    except ImportError:  # pragma: no cover — older jax
        from jax.experimental.shard_map import shard_map

    if "check_vma" in inspect.signature(shard_map).parameters:
        return shard_map, {"check_vma": False}
    return shard_map, {"check_rep": False}


def bank_shard_map(fn, mesh: Mesh, axis: str = BANK_AXIS):
    """Run a bank→bank step function per-device on its local bank shard.

    Wrapping the step in ``shard_map`` pins every device to its local shard
    with zero communication (the bank axis is embarrassingly parallel,
    SURVEY.md §2.4), whatever the step holds.

    ``fn``'s inputs and outputs must all carry the bank as their leading
    axis (ensemble reductions belong outside the wrapped step)."""
    shard_map, check_kw = _shard_map()

    def wrapped(*bank_args):
        in_specs = jax.tree_util.tree_map(lambda _: P(axis), bank_args)
        out_specs = jax.tree_util.tree_map(
            lambda _: P(axis), jax.eval_shape(fn, *bank_args)
        )
        return shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **check_kw
        )(*bank_args)

    return wrapped


def mission_shard_map(fn, mesh: Mesh, bank_n: int, axis: str = BANK_AXIS):
    """Run a bank mission ``fn(bstate, inputs) -> (bstate, tick_outputs)``
    (``pose_driver.run_trajectory_bank`` with its parameters closed over)
    per device on its local bank shard, inside ``shard_map``.

    The state carries the bank on axis 0; the time-major inputs and tick
    outputs carry it on axis 1, and per-tick values the bank shares are
    replicated (the :func:`shard_time_bank` rule). Each device runs its
    shard's scan with no communication. A plain ``jit`` of the mission over
    a placed bank is not enough on the GPU: the H100 compile all-gathers
    per-instance update values (f32 and bool rows of the masked-update
    ``lax.cond``) between devices, though the same program partitions
    without any on the CPU. Inside, the manifold mean's convergence test
    and each ``lax.cond``'s skip test look at the local shard only, so a
    sharded run can differ from one device at roundoff."""
    shard_map, check_kw = _shard_map()

    def wrapped(bstate, inputs):
        spec = lambda x: _time_bank_spec(x, bank_n, axis)
        out = jax.eval_shape(fn, bstate, inputs)
        in_specs = (
            jax.tree_util.tree_map(lambda _: P(axis), bstate),
            jax.tree_util.tree_map(spec, inputs),
        )
        out_specs = (
            jax.tree_util.tree_map(lambda _: P(axis), out[0]),
            jax.tree_util.tree_map(spec, out[1]),
        )
        return shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **check_kw
        )(bstate, inputs)

    return wrapped


def ensemble_mean(tree: Any) -> Any:
    """Mean over the bank axis — under jit on sharded inputs this lowers to an
    all-reduce across the mesh (the one collective of the steady-state loop)."""
    return jax.tree_util.tree_map(lambda a: a.mean(axis=0), tree)


def ensemble_moments(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(mean, covariance) of a (N, d) bank statistic across instances."""
    mean = x.mean(axis=0)
    centered = x - mean[None]
    cov = mm(centered.T, centered) / x.shape[0]
    return mean, cov


def acceptance_rate(accepted: jax.Array) -> jax.Array:
    """Fraction of bank instances whose last χ²-gated update was applied —
    the gate-rejection observability the reference lacked (SURVEY.md §5)."""
    return accepted.astype(jax.numpy.float32).mean()
