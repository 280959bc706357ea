"""Delayed-state ring buffer — ``pose_estimation::DelayedStates<T>`` as a
jit-safe fixed-size pytree.

The reference declares the buffer for out-of-sequence XY-position fusion
(``/root/reference/src/PoseUKF.hpp:19,197``; API ``pushState`` /
``getClosestState`` / ``fromSeconds`` used at ``src/PoseUKF.cpp:470-472,
660-662``). This implementation is a circular buffer over static shapes:
``push`` is a ``dynamic_update_slice``, lookup is an argmin over timestamp
distance with validity masking — no dynamic allocation, so it lives happily
inside jitted, vmapped filter loops.

Timestamps are integer ticks whose width follows the runtime's x64 setting:
int64 **microseconds** with x64 enabled (bit-parity with the reference's
``fromSeconds``), int64-unavailable runtimes (the f32 accelerator deployment path)
use int32 **milliseconds** — still ~24 days before wraparound versus ~36
minutes if microseconds were kept. All durations must flow through
:func:`from_seconds`, which keeps callers unit-agnostic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DelayedStates", "make_buffer", "push", "closest", "from_seconds", "ticks_per_second"]


def _ts_dtype():
    """int64 when available, else int32 (canonicalize_dtype respects both the
    global x64 flag and enable/disable_x64 contexts)."""
    return jax.dtypes.canonicalize_dtype(jnp.int64)


def ticks_per_second() -> int:
    """Integer ticks per second: 1e6 (µs, reference parity) with x64; 1e3
    (ms) on 32-bit-only runtimes so int32 timestamps wrap after ~24 days."""
    return 1_000_000 if _ts_dtype() == jnp.int64 else 1_000


def from_seconds(seconds) -> jax.Array:
    """``DelayedStates::fromSeconds`` — seconds → integer timestamp ticks
    (see module docstring for the tick unit).

    Concrete host values (python floats, numpy, non-traced arrays) convert in
    float64 regardless of the x64 flag — under x32, routing the product
    through float32 loses millisecond exactness past ~4.6 h of mission time
    (s·1000 exceeds float32's 2²⁴ exact-integer range) and drifts to ±121 ms
    near the ~24-day wraparound horizon. Traced values split whole/fractional
    seconds so the ×1000 products stay exact to the input's own resolution."""
    tps = ticks_per_second()
    dt = _ts_dtype()
    if not isinstance(seconds, jax.core.Tracer):
        ticks = np.round(np.asarray(seconds, np.float64) * tps).astype(np.int64)
        return jnp.asarray(ticks, dt)
    s = jnp.asarray(seconds)
    whole = jnp.floor(s)
    return jnp.asarray(whole, dt) * tps + jnp.asarray(jnp.round((s - whole) * tps), dt)


class DelayedStates(NamedTuple):
    timestamps: jax.Array  # (N,) integer ticks (from_seconds units)
    values: jax.Array  # (N, d)
    covs: jax.Array  # (N, d, d)
    head: jax.Array  # () int32 — next write slot
    count: jax.Array  # () int32 — valid entries (≤ N)
    max_delay_us: jax.Array  # () ticks — maximum accepted measurement delay


def make_buffer(capacity: int, dim: int, maximum_delay: float, dtype=jnp.float64) -> DelayedStates:
    """Fixed-capacity buffer; ``maximum_delay`` in seconds mirrors the
    reference ``setupDelayedStateBuffer`` argument (``src/PoseUKF.hpp:130-133``)."""
    return DelayedStates(
        timestamps=jnp.zeros(capacity, _ts_dtype()),
        values=jnp.zeros((capacity, dim), dtype),
        covs=jnp.zeros((capacity, dim, dim), dtype),
        head=jnp.zeros((), jnp.int32),
        count=jnp.zeros((), jnp.int32),
        max_delay_us=from_seconds(abs(maximum_delay)),
    )


def _as_buffer_ticks(buf: DelayedStates, ts_us) -> jax.Array:
    """Reject integer timestamps of a different width instead of silently
    casting: a buffer built under one x64 setting holds µs-int64 (or ms-int32)
    ticks, and a ``from_seconds`` result from the other setting is in a
    DIFFERENT UNIT — an int64→int32 cast would also wrap modulo 2³², making
    ``closest`` fuse against an arbitrary entry. Dtypes are static under
    tracing, so raising here is jit-safe."""
    ts = jnp.asarray(ts_us)
    if jnp.issubdtype(ts.dtype, jnp.integer) and ts.dtype != buf.timestamps.dtype:
        raise TypeError(
            f"timestamp dtype {ts.dtype} does not match the buffer's tick dtype "
            f"{buf.timestamps.dtype}; the buffer was created under a different "
            f"x64 setting (int64 µs vs int32 ms ticks) — rebuild it, or produce "
            f"the timestamp with from_seconds under the current setting"
        )
    return ts.astype(buf.timestamps.dtype)


def push(buf: DelayedStates, ts_us: jax.Array, value: jax.Array, cov: jax.Array) -> DelayedStates:
    """``pushState(ts, state, cov)`` — overwrite the oldest slot."""
    i = buf.head
    n = buf.timestamps.shape[0]
    return buf._replace(
        timestamps=buf.timestamps.at[i].set(_as_buffer_ticks(buf, ts_us)),
        values=buf.values.at[i].set(value),
        covs=buf.covs.at[i].set(cov),
        head=(i + 1) % n,
        count=jnp.minimum(buf.count + 1, n),
    )


def closest(buf: DelayedStates, ts_us: jax.Array):
    """``getClosestState(ts)`` → (value, cov, found).

    found is False when the buffer is empty or the nearest entry is farther
    than ``max_delay_us`` from the requested timestamp (the reference returns
    false when the delay exceeds the configured maximum).
    """
    n = buf.timestamps.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < buf.count  # slots written at least once (head wraps ⇒ all valid)
    dist = jnp.abs(buf.timestamps - _as_buffer_ticks(buf, ts_us))
    big = jnp.iinfo(buf.timestamps.dtype).max
    dist = jnp.where(valid, dist, big)
    best = jnp.argmin(dist)
    found = (buf.count > 0) & (dist[best] <= buf.max_delay_us)
    return buf.values[best], buf.covs[best], found
