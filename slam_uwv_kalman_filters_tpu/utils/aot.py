"""Ahead-of-time exported filter steps — no tracing at mission start.

A 100 Hz online estimator host cannot absorb seconds of jit at mission
start. ``jax.export`` serializes the traced-and-lowered StableHLO of a
jitted step to bytes once, at integration time; the vehicle host
deserializes and calls it with no Python tracing/lowering and none of the
model code in the loop, with outputs equal to the jitted call. Pair with a
persistent compilation cache (``utils/platform.enable_compile_cache``) to
also skip the backend compile across process restarts.

The reference has no analogue (a C++ library is its own AOT artifact); this
is the equivalent of shipping the compiled shared object.

Notes:

* An export is specific to the platform it was lowered for (cpu/cuda) and to
  the argument shapes/dtypes — export per deployment configuration.
* :func:`export_step` and calling the ``Exported`` need only jax; turning
  it into bytes (:func:`serialize`, :func:`save`, and reading them back)
  needs the ``flatbuffers`` package (the ``aot`` extra).
* NamedTuple pytrees (filter states, ``PoseInputs``) serialize through
  ``jax.export.register_namedtuple_serialization`` — :func:`export_step`
  registers any NamedTuple classes of its arguments and results.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
from jax import export as jexport

__all__ = ["export_step", "serialize", "deserialize", "save", "load"]


def _register_namedtuples(tree: Any) -> None:
    """Register every NamedTuple class appearing in ``tree`` for export
    serialization (idempotent; named by their import path)."""
    seen = set()

    def walk(x):
        cls = type(x)
        if isinstance(x, tuple) and hasattr(cls, "_fields") and cls not in seen:
            seen.add(cls)
            try:
                jexport.register_namedtuple_serialization(
                    cls, serialized_name=f"{cls.__module__}.{cls.__qualname__}"
                )
            except ValueError:
                pass  # already registered
            for child in x:
                walk(child)
        elif isinstance(x, (tuple, list)):
            for child in x:
                walk(child)
        elif isinstance(x, dict):
            for child in x.values():
                walk(child)

    walk(tree)


def export_step(fn: Callable, *example_args: Any) -> jexport.Exported:
    """Trace + lower ``fn`` (jitted automatically if it is not already) for
    the current default platform at ``example_args``'s shapes and return the
    ``Exported`` artifact."""
    jitted = fn if isinstance(fn, jax.stages.Wrapped) else jax.jit(fn)
    _register_namedtuples((example_args, jax.eval_shape(jitted, *example_args)))
    return jexport.export(jitted)(*example_args)


def serialize(exported: jexport.Exported) -> bytes:
    return bytes(exported.serialize())


def deserialize(blob: bytes) -> Callable:
    """Bytes → a callable running the pre-compiled step (no tracing)."""
    exported = jexport.deserialize(blob)
    return exported.call


def save(path: str, exported: jexport.Exported) -> None:
    with open(path, "wb") as f:
        f.write(exported.serialize())


def load(path: str) -> Callable:
    with open(path, "rb") as f:
        return deserialize(f.read())
