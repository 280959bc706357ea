"""Process-level JAX settings shared by every entry point.

:func:`enable_compile_cache` is the one place that points JAX's persistent
compilation cache somewhere: ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, otherwise ``.jax_cache/`` at the repository root (a fixed path — the
cache key includes it, so a directory that moves never hits).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_REPO_ROOT / ".jax_cache")


def enable_compile_cache(*, writes: bool = True) -> str:
    """Turn on the persistent compilation cache at :func:`compile_cache_dir`
    and return that directory. ``writes=False`` keeps it read-only (no
    executable is put unless it compiled for over 1e9 s)."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0 if writes else 1e9)
    return path
