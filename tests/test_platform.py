"""``utils/platform``: the one place that points JAX's persistent
compilation cache somewhere."""

import jax
import pytest

from slam_uwv_kalman_filters_tpu.utils import platform


def test_compile_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_repo_root(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert platform.compile_cache_dir() == os.path.join(root, ".jax_cache")


@pytest.mark.parametrize("writes,min_secs", [(True, 1.0), (False, 1e9)])
def test_enable_compile_cache_write_policy(monkeypatch, tmp_path, writes, min_secs):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    try:
        assert platform.enable_compile_cache(writes=writes) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == min_secs
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])
