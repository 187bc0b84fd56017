"""Timing and compile-cache helpers."""
import numpy as np
import jax
import jax.numpy as jnp

from qutlass_tpu import profiling
from qutlass_tpu.profiling import setup_compile_cache, time_fn, tflops


def test_time_fn_quantiles_ordered():
    x = jnp.ones((64, 128), jnp.float32)
    f = jax.jit(lambda a: a @ a.T)
    out = time_fn(f, x, warmup=1, repeats=5)
    assert len(out["runs"]) == 5
    assert all(np.isfinite(t) and t > 0 for t in out["runs"])
    assert out["q20"] <= out["q50"] <= out["q80"]


def test_time_fn_blocks_on_result():
    calls = []

    def f(a):
        calls.append(1)
        return a + 1

    time_fn(f, jnp.zeros((4,)), warmup=2, repeats=3)
    assert len(calls) == 5


def test_tflops_convention():
    assert tflops(1024, 1024, 1024, 1e-3) == 2 * 1024 ** 3 / 1e-3 / 1e12


def test_compile_cache_env_wins(monkeypatch):
    """A set JAX_COMPILATION_CACHE_DIR is used as is, and nothing is
    written to JAX's config."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    before = jax.config.jax_compilation_cache_dir
    assert setup_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = setup_compile_cache()
        assert path == profiling.REPO_ROOT + "/.jax_cache"
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
