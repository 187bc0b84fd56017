"""Timing, tracing and compile-cache helpers.

The reference measures with triton's ``do_bench`` (benchmarks/
bench_mxfp4_sm120.py:109-125), which reports the 0.2/0.5/0.8 quantiles
of warmed runs.  :func:`time_fn` does the same for a JAX callable:
warm it (compiling every shape first), then time each run up to
``block_until_ready``.  TFLOP/s convention matches the reference:
2*M*N*K / t.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``<repo>/.jax_cache``
    — a fixed path, since the path is part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def time_fn(fn, *args, warmup: int = 2, repeats: int = 10,
            quantiles=(0.2, 0.5, 0.8)) -> dict:
    """Seconds per call of ``fn(*args)`` on the device.

    ``fn`` should be jitted.  Each timed call ends in
    ``block_until_ready`` on its result, so the time covers the device
    work and not only the enqueue.  Returns the quantiles (keys ``q20``,
    ``q50``, ``q80`` for the defaults) and every run's time (``runs``).
    """
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    out = {f"q{int(round(q * 100))}": float(np.quantile(runs, q))
           for q in quantiles}
    out["runs"] = runs
    return out


def tflops(m: int, n: int, k: int, seconds: float) -> float:
    """Reference TFLOP/s convention (bench_mxfp4_sm120.py:127-128)."""
    return 2 * m * n * k / seconds / 1e12


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
