"""Observability: profiler traces and cost accounting.

The reference's observability surface is the EvalCounter + per-parameter wall
times logged by its HDF5 sweep (SURVEY.md §5).  Here that carries over (eval
counts are native loop-state, wall times recorded by ``batchsolve_h5``) and is
extended with JAX profiler traces for XLA-level analysis.
"""
from __future__ import annotations

import contextlib
import os
import time


# the checkout root: the cache directory's default when
# JAX_COMPILATION_CACHE_DIR is unset (a fixed path, since the path is part of
# the cache key)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir():
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache():
    """Persist XLA executables across processes in :func:`compile_cache_dir`
    (JAX's own default minimum compile time decides what is written).  Safe
    to call more than once; returns the cache directory."""
    import jax

    cache_dir = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


@contextlib.contextmanager
def trace(logdir="/tmp/autobz_trace"):
    """Capture a jax.profiler trace of the enclosed block (view with
    TensorBoard or xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label, sink=None):
    """Wall-clock a block; append (label, seconds) to ``sink`` if given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
