"""Plan/compilation persistence (SURVEY.md §5 checkpoint/resume analog).

The reference's create-once/use-many plan (`fft_t` + wsave twiddles)
maps to two caches here: host-side plan tables (plan.py lru_caches,
recomputable in microseconds) and XLA compiled executables — the
expensive part.  ``enable_compilation_cache`` persists compiled
programs across processes so a restarted job skips recompilation.
"""
from __future__ import annotations

import os

__all__ = ["compilation_cache_dir", "enable_compilation_cache",
           "warm_plans"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, inside the checkout: the cache key includes the path, so a
# directory that moves between runs never hits
_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir(environ=os.environ) -> str:
    """Where compiled programs persist: ``$JAX_COMPILATION_CACHE_DIR``
    when it is set, else ``.jax_cache/`` at the root of the checkout."""
    return environ.get(_ENV) or _CHECKOUT_CACHE


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and return that directory."""
    import jax
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def warm_plans(sizes, with_twiddles: bool = True):
    """Precompute host plan tables for the given transform lengths
    (factorization, per-stage twiddles, Bluestein tables where needed) —
    the analog of calling fft_create ahead of time."""
    from .. import plan
    for n in sizes:
        plan.factor(n)
        if with_twiddles:
            plan.stage_twiddles(n)
            if plan.needs_bluestein(n):
                plan.bluestein_tables(n)
