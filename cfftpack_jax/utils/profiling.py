"""Tracing/profiling hooks (SURVEY.md §5: the reference has only ad-hoc
clock() timing; here we expose jax.profiler traces + a roofline helper).
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(logdir: str = "/tmp/cfftpack_jax_trace"):
    """Capture a jax.profiler trace around a block.

    View with TensorBoard or xprof:  with trace("/tmp/t"): fn(x)
    """
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock block timer with device synchronization."""

    def __init__(self, sync=None):
        self._sync = sync
        self.seconds = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            import jax
            jax.block_until_ready(self._sync)
        self.seconds = time.perf_counter() - self._t0
        return False
