"""Frequency-grid helpers and spectral convolution.

Conveniences the reference leaves to callers (every app rebuilds
``u = i*du`` grids by hand, e.g. vargamma.c:80, vg_mc.cpp:55): numpy-
compatible fftfreq/rfftfreq and an FFT circular convolution.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import DEFAULT_NORM, hp_route
from .cfft import fft, ifft
from .rfft import rfft, irfft

__all__ = ["fftfreq", "rfftfreq", "circular_convolve"]


def fftfreq(n: int, d: float = 1.0):
    """Sample frequencies for fft output (numpy semantics)."""
    k = np.empty(n, dtype=np.float64)
    pos = (n - 1) // 2 + 1
    k[:pos] = np.arange(pos)
    k[pos:] = np.arange(-(n // 2), 0)
    return jnp.asarray(k / (n * d))


def rfftfreq(n: int, d: float = 1.0):
    """Sample frequencies for rfft output (numpy semantics)."""
    return jnp.asarray(np.arange(n // 2 + 1) / (n * d))


def circular_convolve(a, b, axis: int = -1):
    """Circular convolution along ``axis`` via the spectral theorem.

    With the fftpack norm (forward 1/N), conv = N * ifft(fft(a)*fft(b));
    handled internally so the result equals the direct circular sum.
    Real inputs use the r2c path (half the transforms).
    """
    if hp_route(a, b):
        # f64 under the "hp" policy: stay on host so the transforms
        # route to the double-float engine (see config.hp_route)
        a = np.asarray(a)
        b = np.asarray(b)
    else:
        a = jnp.asarray(a)
        b = jnp.asarray(b)
    n = a.shape[axis]
    if b.shape[axis] != n:
        raise ValueError("circular_convolve: axis lengths differ")
    real = not (np.iscomplexobj(a) or np.iscomplexobj(b))
    if real:
        fa = rfft(a, axis=axis, norm=DEFAULT_NORM)
        fb = rfft(b, axis=axis, norm=DEFAULT_NORM)
        return irfft(fa * fb, n, axis=axis, norm=DEFAULT_NORM) * n
    fa = fft(a, axis=axis, norm=DEFAULT_NORM)
    fb = fft(b, axis=axis, norm=DEFAULT_NORM)
    return ifft(fa * fb, axis=axis, norm=DEFAULT_NORM) * n
