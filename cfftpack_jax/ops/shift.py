"""Spectrum shifts: fftshift / ifftshift (even and odd lengths).

Golden-verified equal to the reference's rotation code
(cfftextra.c:84-130), which matches numpy semantics: fftshift rolls by
+n//2 (DC to center), ifftshift rolls by -(n//2) == +((n+1)//2); for
odd n the two differ.  Implemented as jnp.roll — a single XLA
collective-permute-friendly rotation rather than the reference's
element-by-element swap loop.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import hp_route

__all__ = ["fftshift", "ifftshift"]


def _as_backend(x):
    """f64 under the "hp" policy stays a host array (jnp.asarray would
    truncate to f32 without x64; the roll is a pure permutation either
    way)."""
    return np.asarray(x) if hp_route(x) else jnp.asarray(x)


def fftshift(x, axes=None):
    x = _as_backend(x)
    xp = np if isinstance(x, np.ndarray) else jnp
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    for ax in axes:
        x = xp.roll(x, x.shape[ax] // 2, axis=ax)
    return x


def ifftshift(x, axes=None):
    x = _as_backend(x)
    xp = np if isinstance(x, np.ndarray) else jnp
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    for ax in axes:
        x = xp.roll(x, -(x.shape[ax] // 2), axis=ax)
    return x
