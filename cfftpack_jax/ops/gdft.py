"""Generalized DFT with fractional time/frequency shifts.

Analog of the reference's GDFT (cfftextra.c:397-479): the
shifted transform factorizes as pre-ramp * FFT * post-ramp,

    gdft(x, a, b)[k] = scale * sum_j x[j] e^{-2i pi (j+a)(k+b)/n}
                     = scale * e^{-2i pi a b / n} * e^{-2i pi a k / n}
                       * DFT[ x_j e^{-2i pi j b / n} ][k]

``a`` shifts the time grid, ``b`` the frequency grid (the reference's
gdft_create(size, a, b) maps to exponent (j+b_ref)(k+a_ref); our (a, b)
= its (b_ref, a_ref)).  FFTPACK norm scales the forward by 1/n.

NOTE: the reference's gdft_inverse is BROKEN for a_ref != 0 — its final
time-ramp multiply uses the unconjugated table (cfftextra.c:474-478), so
inverse(forward(x)) != x (verified numerically: max err ~2.6 at
a=0.5, n=8).  ``igdft`` here is the true inverse; we do not reproduce
that bug.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_NORM, check_norm, complex_dtype_of, fwd_scale, \
    hp_route, inv_scale
from .cfft import _apply_axis, _dft_last_axis, _hp_last_axis

__all__ = ["gdft", "igdft", "gdft_split", "igdft_split"]


def _ramps(n: int, a: float, b: float):
    j = np.arange(n)
    pre = np.exp(-2j * np.pi * j * b / n)
    post = np.exp(-2j * np.pi * (j * a + a * b) / n)
    return pre, post


def _gdft_core(x, n: int, a: float, b: float, inverse: bool):
    cdtype = complex_dtype_of(x.dtype)
    x = x.astype(cdtype)
    pre, post = _ramps(n, a, b)
    if inverse:
        # conj of forward composition: x_j = sum_k y_k e^{+2i pi (j+a)(k+b)/n}
        y = x * jnp.asarray(np.conj(post), dtype=cdtype)
        y = _dft_last_axis(y, n, inverse=True)
        return y * jnp.asarray(np.conj(pre), dtype=cdtype)
    y = x * jnp.asarray(pre, dtype=cdtype)
    y = _dft_last_axis(y, n, inverse=False)
    return y * jnp.asarray(post, dtype=cdtype)


def _gdft_impl(x, a: float, b: float, axis: int, norm: str, inverse: bool):
    x = jnp.asarray(x)
    n = x.shape[axis]
    y = _apply_axis(x, axis,
                    partial(_gdft_core, n=n, a=a, b=b, inverse=inverse))
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        y = y * jnp.asarray(s, dtype=y.dtype)
    return y


_gdft_jit = jax.jit(_gdft_impl, static_argnums=(1, 2, 3, 4, 5))


def gdft(x, a: float = 0.0, b: float = 0.0, axis: int = -1,
         norm: str = DEFAULT_NORM):
    """Generalized DFT: y[k] = scale * sum_j x[j] e^{-2i pi (j+a)(k+b)/n}.

    f64/complex128 input under config.set_f64_policy("hp") routes to
    the double-float engine (numpy out) — see ops.cfft.fft.
    """
    if hp_route(x):
        from .hp import gdft_hp
        return _hp_last_axis(gdft_hp, x, axis, a=float(a), b=float(b),
                             norm=norm)
    return _gdft_jit(x, float(a), float(b), axis, check_norm(norm), False)


def igdft(x, a: float = 0.0, b: float = 0.0, axis: int = -1,
          norm: str = DEFAULT_NORM):
    """True inverse of :func:`gdft` (unlike the reference's, see module
    docstring): igdft(gdft(x, a, b), a, b) == x for every norm."""
    if hp_route(x):
        from .hp import igdft_hp
        return _hp_last_axis(igdft_hp, x, axis, a=float(a), b=float(b),
                             norm=norm)
    return _gdft_jit(x, float(a), float(b), axis, check_norm(norm), True)


def shifted_dft_padded(x, n: int, m: int, a: float, b: float, nout: int):
    """U[k] = sum_{j<n} x[j] e^{-2i pi (j+a)(k+b)/m}, k = 0..nout-1.

    The workhorse behind the odd DCT/DST types V-VIII (the reference
    builds these from zero-padded rfft/gdft of length 2N+-1,
    cfftextra.c:481-958): zero-pad to m, pre/post phase ramps around one
    length-m mixed-radix FFT.
    """
    cdtype = complex_dtype_of(x.dtype)
    x = x.astype(cdtype)
    j = np.arange(m)
    pre = np.exp(-2j * np.pi * (j + a) * b / m)
    k = np.arange(nout)
    post = np.exp(-2j * np.pi * k * a / m)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    xp = jnp.pad(x, pad)
    y = xp * jnp.asarray(pre[:m], dtype=cdtype)
    Y = _dft_last_axis(y, m, inverse=False)[..., :nout]
    return Y * jnp.asarray(post, dtype=cdtype)


# ------------------------------------------------- split (re, im) API

def _gdft_split_impl(xr, xi, a: float, b: float, axis: int, norm: str,
                     inverse: bool):
    from . import core
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    if xr.shape != xi.shape:
        raise ValueError("re/im shapes differ")
    if not jnp.issubdtype(xr.dtype, jnp.floating):
        xr = xr.astype(jnp.promote_types(xr.dtype, jnp.float32))
    elif jnp.finfo(xr.dtype).bits < 32:   # bf16/f16 twiddles lose ~1e-2
        xr = xr.astype(jnp.float32)
    if xi.dtype != xr.dtype:
        xi = xi.astype(xr.dtype)
    n = xr.shape[axis]
    axis = axis % xr.ndim
    move = axis != xr.ndim - 1
    if move:
        xr = jnp.moveaxis(xr, axis, -1)
        xi = jnp.moveaxis(xi, axis, -1)
    pre, post = _ramps(n, a, b)
    if inverse:
        pre, post = np.conj(pre), np.conj(post)
    tr = jnp.asarray((post if inverse else pre).real, dtype=xr.dtype)
    ti = jnp.asarray((post if inverse else pre).imag, dtype=xr.dtype)
    ar = xr * tr - xi * ti
    ai = xr * ti + xi * tr
    yr, yi = core.sfft(ar, ai, n, inverse)
    tr2 = jnp.asarray((pre if inverse else post).real, dtype=xr.dtype)
    ti2 = jnp.asarray((pre if inverse else post).imag, dtype=xr.dtype)
    zr = yr * tr2 - yi * ti2
    zi = yr * ti2 + yi * tr2
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        zr = zr * s
        zi = zi * s
    if move:
        zr = jnp.moveaxis(zr, -1, axis)
        zi = jnp.moveaxis(zi, -1, axis)
    return zr, zi


_gdft_split_jit = jax.jit(_gdft_split_impl, static_argnums=(2, 3, 4, 5, 6))


def gdft_split(xr, xi, a: float = 0.0, b: float = 0.0, axis: int = -1,
               norm: str = DEFAULT_NORM):
    """Generalized DFT on an (re, im) pair."""
    return _gdft_split_jit(xr, xi, float(a), float(b), axis,
                           check_norm(norm), False)


def igdft_split(xr, xi, a: float = 0.0, b: float = 0.0, axis: int = -1,
                norm: str = DEFAULT_NORM):
    return _gdft_split_jit(xr, xi, float(a), float(b), axis,
                           check_norm(norm), True)
