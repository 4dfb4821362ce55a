"""Complex FFT core: mixed-radix Stockham autosort, any length.

Re-design of the reference's complex FFT engine
(``c1fm1f_``/``c1fm1b_`` stage loop, cfftpack/fftpack.c:1931-2142,
radix kernels ``c1f{2,3,4,5,g}k{f,b}_`` fftpack.c:96-1922).

The numerical engine lives in ops/core.py (split-real Stockham
autosort + Bluestein); this module provides the complex-dtype API and
the ``*_split`` pair API over it.  Both run on every backend.

Everything is shape-static, trace-friendly, and vmap/shard_map
compatible: transforms are pure functions over the last axis.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from ..config import (DEFAULT_NORM, check_norm, complex_dtype_of, fwd_scale,
                      hp_route, inv_scale)


def _hp_last_axis(fn, x, axis: int, **kw):
    """Run a last-axis hp-engine transform over ``axis`` of host f64
    data (the opt-in f64->df64 route, config.set_f64_policy("hp");
    numpy in/out)."""
    x = np.asarray(x)
    ax = axis % x.ndim
    if ax != x.ndim - 1:
        x = np.moveaxis(x, ax, -1)
    y = fn(x, **kw)
    if ax != y.ndim - 1:
        y = np.moveaxis(y, -1, ax)
    return y

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "fft_split", "ifft_split", "fft2_split", "ifft2_split"]


def _dft_last_axis(x, n: int, inverse: bool):
    """Unscaled DFT over the last axis — complex boundary over the
    split-real engine (core.py)."""
    from . import core
    yr, yi = core.sfft(jnp.real(x), jnp.imag(x), n, inverse)
    return jax.lax.complex(yr, yi).astype(x.dtype)


def _apply_axis(x, axis: int, fn):
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
    y = fn(x)
    if axis != x.ndim - 1:
        y = jnp.moveaxis(y, -1, axis)
    return y


def _fft_impl(x, axis: int, norm: str, inverse: bool):
    x = jnp.asarray(x)
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for rank-{x.ndim} input")
    cdtype = complex_dtype_of(x.dtype)
    x = x.astype(cdtype)
    n = x.shape[axis]
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    y = _apply_axis(x, axis, partial(_dft_last_axis, n=n, inverse=inverse))
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        y = y * jnp.asarray(s, dtype=cdtype)
    return y


# One compiled executable per (shape, dtype, axis, norm, direction) — the
# analog of the reference's create-once plans (fft_create + wsave,
# cfftpack.c:10-31): planning = trace + XLA compile, cached by jax.jit.
_fft_jit = jax.jit(_fft_impl, static_argnums=(1, 2, 3))


def fft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward complex FFT along ``axis``.

    Default norm="fftpack" scales by 1/N (reference convention,
    cfftpack.h:100-102).  Any length is supported in O(n log n).

    Double input (f64/complex128) runs natively in f64 by default.
    Under config.set_f64_policy("hp") it routes to the double-float
    engine (ops/hp.py) instead and returns host numpy complex128.
    """
    if hp_route(x):
        from .hp import fft_hp
        return _hp_last_axis(fft_hp, x, axis, norm=norm)
    return _fft_jit(x, axis, check_norm(norm), False)


def ifft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse complex FFT along ``axis`` (unscaled under norm="fftpack")."""
    if hp_route(x):
        from .hp import ifft_hp
        return _hp_last_axis(ifft_hp, x, axis, norm=norm)
    return _fft_jit(x, axis, check_norm(norm), True)


def _fftn_core(x, axes, norm: str, inverse: bool):
    y = x
    for ax in axes:
        y = _fft_impl(y, ax, norm, inverse)
    return y


_fftn_jit = jax.jit(_fftn_core, static_argnums=(1, 2, 3))


def _fftn_impl(x, axes, norm: str, inverse: bool):
    if hp_route(x):
        from .hp import fft2_hp, fft_hp, ifft2_hp, ifft_hp
        x = np.asarray(x)
        if axes is None:
            axes = tuple(range(x.ndim))
        axes = tuple(int(a) % x.ndim for a in axes)
        if x.ndim >= 2 and axes == (x.ndim - 2, x.ndim - 1):
            return (ifft2_hp if inverse else fft2_hp)(x, norm=norm)
        y = x
        for ax in axes:
            y = _hp_last_axis(ifft_hp if inverse else fft_hp, y, ax,
                              norm=norm)
        return y
    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    return _fftn_jit(x, tuple(int(a) for a in axes), norm, inverse)


def fft2(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D FFT, row-column order (the analog of cfft2f_,
    fftpack.c:2363-2434, which runs batched 1-D passes per axis)."""
    return _fftn_impl(x, axes, check_norm(norm), inverse=False)


def ifft2(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    return _fftn_impl(x, axes, check_norm(norm), inverse=True)


def fftn(x, axes=None, norm: str = DEFAULT_NORM):
    return _fftn_impl(x, axes, check_norm(norm), inverse=False)


def ifftn(x, axes=None, norm: str = DEFAULT_NORM):
    return _fftn_impl(x, axes, check_norm(norm), inverse=True)


# ------------------------------------------------- split (re, im) API
# Pairs of real arrays in, pairs out: the engine's own layout.

def _fft_split_impl(xr, xi, axis: int, norm: str, inverse: bool):
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
    yr, yi = core.sfft(xr, xi, n, inverse)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        yr = yr * s
        yi = yi * s
    if move:
        yr = jnp.moveaxis(yr, -1, axis)
        yi = jnp.moveaxis(yi, -1, axis)
    return yr, yi


_fft_split_jit = jax.jit(_fft_split_impl, static_argnums=(2, 3, 4))


def fft_split(xr, xi, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward FFT on an (re, im) pair of real arrays."""
    return _fft_split_jit(xr, xi, axis, check_norm(norm), False)


def ifft_split(xr, xi, axis: int = -1, norm: str = DEFAULT_NORM):
    return _fft_split_jit(xr, xi, axis, check_norm(norm), True)


def _fft2_split_core(xr, xi, axes, norm: str, inverse: bool):
    for ax in axes:
        xr, xi = _fft_split_impl(xr, xi, ax, norm, inverse)
    return xr, xi


_fft2_split_jit = jax.jit(_fft2_split_core, static_argnums=(2, 3, 4))


def fft2_split(xr, xi, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D forward FFT on an (re, im) pair of real arrays.

    Row-column order over ``axes``, matching :func:`fft2` (the
    analog of cfft2f_, cfftpack/fftpack.c:2363-2434);
    norm is applied per axis exactly as fft2 does.  Sharded multi-device
    variant: parallel/fft2d.fft2_sharded_split.
    """
    return _fft2_split_jit(xr, xi, tuple(int(a) for a in axes),
                           check_norm(norm), False)


def ifft2_split(xr, xi, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse of :func:`fft2_split` (fft2c_ analog)."""
    return _fft2_split_jit(xr, xi, tuple(int(a) for a in axes),
                           check_norm(norm), True)
