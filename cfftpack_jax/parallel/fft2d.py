"""Sharded 2-D FFT: row-column with an all-to-all transpose.

Distributed analog of the reference's 2-D driver (cfft2f_,
fftpack.c:2363-2434: batched 1-D passes per axis, the second pass
reading with stride ldim).  Here rows are sharded over the mesh; the
strided second pass becomes one all-to-all.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULT_NORM, check_norm, complex_dtype_of, fwd_scale, \
    inv_scale
from ..ops.cfft import _dft_last_axis

__all__ = ["fft2_sharded", "ifft2_sharded", "fft2_sharded_split",
           "ifft2_sharded_split", "rfft2_sharded", "irfft2_sharded",
           "rfft2_sharded_split", "irfft2_sharded_split"]


def _core(blk, n0, n1, inverse, axis_name):
    """blk: local (..., n0/D, n1) block, rows sharded."""
    a = _dft_last_axis(blk, n1, inverse)          # row FFTs (local)
    # transpose via all-to-all: shard columns, gather rows
    a = _a2a_fwd(a, axis_name)
    a = jnp.swapaxes(a, -1, -2)                    # (..., n1/D, n0)
    a = _dft_last_axis(a, n0, inverse)             # column FFTs (local)
    a = jnp.swapaxes(a, -1, -2)                    # (..., n0, n1/D)
    a = _a2a_back(a, axis_name)
    return a                                       # (..., n0/D, n1)


def _fft2_sharded(x, mesh, axis_name, inverse, norm, batch_axis_name=None):
    x = jnp.asarray(x)
    cdtype = complex_dtype_of(x.dtype)
    x = x.astype(cdtype)
    n0, n1 = x.shape[-2], x.shape[-1]
    d = mesh.shape[axis_name]
    if n0 % d or n1 % d:
        raise ValueError(f"2-D shape ({n0},{n1}) must be divisible by mesh size {d}")
    lead = len(x.shape[:-2])
    ls = [None] * lead
    if batch_axis_name is not None and lead:
        ls[0] = batch_axis_name
    fs = shard_map(
        partial(_core, n0=n0, n1=n1, inverse=inverse, axis_name=axis_name),
        mesh=mesh,
        in_specs=P(*ls, axis_name, None),
        out_specs=P(*ls, axis_name, None),
    )
    y = fs(x)
    s = (inv_scale(norm, n0) * inv_scale(norm, n1) if inverse
         else fwd_scale(norm, n0) * fwd_scale(norm, n1))
    if s != 1.0:
        y = y * jnp.asarray(s, dtype=cdtype)
    return y


# jit-wrapped entries (see fourstep.py: eager shard_map is 30-60x
# slower than the compiled program and misses the persistent cache)
_fft2_sharded_jit = jax.jit(_fft2_sharded, static_argnums=(1, 2, 3, 4, 5))


def fft2_sharded(x, mesh: Mesh, axis_name: str = "data",
                 norm: str = DEFAULT_NORM,
                 batch_axis_name: str | None = None):
    """2-D FFT over the trailing two axes, rows sharded over the mesh.

    Output is sharded the same way as the input (rows over the mesh)."""
    return _fft2_sharded_jit(x, mesh, axis_name, False, check_norm(norm),
                             batch_axis_name)


def ifft2_sharded(y, mesh: Mesh, axis_name: str = "data",
                  norm: str = DEFAULT_NORM,
                  batch_axis_name: str | None = None):
    return _fft2_sharded_jit(y, mesh, axis_name, True, check_norm(norm),
                             batch_axis_name)


# ------------------------------------------------- split (re, im) API

def _core_pair(br, bi, n0, n1, inverse, axis_name):
    from ..ops import core
    ar, ai = core.sfft(br, bi, n1, inverse)        # rows (local)
    ar, ai = _a2a_fwd(ar, axis_name), _a2a_fwd(ai, axis_name)
    ar = jnp.swapaxes(ar, -1, -2)
    ai = jnp.swapaxes(ai, -1, -2)
    ar, ai = core.sfft(ar, ai, n0, inverse)        # columns (local)
    ar = jnp.swapaxes(ar, -1, -2)
    ai = jnp.swapaxes(ai, -1, -2)
    return _a2a_back(ar, axis_name), _a2a_back(ai, axis_name)


def _fft2_sharded_pair(xr, xi, mesh, axis_name, inverse, norm,
                       batch_axis_name=None):
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    n0, n1 = xr.shape[-2], xr.shape[-1]
    d = mesh.shape[axis_name]
    if n0 % d or n1 % d:
        raise ValueError(f"2-D shape ({n0},{n1}) must be divisible by mesh size {d}")
    lead = xr.ndim - 2
    ls = [None] * lead
    if batch_axis_name is not None and lead:
        ls[0] = batch_axis_name
    fs = shard_map(
        partial(_core_pair, n0=n0, n1=n1, inverse=inverse,
                axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(*ls, axis_name, None), P(*ls, axis_name, None)),
        out_specs=(P(*ls, axis_name, None), P(*ls, axis_name, None)),
    )
    yr, yi = fs(xr, xi)
    s = (inv_scale(norm, n0) * inv_scale(norm, n1) if inverse
         else fwd_scale(norm, n0) * fwd_scale(norm, n1))
    if s != 1.0:
        yr = yr * s
        yi = yi * s
    return yr, yi


_fft2_sharded_pair_jit = jax.jit(_fft2_sharded_pair,
                                 static_argnums=(2, 3, 4, 5, 6))


def fft2_sharded_split(xr, xi, mesh: Mesh, axis_name: str = "data",
                       norm: str = DEFAULT_NORM,
                       batch_axis_name: str | None = None):
    """Sharded 2-D FFT on an (re, im) pair."""
    return _fft2_sharded_pair_jit(xr, xi, mesh, axis_name, False,
                                  check_norm(norm), batch_axis_name)


def ifft2_sharded_split(yr, yi, mesh: Mesh, axis_name: str = "data",
                        norm: str = DEFAULT_NORM,
                        batch_axis_name: str | None = None):
    return _fft2_sharded_pair_jit(yr, yi, mesh, axis_name, True,
                                  check_norm(norm), batch_axis_name)


# ------------------------------------------------- sharded REAL 2-D

def _a2a_fwd(a, axis_name):
    return jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 1,
                              concat_axis=a.ndim - 2, tiled=True)


def _a2a_back(a, axis_name):
    return jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 2,
                              concat_axis=a.ndim - 1, tiled=True)


def _rfft2_core(x, n0, n1, hp, axis_name):
    """Local block (..., n0/D, n1) real -> packed split spectrum
    (..., n0/D, n1//2+1).

    Row pass is the local r2c; the column pass pads the ragged
    (n1//2+1)-bin spectrum axis up to ``hp`` (a multiple of D) so the
    all-to-all transpose tiles evenly — the pad columns are zeros,
    transform to zeros, and are sliced off after the back-transpose.
    Distributed analog of the 2-D real core rfft2f_
    (cfftpack/fftpack.c:13282-13445: rfftm along dim 1,
    cfftm across rows)."""
    from ..ops import core
    h1 = n1 // 2 + 1
    yr, yi = core.srfft(x, n1)                     # rows (local r2c)
    cfg = [(0, 0)] * (yr.ndim - 1) + [(0, hp - h1)]
    yr = jnp.pad(yr, cfg)
    yi = jnp.pad(yi, cfg)
    yr, yi = _a2a_fwd(yr, axis_name), _a2a_fwd(yi, axis_name)
    yr = jnp.swapaxes(yr, -1, -2)                  # (..., hp/D, n0)
    yi = jnp.swapaxes(yi, -1, -2)
    yr, yi = core.sfft(yr, yi, n0, inverse=False)  # columns (local)
    yr = jnp.swapaxes(yr, -1, -2)
    yi = jnp.swapaxes(yi, -1, -2)
    yr, yi = _a2a_back(yr, axis_name), _a2a_back(yi, axis_name)
    return yr[..., :h1], yi[..., :h1]


def _irfft2_core(yr, yi, n0, n1, hp, axis_name):
    """Inverse of _rfft2_core: split spectrum block (..., n0/D,
    n1//2+1) -> real block (..., n0/D, n1).  Returns n0*n1-scaled
    output (both sub-inverses unscaled); norm applied by the caller."""
    from ..ops import core
    h1 = n1 // 2 + 1
    cfg = [(0, 0)] * (yr.ndim - 1) + [(0, hp - h1)]
    yr = jnp.pad(yr, cfg)
    yi = jnp.pad(yi, cfg)
    yr, yi = _a2a_fwd(yr, axis_name), _a2a_fwd(yi, axis_name)
    yr = jnp.swapaxes(yr, -1, -2)
    yi = jnp.swapaxes(yi, -1, -2)
    yr, yi = core.sfft(yr, yi, n0, inverse=True)   # columns (local)
    yr = jnp.swapaxes(yr, -1, -2)
    yi = jnp.swapaxes(yi, -1, -2)
    yr = _a2a_back(yr, axis_name)[..., :h1]
    yi = _a2a_back(yi, axis_name)[..., :h1]
    return core.sirfft(yr, yi, n1)                 # rows (local c2r)


def _rfft2_sharded_pair(x, mesh, axis_name, norm, batch_axis_name=None):
    from ..ops.rfft import _as_real_plane
    x = _as_real_plane(jnp.asarray(x), "rfft2_sharded")
    n0, n1 = x.shape[-2], x.shape[-1]
    d = mesh.shape[axis_name]
    if n0 % d:
        raise ValueError(f"row count {n0} must be divisible by mesh size {d}")
    # pad bins to a multiple of D (a2a tiling); the extra bins
    # transform to zeros and slice off.
    hp = -(-(n1 // 2 + 1) // d) * d
    lead = x.ndim - 2
    ls = [None] * lead
    if batch_axis_name is not None and lead:
        ls[0] = batch_axis_name
    fs = shard_map(
        partial(_rfft2_core, n0=n0, n1=n1, hp=hp, axis_name=axis_name),
        mesh=mesh,
        in_specs=P(*ls, axis_name, None),
        out_specs=(P(*ls, axis_name, None), P(*ls, axis_name, None)),
    )
    yr, yi = fs(x)
    s = fwd_scale(norm, n0) * fwd_scale(norm, n1)
    if s != 1.0:
        yr = yr * s
        yi = yi * s
    return yr, yi


def _irfft2_sharded_pair(yr, yi, n1, mesh, axis_name, norm,
                         batch_axis_name=None):
    yr = jnp.asarray(yr)
    yi = jnp.asarray(yi)
    if yr.shape != yi.shape:
        raise ValueError("re/im shapes differ")
    n0 = yr.shape[-2]
    if yr.shape[-1] != n1 // 2 + 1:
        raise ValueError(
            f"irfft2_sharded: spectrum axis has {yr.shape[-1]} bins, "
            f"expected n1//2+1 = {n1 // 2 + 1} for n1={n1}")
    d = mesh.shape[axis_name]
    if n0 % d:
        raise ValueError(f"row count {n0} must be divisible by mesh size {d}")
    hp = -(-(n1 // 2 + 1) // d) * d
    lead = yr.ndim - 2
    ls = [None] * lead
    if batch_axis_name is not None and lead:
        ls[0] = batch_axis_name
    fs = shard_map(
        partial(_irfft2_core, n0=n0, n1=n1, hp=hp, axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(*ls, axis_name, None), P(*ls, axis_name, None)),
        out_specs=P(*ls, axis_name, None),
    )
    x = fs(yr, yi)
    s = inv_scale(norm, n0) * inv_scale(norm, n1)
    if s != 1.0:
        x = x * s
    return x


_rfft2_sharded_jit = jax.jit(_rfft2_sharded_pair,
                             static_argnums=(1, 2, 3, 4))
_irfft2_sharded_jit = jax.jit(_irfft2_sharded_pair,
                              static_argnums=(2, 3, 4, 5, 6))


def rfft2_sharded_split(x, mesh: Mesh, axis_name: str = "data",
                        norm: str = DEFAULT_NORM,
                        batch_axis_name: str | None = None):
    """Sharded 2-D real FFT: real rows sharded over the mesh in, packed
    split (re, im) half-spectrum out, sharded the same way."""
    return _rfft2_sharded_jit(x, mesh, axis_name, check_norm(norm),
                              batch_axis_name)


def irfft2_sharded_split(yr, yi, n1: int, mesh: Mesh,
                         axis_name: str = "data", norm: str = DEFAULT_NORM,
                         batch_axis_name: str | None = None):
    """Inverse sharded 2-D real FFT; ``n1`` is the real row length."""
    return _irfft2_sharded_jit(yr, yi, int(n1), mesh, axis_name,
                               check_norm(norm), batch_axis_name)


def rfft2_sharded(x, mesh: Mesh, axis_name: str = "data",
                  norm: str = DEFAULT_NORM,
                  batch_axis_name: str | None = None):
    """Complex-dtype convenience wrapper over rfft2_sharded_split."""
    yr, yi = rfft2_sharded_split(x, mesh, axis_name, norm,
                                 batch_axis_name)
    return yr + 1j * yi


def irfft2_sharded(y, n1: int, mesh: Mesh, axis_name: str = "data",
                   norm: str = DEFAULT_NORM,
                   batch_axis_name: str | None = None):
    y = jnp.asarray(y)
    return irfft2_sharded_split(jnp.real(y), jnp.imag(y), n1, mesh,
                                axis_name, norm, batch_axis_name)
