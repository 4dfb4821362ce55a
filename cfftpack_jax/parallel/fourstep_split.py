"""Split-real distributed four-step FFT.

Same algorithm as fourstep.py (see its docstring for the schedule and
index math) but on (re, im) pairs of real arrays.
Twiddles are computed with real trig inside the shard; collectives move
real arrays only.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULT_NORM, check_norm, fwd_scale, inv_scale
from ..ops import core
from .fourstep import _split, _lead_spec

__all__ = ["fft_fourstep_split", "ifft_fourstep_split"]


def _core_pair(xr2, xi2, n1, n2, inverse, axis_name):
    sign = 1.0 if inverse else -1.0
    idx = jax.lax.axis_index(axis_name)
    d = jax.lax.psum(1, axis_name)
    n = n1 * n2
    loc = n2 // d
    ar = jnp.swapaxes(xr2, -1, -2)                 # (..., N2/D, N1)
    ai = jnp.swapaxes(xi2, -1, -2)
    ar, ai = core.sfft(ar, ai, n1, inverse)
    n2g = (idx * loc + jnp.arange(loc))[:, None].astype(ar.dtype)
    k1 = jnp.arange(n1)[None, :].astype(ar.dtype)
    ang = (sign * 2.0 * np.pi / n) * (n2g * k1)
    twr = jnp.cos(ang)
    twi = jnp.sin(ang)
    vr = ar * twr - ai * twi
    vi = ar * twi + ai * twr
    vr = jax.lax.all_to_all(vr, axis_name, split_axis=vr.ndim - 1,
                            concat_axis=vr.ndim - 2, tiled=True)
    vi = jax.lax.all_to_all(vi, axis_name, split_axis=vi.ndim - 1,
                            concat_axis=vi.ndim - 2, tiled=True)
    vr = jnp.swapaxes(vr, -1, -2)                  # (..., N1/D, N2)
    vi = jnp.swapaxes(vi, -1, -2)
    return core.sfft(vr, vi, n2, inverse)


def _fourstep_pair(xr, xi, mesh, axis_name, inverse, norm, reorder,
                   batch_axis_name):
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    n = xr.shape[-1]
    d = mesh.shape[axis_name]
    n1, n2 = _split(n, d)
    lead = xr.shape[:-1]
    xr2 = xr.reshape(lead + (n1, n2))
    xi2 = xi.reshape(lead + (n1, n2))
    ls = _lead_spec(len(lead), batch_axis_name)
    fs = shard_map(
        partial(_core_pair, n1=n1, n2=n2, inverse=inverse,
                axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(*ls, None, axis_name), P(*ls, None, axis_name)),
        out_specs=(P(*ls, axis_name, None), P(*ls, axis_name, None)),
    )
    yr2, yi2 = fs(xr2, xi2)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        yr2 = yr2 * s
        yi2 = yi2 * s
    if reorder:
        yr = jnp.swapaxes(yr2, -1, -2).reshape(lead + (n,))
        yi = jnp.swapaxes(yi2, -1, -2).reshape(lead + (n,))
        return yr, yi
    return yr2, yi2


def _ifourstep_pair(yr, yi, mesh, axis_name, norm, reordered,
                    batch_axis_name):
    yr = jnp.asarray(yr)
    yi = jnp.asarray(yi)
    if reordered:
        n = yr.shape[-1]
        d = mesh.shape[axis_name]
        n1, n2 = _split(n, d)
        yr2 = jnp.swapaxes(yr.reshape(yr.shape[:-1] + (n2, n1)), -1, -2)
        yi2 = jnp.swapaxes(yi.reshape(yi.shape[:-1] + (n2, n1)), -1, -2)
    else:
        yr2, yi2 = yr, yi
        n1, n2 = yr2.shape[-2], yr2.shape[-1]
        n = n1 * n2
    lead = yr2.shape[:-2]
    zr = jnp.swapaxes(yr2, -1, -2)
    zi = jnp.swapaxes(yi2, -1, -2)
    ls = _lead_spec(len(lead), batch_axis_name)
    fs = shard_map(
        partial(_core_pair, n1=n2, n2=n1, inverse=True,
                axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(*ls, None, axis_name), P(*ls, None, axis_name)),
        out_specs=(P(*ls, axis_name, None), P(*ls, axis_name, None)),
    )
    xr2, xi2 = fs(zr, zi)
    s = inv_scale(norm, n)
    if s != 1.0:
        xr2 = xr2 * s
        xi2 = xi2 * s
    xr = jnp.swapaxes(xr2, -1, -2).reshape(lead + (n,))
    xi = jnp.swapaxes(xi2, -1, -2).reshape(lead + (n,))
    return xr, xi


# jit-wrapped entries (see fourstep.py: eager shard_map is 30-60x
# slower than the compiled program and misses the persistent cache)
_fourstep_pair_jit = jax.jit(_fourstep_pair,
                             static_argnums=(2, 3, 4, 5, 6, 7))
_ifourstep_pair_jit = jax.jit(_ifourstep_pair,
                              static_argnums=(2, 3, 4, 5, 6))


def fft_fourstep_split(xr, xi, mesh: Mesh, axis_name: str = "data",
                       norm: str = DEFAULT_NORM, reorder: bool = True,
                       batch_axis_name: str | None = None):
    """Forward four-step FFT on an (re, im) pair, length sharded."""
    return _fourstep_pair_jit(xr, xi, mesh, axis_name, False,
                              check_norm(norm), bool(reorder),
                              batch_axis_name)


def ifft_fourstep_split(yr, yi, mesh: Mesh, axis_name: str = "data",
                        norm: str = DEFAULT_NORM, reordered: bool = True,
                        batch_axis_name: str | None = None):
    """Inverse of :func:`fft_fourstep_split` (mirrored schedule)."""
    return _ifourstep_pair_jit(yr, yi, mesh, axis_name, check_norm(norm),
                               bool(reordered), batch_axis_name)
