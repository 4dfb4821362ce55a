"""Batch-sharded double-float (hp) transforms: f64-class accuracy from
f32 arithmetic on a device mesh.

The df quad planes (re_hi, re_lo, im_hi, im_lo) shard over the mesh
batch axis exactly like the f32 planes in parallel/batch.py — per-row
transforms need NO cross-chip communication, so the hp engine's
device programs run unchanged on each shard (GSPMD propagates the
committed input sharding through hp's jits).  Host f64 in/out, same
contract as ops.hp.

Reference analog: the batched m-drivers are double-precision C
(cmfm1f_, fftpack.c:5262-5365); this is that capability sharded.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_NORM, check_norm, fwd_scale, inv_scale
from ..ops import hp
from ..ops.df64 import df_split_host, df_merge_host

__all__ = ["pfft_hp", "pifft_hp", "prfft_hp"]


def _quad_sharded(parts, mesh: Mesh, axis: str):
    spec = NamedSharding(mesh, P(axis, *([None] * (parts[0].ndim - 1))))
    return tuple(jax.device_put(jnp.asarray(v), spec) for v in parts)


def _pfft_hp(x, mesh: Mesh, axis: str, inverse: bool, norm: str):
    x = np.asarray(x)
    if x.ndim < 2:
        raise ValueError("pfft_hp: need a batch axis to shard")
    n = x.shape[-1]
    if x.shape[0] % mesh.shape[axis]:
        raise ValueError(
            f"pfft_hp: batch {x.shape[0]} must be divisible by the "
            f"mesh axis {axis!r} size {mesh.shape[axis]}")
    Rh, Rl = df_split_host(np.asarray(x.real, dtype=np.float64))
    Ih, Il = df_split_host(np.asarray(x.imag, dtype=np.float64))
    quad = _quad_sharded((Rh, Rl, Ih, Il), mesh, axis)
    out = hp.sfft_hp(*quad, n, inverse)
    rh, rl, ih, il = (np.asarray(a) for a in out)
    y = df_merge_host(rh, rl) + 1j * df_merge_host(ih, il)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    return y * np.float64(s) if s != 1.0 else y


def pfft_hp(x, mesh: Mesh, axis: str = "data", norm: str = DEFAULT_NORM):
    """Batch-sharded forward FFT at double-float precision (host
    complex128 in/out; any length)."""
    return _pfft_hp(x, mesh, axis, False, check_norm(norm))


def pifft_hp(y, mesh: Mesh, axis: str = "data", norm: str = DEFAULT_NORM):
    return _pfft_hp(y, mesh, axis, True, check_norm(norm))


def prfft_hp(x, mesh: Mesh, axis: str = "data", norm: str = DEFAULT_NORM):
    """Batch-sharded real FFT at double-float precision: host f64 real
    in, packed (n//2+1) complex128 out."""
    norm = check_norm(norm)
    x = np.asarray(x, dtype=np.float64)
    if x.ndim < 2:
        raise ValueError("prfft_hp: need a batch axis to shard")
    n = x.shape[-1]
    if x.shape[0] % mesh.shape[axis]:
        raise ValueError(
            f"prfft_hp: batch {x.shape[0]} must be divisible by the "
            f"mesh axis {axis!r} size {mesh.shape[axis]}")
    xh, xl = df_split_host(x)
    xh, xl = _quad_sharded((xh, xl), mesh, axis)
    rh, rl, ih, il = (np.asarray(a) for a in
                      hp._srfft_hp_jit(xh, xl, n, hp._on_cpu(xh)))
    y = df_merge_host(rh, rl) + 1j * df_merge_host(ih, il)
    s = fwd_scale(norm, n)
    return y * np.float64(s) if s != 1.0 else y
