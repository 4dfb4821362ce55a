"""Batch-sharded transforms: shard the leading axis, transform per-row.

The weak-scaling workhorse: each device runs the single-device engine
on its batch shard; there is NO cross-chip communication — the
semantic analog of the reference's batched m-routines (cfftmf_,
fftpack.c:2554) with lot/jump/inc replaced by a NamedSharding.
"""
from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import ops

__all__ = ["shard_batch", "pfft", "pifft", "prfft", "pirfft", "pdct"]


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """Place ``x`` with its leading axis sharded over ``mesh[axis]``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def _batched(fn, x, mesh: Mesh, axis: str, **kw):
    """jit ``fn`` with leading-axis-sharded in/out constraints.

    For per-row transforms XLA compiles this to purely local work; with
    the input already placed by :func:`shard_batch` there are no
    collectives at all (asserted by tests on an 8-device CPU mesh).
    """
    spec = NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
    f = jax.jit(partial(fn, **kw), in_shardings=spec, out_shardings=spec)
    return f(x)


def pfft(x, mesh: Mesh, axis: str = "data", **kw):
    """Batch-sharded forward complex FFT over the last array axis."""
    return _batched(ops.fft, x, mesh, axis, **kw)


def pifft(x, mesh: Mesh, axis: str = "data", **kw):
    return _batched(ops.ifft, x, mesh, axis, **kw)


def prfft(x, mesh: Mesh, axis: str = "data", **kw):
    return _batched(ops.rfft, x, mesh, axis, **kw)


def pirfft(x, n: int, mesh: Mesh, axis: str = "data", **kw):
    return _batched(partial(ops.irfft, n=n), x, mesh, axis, **kw)


def pdct(x, type: int, mesh: Mesh, axis: str = "data", **kw):
    return _batched(partial(ops.dct, type=type), x, mesh, axis, **kw)
