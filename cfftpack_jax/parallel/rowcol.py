"""Generic sharded row-column driver: any separable 2-D transform.

Generalizes fft2d.py's pattern: apply a 1-D last-axis transform to the
rows locally, all-to-all transpose over the mesh, transform the
columns, transpose back.  Because DCT/DST are real->real, the
collectives move real arrays.

This is the distributed analog of the reference's batched-cosqm 2-D DCT
(dct_2d, cfftextra.c:306-395) for arbitrarily large images.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.dct import _dct_impl, _dst_impl
from ..config import check_norm, DEFAULT_NORM

__all__ = ["rowcol2d_sharded", "dctn2_sharded", "idctn2_sharded",
           "dstn2_sharded", "idstn2_sharded"]


def _core(blk, row_fn, col_fn, axis_name):
    a = row_fn(blk)                                # rows (local)
    a = jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 1,
                           concat_axis=a.ndim - 2, tiled=True)
    a = jnp.swapaxes(a, -1, -2)
    a = col_fn(a)                                  # columns (local)
    a = jnp.swapaxes(a, -1, -2)
    a = jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 2,
                           concat_axis=a.ndim - 1, tiled=True)
    return a


def _rowcol_impl(x, mesh, row_fn, col_fn, axis_name, batch_axis_name):
    x = jnp.asarray(x)
    n0, n1 = x.shape[-2], x.shape[-1]
    d = mesh.shape[axis_name]
    if n0 % d or n1 % d:
        raise ValueError(f"2-D shape ({n0},{n1}) must be divisible by mesh size {d}")
    lead = x.ndim - 2
    ls = [None] * lead
    if batch_axis_name is not None and lead:
        ls[0] = batch_axis_name
    fs = shard_map(
        partial(_core, row_fn=row_fn, col_fn=col_fn, axis_name=axis_name),
        mesh=mesh,
        in_specs=P(*ls, axis_name, None),
        out_specs=P(*ls, axis_name, None),
    )
    return fs(x)


# jit-wrapped entry (see fourstep.py: eager shard_map is 30-60x slower
# than the compiled program and misses the persistent cache).  row_fn /
# col_fn are static: pass stable callables (the DCT/DST wrappers below
# memoize theirs) or each new function object retraces.
_rowcol_jit = jax.jit(_rowcol_impl, static_argnums=(1, 2, 3, 4, 5))


def rowcol2d_sharded(x, mesh: Mesh, row_fn, col_fn=None,
                     axis_name: str = "data",
                     batch_axis_name: str | None = None):
    """Apply last-axis transforms to both trailing axes of ``x`` with
    the rows sharded over ``mesh[axis_name]``.

    ``row_fn``/``col_fn`` take and return an array, transforming the
    LAST axis (col_fn defaults to row_fn).  Output sharding == input
    sharding (rows over the mesh).
    """
    col_fn = row_fn if col_fn is None else col_fn
    return _rowcol_jit(x, mesh, row_fn, col_fn, axis_name,
                       batch_axis_name)


@lru_cache(maxsize=None)
def _trig_fn(is_dst: bool, t: int, nm: str, inverse: bool):
    impl = _dst_impl if is_dst else _dct_impl
    return partial(impl, t=t, axis=-1, norm=nm, inverse=inverse)


def dctn2_sharded(x, mesh: Mesh, type: int = 3, norm: str = DEFAULT_NORM,
                  axis_name: str = "data",
                  batch_axis_name: str | None = None):
    """Sharded 2-D DCT over the trailing axes (type 3 == the reference's
    dct_2d_forward convention)."""
    fn = _trig_fn(False, int(type), check_norm(norm), False)
    return rowcol2d_sharded(x, mesh, fn, axis_name=axis_name,
                            batch_axis_name=batch_axis_name)


def idctn2_sharded(x, mesh: Mesh, type: int = 3, norm: str = DEFAULT_NORM,
                   axis_name: str = "data",
                   batch_axis_name: str | None = None):
    fn = _trig_fn(False, int(type), check_norm(norm), True)
    return rowcol2d_sharded(x, mesh, fn, axis_name=axis_name,
                            batch_axis_name=batch_axis_name)


def dstn2_sharded(x, mesh: Mesh, type: int = 3, norm: str = DEFAULT_NORM,
                  axis_name: str = "data",
                  batch_axis_name: str | None = None):
    fn = _trig_fn(True, int(type), check_norm(norm), False)
    return rowcol2d_sharded(x, mesh, fn, axis_name=axis_name,
                            batch_axis_name=batch_axis_name)


def idstn2_sharded(x, mesh: Mesh, type: int = 3, norm: str = DEFAULT_NORM,
                   axis_name: str = "data",
                   batch_axis_name: str | None = None):
    fn = _trig_fn(True, int(type), check_norm(norm), True)
    return rowcol2d_sharded(x, mesh, fn, axis_name=axis_name,
                            batch_axis_name=batch_axis_name)
