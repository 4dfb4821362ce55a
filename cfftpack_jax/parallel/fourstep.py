"""Distributed four-step FFT: one long transform sharded across chips.

The in-core ancestor is the reference's row-column decomposition
(cfft2f_, fftpack.c:2363-2434); distributed, the length-N transform
becomes an N1 x N2 matrix with ONE all-to-all at the transpose
(SURVEY.md §5 "long-context equivalent"):

    x[n1*N2 + n2]  laid out as  (N1, N2), n2 sharded
    1. column FFTs: length-N1 over axis 0   (local)
    2. twiddle *= exp(-2i pi n2 k1 / N)     (local)
    3. all_to_all: reshard N1, gather N2    (the global transpose)
    4. row FFTs: length-N2 over axis 1      (local)
    X[k1 + N1*k2] = out[k1, k2]             (k1 sharded)

Collectives ride the mesh axis.  The final
digit-reversed gather back to natural order is optional (``reorder``):
spectral pipelines (pointwise multiply then inverse) never need it,
matching how the reference apps use fft+ifft back-to-back.
"""
from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULT_NORM, check_norm, complex_dtype_of, fwd_scale, \
    inv_scale
from ..ops.cfft import _dft_last_axis

__all__ = ["fft_fourstep", "ifft_fourstep"]


@functools.lru_cache(maxsize=4096)
def _split(n: int, n_shards: int) -> tuple[int, int]:
    """Pick N1*N2 == n with both factors divisible by the shard count
    and as square as possible (transpose volume is minimized at
    sqrt(N)).  Divisors enumerated to sqrt(n) only and cached (the
    2^20 flagship length would otherwise scan 1M candidates per call)."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for n1 in (d, n // d):
                n2 = n // n1
                if n1 % n_shards == 0 and n2 % n_shards == 0:
                    score = abs(n1 - n2)
                    if best is None or score < best[0]:
                        best = (score, n1, n2)
        d += 1
    if best is None:
        raise ValueError(
            f"length {n} not splittable as N1*N2 with both divisible by "
            f"{n_shards} shards")
    return best[1], best[2]


def _core(x2, n1, n2, inverse, axis_name, overlap_chunks=1):
    """Per-shard body: x2 is the local (B, N1, N2/D) block.

    ``overlap_chunks > 1`` runs the transpose/compute-overlap schedule
    (SURVEY.md §7 hard part; in-core ancestor: cfft2f_'s strided second
    pass, fftpack.c:2407-2426): the k1 axis is cut into chunks, each
    chunk's all-to-all issued independently so XLA's async
    collective scheduler can hide chunk i+1's transpose behind chunk
    i's stage-4 butterflies.  Numerically identical to the unchunked
    path (same butterflies, same twiddles — only the transpose is
    tiled); perf validation needs real multi-chip hardware.
    """
    sign = 1.0 if inverse else -1.0
    idx = jax.lax.axis_index(axis_name)
    d = jax.lax.psum(1, axis_name)
    n = n1 * n2
    loc = n2 // d
    # 1. length-N1 FFTs along axis -2 (move to last axis)
    a = jnp.swapaxes(x2, -1, -2)                  # (B, N2/D, N1)
    a = _dft_last_axis(a, n1, inverse)
    # 2. twiddle: exp(sign*2i pi * n2_global * k1 / n)
    n2g = (idx * loc + jnp.arange(loc))[:, None]  # global n2 index
    k1 = jnp.arange(n1)[None, :]
    tw = jnp.exp(jnp.asarray(sign * 2j * np.pi / n, dtype=a.dtype)
                 * (n2g * k1).astype(a.real.dtype))
    a = a * tw

    def transpose_rows(block):
        # 3. all-to-all: split k1 (last axis), gather n2; 4. row FFTs
        b = jax.lax.all_to_all(block, axis_name, split_axis=block.ndim - 1,
                               concat_axis=block.ndim - 2, tiled=True)
        b = jnp.swapaxes(b, -1, -2)               # (B, k1_chunk/D, N2)
        return _dft_last_axis(b, n2, inverse)

    if overlap_chunks <= 1:
        return transpose_rows(a)                  # block [k1_local, k2]
    # Chunk i must carry the i-th SUB-SLICE of every device's k1
    # ownership range [j*N1/D, (j+1)*N1/D) — not a contiguous k1 block —
    # so each chunk's all-to-all delivers device j a piece of its OWN
    # contiguous range, and the chunk concat assembles it in order.
    c = overlap_chunks
    wdc = n1 // (c * d)
    a4 = a.reshape(a.shape[:-1] + (d, c, wdc))
    outs = [transpose_rows(
        a4[..., i, :].reshape(a.shape[:-1] + (d * wdc,)))
        for i in range(c)]
    return jnp.concatenate(outs, axis=-2)


def _lead_spec(lead_ndim: int, batch_axis_name):
    """PartitionSpec entries for leading (batch) axes: axis 0 may be
    sharded over a second mesh axis (dp x tp composition)."""
    spec = [None] * lead_ndim
    if batch_axis_name is not None and lead_ndim:
        spec[0] = batch_axis_name
    return spec


def _check_chunks(n1: int, d: int, overlap_chunks: int) -> int:
    c = int(overlap_chunks)
    if c < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {c}")
    if c > 1 and (n1 % c or (n1 // c) % d):
        raise ValueError(
            f"overlap_chunks={c}: N1={n1} must split into chunks "
            f"divisible by the {d}-way mesh axis")
    return c


def _fourstep(x, mesh, axis_name, inverse, norm, reorder, batch_axis_name,
              overlap_chunks=1):
    x = jnp.asarray(x)
    cdtype = complex_dtype_of(x.dtype)
    x = x.astype(cdtype)
    n = x.shape[-1]
    d = mesh.shape[axis_name]
    n1, n2 = _split(n, d)
    c = _check_chunks(n1, d, overlap_chunks)
    lead = x.shape[:-1]
    x2 = x.reshape(lead + (n1, n2))

    ls = _lead_spec(len(lead), batch_axis_name)
    fs = shard_map(
        partial(_core, n1=n1, n2=n2, inverse=inverse, axis_name=axis_name,
                overlap_chunks=c),
        mesh=mesh,
        in_specs=P(*ls, None, axis_name),
        out_specs=P(*ls, axis_name, None),
    )
    y2 = fs(x2)  # (..., N1, N2), X[k1 + N1*k2] = y2[..., k1, k2]
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        y2 = y2 * jnp.asarray(s, dtype=cdtype)
    if reorder:
        # natural order: transpose (k1, k2) -> flat k2-major
        y = jnp.swapaxes(y2, -1, -2).reshape(lead + (n,))
        return y
    return y2


def _ifourstep(y, mesh, axis_name, norm, reordered, batch_axis_name,
               overlap_chunks=1):
    y = jnp.asarray(y)
    if reordered:
        n = y.shape[-1]
        d = mesh.shape[axis_name]
        n1, n2 = _split(n, d)
        y2 = y.reshape(y.shape[:-1] + (n2, n1))
        y2 = jnp.swapaxes(y2, -1, -2)
    else:
        y2 = y
        n1, n2 = y2.shape[-2], y2.shape[-1]
        n = n1 * n2
    lead = y2.shape[:-2]
    c = _check_chunks(n2, mesh.shape[axis_name], overlap_chunks)
    # mirrored schedule: treat the forward OUTPUT layout (k1, k2) as the
    # four-step input of the inverse transform with roles of (N1, N2)
    # swapped: Z[m2*N1... ] — concretely, run _core on the transposed
    # block with (n1', n2') = (n2, n1).
    z2 = jnp.swapaxes(y2, -1, -2)  # (..., k2=N2, k1=N1)
    ls = _lead_spec(len(lead), batch_axis_name)
    fs = shard_map(
        partial(_core, n1=n2, n2=n1, inverse=True, axis_name=axis_name,
                overlap_chunks=c),
        mesh=mesh,
        in_specs=P(*ls, None, axis_name),
        out_specs=P(*ls, axis_name, None),
    )
    x2 = fs(z2)  # (..., N2, N1): x[m1 + N2*m2]?? -> natural via transpose
    s = inv_scale(norm, n)
    if s != 1.0:
        x2 = x2 * jnp.asarray(s, dtype=x2.dtype)
    x = jnp.swapaxes(x2, -1, -2).reshape(lead + (n,))
    return x


# Entry points are jit-wrapped with everything but the operand static:
# an eager shard_map call dispatches the body op-by-op across all local
# devices (measured 30-60x slower than the compiled program on a
# 4-device CPU mesh) and misses the persistent compile cache.
_fourstep_jit = jax.jit(_fourstep, static_argnums=(1, 2, 3, 4, 5, 6, 7))
_ifourstep_jit = jax.jit(_ifourstep, static_argnums=(1, 2, 3, 4, 5, 6))


def fft_fourstep(x, mesh: Mesh, axis_name: str = "data",
                 norm: str = DEFAULT_NORM, reorder: bool = True,
                 batch_axis_name: str | None = None,
                 overlap_chunks: int = 1):
    """Forward FFT over the last axis, length sharded across the mesh.

    ``reorder=False`` returns the (N1, N2) four-step layout (k1 sharded)
    — compose with :func:`ifft_fourstep` (``reordered=False``) for
    transform->pointwise->inverse pipelines with zero extra transposes.

    ``overlap_chunks=C`` (C > 1) tiles the transpose into C
    independent all-to-all + row-FFT chains so the collective of one
    chunk can hide behind another's butterflies (double-buffering).
    Bit-identical results; requires N1 % (C*D) == 0.
    """
    return _fourstep_jit(x, mesh, axis_name, False, check_norm(norm),
                         bool(reorder), batch_axis_name, int(overlap_chunks))


def ifft_fourstep(y, mesh: Mesh, axis_name: str = "data",
                  norm: str = DEFAULT_NORM, reordered: bool = True,
                  batch_axis_name: str | None = None,
                  overlap_chunks: int = 1):
    """Inverse of :func:`fft_fourstep`.

    With ``reordered=False`` the input is the (N1, N2) four-step layout
    as produced by ``fft_fourstep(..., reorder=False)``; the inverse
    runs the mirrored schedule so the composition is exact.
    ``overlap_chunks`` as in :func:`fft_fourstep`.
    """
    return _ifourstep_jit(y, mesh, axis_name, check_norm(norm),
                          bool(reordered), batch_axis_name,
                          int(overlap_chunks))
