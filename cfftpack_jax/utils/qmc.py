"""Quasi-Monte-Carlo utilities: inverse normal CDF, Halton, BS formula.

Vectorized re-designs of the reference's scalar helpers
(test/util.c): Acklam's inverse-normal approximation with one Halley
refinement (util.c:55-105), the Halton sequence over the first 512
primes (util.c:108-168), and the Black-Scholes closed form
(util.c:171-180).  The reference's xorshift PRNG is replaced by
jax.random (counter-based, reproducible, splittable) — the idiomatic
accelerator RNG.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["normal_cdf", "normal_icdf", "halton", "halton_batch", "primes",
           "black_scholes_option"]


def normal_cdf(x):
    x = jnp.asarray(x)
    return 0.5 * (1.0 + jax_erf(x / np.sqrt(2.0)))


def jax_erf(x):
    import jax
    return jax.scipy.special.erf(x)


# Acklam's rational approximations (coefficients are published constants)
_A = (-3.969683028665376e+01, 2.209460984245205e+02,
      -2.759285104469687e+02, 1.383577518672690e+02,
      -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02,
      -1.556989798598866e+02, 6.680131188771972e+01,
      -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01,
      -2.400758277161838e+00, -2.549732539343734e+00,
      4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01,
      2.445134137142996e+00, 3.754408661907416e+00)


def _poly(coefs, t):
    acc = coefs[0]
    for c in coefs[1:]:
        acc = acc * t + c
    return acc


def normal_icdf(p):
    """Inverse standard normal CDF: Acklam + one Halley step.

    Vectorized (branch-free via where) version of util.c:55-105;
    |abs error| < ~1e-15 after refinement.
    """
    p = jnp.asarray(p)
    q = jnp.minimum(p, 1.0 - p)
    qc = jnp.clip(q, 1e-300, 0.5)
    # central region
    u_ = qc - 0.5
    t_ = u_ * u_
    central = u_ * _poly(_A, t_) / (_poly(_B, t_) * t_ + 1.0)
    # tail region
    t2 = jnp.sqrt(-2.0 * jnp.log(qc))
    tail = _poly(_C, t2) / (_poly(_D, t2) * t2 + 1.0)
    u = jnp.where(qc > 0.02425, central, tail)
    # one Halley refinement to machine precision
    err = normal_cdf(u) - qc
    f_over_df = err * float(np.sqrt(2.0 * np.pi)) * jnp.exp(u * u / 2.0)
    u = u - f_over_df / (1.0 + u * f_over_df / 2.0)
    u = jnp.where(p > 0.5, -u, u)
    u = jnp.where(p <= 0.0, -jnp.inf, u)
    u = jnp.where(p >= 1.0, jnp.inf, u)
    return u


def primes(k: int) -> np.ndarray:
    """First k primes (sieve; the reference hardcodes 512,
    util.c:110-137)."""
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    # upper bound via p_k < k (ln k + ln ln k) for k >= 6
    n = 15 if k < 6 else int(k * (np.log(k) + np.log(np.log(k))) + 3)
    sieve = np.ones(n + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(n ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p:: p] = False
    return np.flatnonzero(sieve)[:k].astype(np.int64)


def halton(index, dimensions: int) -> np.ndarray:
    """Halton points for the given index/indices (radical inverse per
    prime base).  ``index`` scalar -> (dimensions,); array (B,) ->
    (B, dimensions).  Host-side numpy (sequence generation is setup
    work, the transform of the points is the device part) — matches
    util.c:147-168 semantics with any dimension count."""
    idx = np.atleast_1d(np.asarray(index, dtype=np.int64))
    ps = primes(dimensions)
    out = np.zeros((idx.size, dimensions))
    for d in range(dimensions):
        b = int(ps[d])
        k = idx.copy()
        f = 1.0
        h = np.zeros(idx.size)
        while np.any(k > 0):
            f /= b
            h += (k % b) * f
            k //= b
        out[:, d] = h
    if np.isscalar(index) or np.ndim(index) == 0:
        return out[0]
    return out


def _halton_tables(dimensions: int, nd: int):
    """Host (nd, dimensions) tables: base powers b^j (clamped once they
    exceed any representable index — those digits are always 0 and get
    weight 0) and radical-inverse weights b^-(j+1)."""
    b = primes(dimensions).astype(np.int64)[None, :]
    j = np.arange(nd, dtype=np.int64)[:, None]
    with np.errstate(over="ignore"):
        bp = b.astype(np.float64) ** j
    w = 1.0 / (bp * b)
    dead = bp > 2 ** 30
    bpi = np.where(dead, 2 ** 30, bp).astype(np.int32)
    w = np.where(dead, 0.0, w)
    return bpi, b.astype(np.int32), w


def _halton_device(start, count: int, dimensions: int, nd: int, dtype,
                   exact: bool = False):
    """Traceable radical-inverse block; see ``halton_batch``.

    Digit j of index i in base b is (i // b^j) % b — every (path,
    dimension, digit) triple is independent, so the whole block is ONE
    broadcast elementwise op reduced over the digit axis (the
    reference extracts digits with a sequential per-point while loop,
    util.c:147-168).  Two digit-extraction idioms:

    * float path (default): q_j = floor(i * (1/b^j)) in f32 with a
      one-step floor fixup, digit_j = q_j - b*q_{j+1}.  All quantities
      are integers < 2^24 so every f32 product/difference is exact and
      the pre-fixup quotient is off by at most 1 (|i*r - i/b^j| <= 1
      for i < 2^24).  This formulation is pure f32 mul/floor/select,
      with no integer divide.
    * exact path (``exact=True``, and the one used for f64): int32
      divide/mod — any int32 index, no 2^24 cap.
    """
    dtype = jnp.dtype(dtype)
    bpi, b, w = _halton_tables(dimensions, nd)
    idx = start + jnp.arange(count, dtype=jnp.int32)
    if exact or dtype == jnp.float64:
        digits = (idx[:, None, None] // jnp.asarray(bpi)) % jnp.asarray(b)
        return jnp.sum(digits.astype(dtype) * jnp.asarray(w, dtype=dtype),
                       axis=1)
    # ---- f32 reciprocal path: power tables at levels j = 0..nd
    b64 = primes(dimensions).astype(np.float64)[None, :]
    bp64 = b64 ** np.arange(nd + 1, dtype=np.float64)[:, None]
    r = jnp.asarray((1.0 / bp64).astype(np.float32))          # (nd+1, d)
    # clamp for the fixup compare only: rows with b^j > index range
    # always yield q=0, rem=i < 2^24 < clamp
    bpf = jnp.asarray(np.minimum(bp64, 2.0 ** 30).astype(np.float32))
    bf = jnp.asarray(b.astype(np.float32))                    # (1, d)
    wf = jnp.asarray(w.astype(np.float32))                    # (nd, d)
    fi = idx.astype(jnp.float32)[:, None, None]               # (B, 1, 1)
    q = jnp.floor(fi * r)                                     # (B, nd+1, d)
    rem = fi - q * bpf
    q = q + jnp.where(rem >= bpf, 1.0, 0.0) - jnp.where(rem < 0, 1.0, 0.0)
    digits = q[:, :-1, :] - bf[None] * q[:, 1:, :]
    return jnp.sum(digits * wf, axis=1).astype(dtype)


_halton_jit = None  # created on first use (keeps jax import lazy-ish)


def _get_halton_jit():
    global _halton_jit
    if _halton_jit is None:
        import jax
        _halton_jit = jax.jit(_halton_device, static_argnums=(1, 2, 3, 4, 5))
    return _halton_jit


def halton_batch(start_index: int, count: int, dimensions: int,
                 dtype=jnp.float32):
    """Device-side Halton block: points ``start_index .. start_index+
    count-1`` as a ``(count, dimensions)`` array, entirely on device.

    The radical inverse per prime base (util.c:147-168) runs as one
    broadcast-reduce over a (count, digits, dimensions) grid — every
    (path, digit, dimension) triple is independent (see
    ``_halton_device`` for the two digit-extraction idioms and their
    measured costs).  The digit count ``nd`` is the base-2 digit count
    of the largest index (larger bases exhaust their digits earlier
    and then contribute zeros); it is rounded up to the next multiple
    of 8 so consecutive blocks of a growing sweep reuse one
    compilation.
    Setup (`halton`) stays host-side numpy; this one is for jitted
    in-pipeline generation at Monte-Carlo scale — compose freely under
    an outer jit via ``_halton_device``.
    """
    if count <= 0:
        return jnp.zeros((0, dimensions), dtype=dtype)
    last = int(start_index) + int(count) - 1
    if last >= 1 << 31:
        raise ValueError(
            f"halton_batch: last index {last} >= 2**31 overflows the "
            "device int32 index arithmetic (split the sweep into "
            "blocks below 2**31)")
    nd = max(1, int(np.floor(np.log2(max(last, 1)))) + 1)
    nd = (nd + 7) // 8 * 8
    exact = last >= 1 << 24   # f32 reciprocal path is exact below 2^24
    return _get_halton_jit()(jnp.int32(start_index), int(count),
                             int(dimensions), nd, jnp.dtype(dtype).name,
                             exact)


def black_scholes_option(S, K, sigma, t, r, is_call=True):
    """Black-Scholes closed form (util.c:171-180), vectorized.

    Computed at f64 when x64 is enabled; silently f32 otherwise (the
    unconditional f64 request warned on every call in f32-only
    processes, e.g. the multichip dry-run)."""
    wide = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    S = jnp.asarray(S, dtype=wide)
    K = jnp.asarray(K, dtype=wide)
    t = jnp.asarray(t, dtype=wide)   # vectorized over t and r too
    r = jnp.asarray(r, dtype=wide)
    sqt = jnp.sqrt(t)
    df = jnp.exp(-r * t)
    d1 = (jnp.log(S / K) + t * (r + sigma * sigma * 0.5)) / (sigma * sqt)
    d2 = d1 - sigma * sqt
    C = S * normal_cdf(d1) - K * normal_cdf(d2) * df
    if is_call:
        return C
    return C - S + K * df
