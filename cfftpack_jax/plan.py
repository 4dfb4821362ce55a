"""Transform planning: factorization, twiddle tables, fast sizes.

Analog of the reference's plan machinery:

* ``factor`` mirrors the *behavior* of FFTPACK's greedy factorization
  (``factor_``, cfftpack/fftpack.c:6613-6657): radices
  4, 2, 3, 5 first, then ascending odd trial factors.
* ``stage_twiddles`` plays the role of the ``wsave`` twiddle tables
  (``tables_``, fftpack.c:15124-15166) but is laid out per Stockham
  stage as dense (p, m/p) arrays — the layout a vectorized pass
  consumes directly.
* ``fft_next_fast_size`` & friends mirror cfftextra.c:20-82.

Plans here are plain data (tuples + numpy arrays) computed once per
(n,) on the host in float64 and closed over by jitted callables — the
create-once/use-many analog of ``fft_create``/``fft_t``
(cfftpack.c:10-31).

If the native C++ planner extension is built (cfftpack_jax/native),
factorization and fast-size search are delegated to it.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

# Largest prime factor handled by a direct in-line DFT stage (the analog of
# the reference's generic-radix kernel c1fgkf_, fftpack.c:1650-1922, which is
# O(p^2) per point).  Beyond this we switch to Bluestein's chirp-z algorithm,
# which the reference does NOT have (it degrades to O(n^2); cfftextra.h:24-28).
MAX_DIRECT_RADIX = 32


def _factor_py(n: int) -> tuple[int, ...]:
    """Greedy factorization into radices (4,2,3,5, then odd primes)."""
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    fac = []
    while n % 4 == 0:
        fac.append(4)
        n //= 4
    for p in (2, 3, 5):
        while n % p == 0:
            fac.append(p)
            n //= p
    p = 7
    while n > 1:
        while n % p == 0:
            fac.append(p)
            n //= p
        p += 2
        if p * p > n and n > 1:
            fac.append(n)
            break
    return tuple(fac)


def _try_native():
    try:
        from .native import planner as _np_mod  # noqa: PLC0415
        return _np_mod if _np_mod.available() else None
    except Exception:
        return None


_NATIVE = None
_NATIVE_CHECKED = False


def _native():
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        _NATIVE = _try_native()
        _NATIVE_CHECKED = True
    return _NATIVE


@functools.lru_cache(maxsize=4096)
def factor(n: int) -> tuple[int, ...]:
    nat = _native()
    if nat is not None:
        return tuple(nat.factor(n))
    return _factor_py(n)


def max_prime_factor(n: int) -> int:
    return max(factor(n)) if n > 1 else 1


def is_smooth(n: int, primes: Sequence[int] = (2, 3, 5)) -> bool:
    if n < 1:
        return False
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def needs_bluestein(n: int) -> bool:
    """True when n has a prime factor too large for a direct DFT stage."""
    return n > 1 and max_prime_factor(n) > MAX_DIRECT_RADIX


def fft_next_fast_size(n: int) -> int:
    """Next 5-smooth size >= n (cfftextra.c:20-38 behavior)."""
    nat = _native()
    if nat is not None:
        return nat.next_fast_size(max(n, 2))
    n = max(n, 2)  # reference clamps to >= 2 (cfftextra.c:20-38)
    while not is_smooth(n):
        n += 1
    return n


def fft_next_fast_even_size(n: int) -> int:
    """Next even 5-smooth size >= n (for DCT-IV/DST-IV; cfftextra.c:40-46)."""
    nat = _native()
    if nat is not None:
        return nat.next_fast_even_size(max(n, 2))
    n = max(n, 2)
    if n % 2:
        n += 1
    while not is_smooth(n):
        n += 2
    return n


def fft_next_fast_size_2nm1(n: int) -> int:
    """Next n >= given such that 2n-1 is 5-smooth (cfftextra.c:48-62)."""
    nat = _native()
    if nat is not None:
        return nat.next_fast_size_2nm1(max(n, 2))
    n = max(n, 2)  # reference clamps to >= 2
    while not is_smooth(2 * n - 1):
        n += 1
    return n


def fft_next_fast_size_2np1(n: int) -> int:
    """Next n >= given such that 2n+1 is 5-smooth (cfftextra.c:64-82)."""
    nat = _native()
    if nat is not None:
        return nat.next_fast_size_2np1(max(n, 1))
    n = max(n, 1)
    while not is_smooth(2 * n + 1):
        n += 1
    return n


@functools.lru_cache(maxsize=1024)
def stage_twiddles(n: int) -> tuple[np.ndarray, ...]:
    """Per-stage Stockham twiddle tables for length ``n``.

    Stage s with radix p and remaining sub-length m (product of factors
    s..end) uses ``tw[k, j] = exp(-2j*pi*k*j/m)`` of shape (p, m//p).
    The forward transform multiplies by ``tw``; the inverse by ``conj(tw)``.
    Always computed in float64 (cast at trace time), matching the
    reference's double-precision wsave tables (tables_, fftpack.c:15124).
    """
    facs = factor(n)
    out = []
    m = n
    for p in facs:
        mn = m // p
        k = np.arange(p).reshape(p, 1)
        j = np.arange(mn).reshape(1, mn)
        out.append(np.exp((-2j * np.pi / m) * (k * j)))
        m = mn
    return tuple(out)


@functools.lru_cache(maxsize=256)
def dft_matrix(p: int) -> np.ndarray:
    """Dense p x p forward DFT matrix D[k, j] = exp(-2j*pi*k*j/p)."""
    k = np.arange(p).reshape(p, 1)
    j = np.arange(p).reshape(1, p)
    return np.exp((-2j * np.pi / p) * (k * j))


def host_fft(x: np.ndarray) -> np.ndarray:
    """Self-contained host-side (numpy, float64) unscaled forward DFT.

    Same Stockham schedule as the device path; used only for plan-time
    constant generation (e.g. the Bluestein kernel spectrum), so the
    library depends on no external FFT anywhere.
    """
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    S = x.reshape(-1, 1, n)
    L, m = 1, n
    for p, tw in zip(factor(n), stage_twiddles(n)):
        mn = m // p
        T = S.reshape(-1, L, p, mn)
        U = np.einsum("kp,blpj->blkj", dft_matrix(p), T)
        U *= tw[None, None]
        S = U.transpose(0, 2, 1, 3).reshape(-1, L * p, mn)
        L *= p
        m = mn
    return S.reshape(x.shape)


@functools.lru_cache(maxsize=512)
def bluestein_tables(n: int, m: int | None = None
                     ) -> tuple[int, np.ndarray, np.ndarray]:
    """Host-side tables for Bluestein's chirp-z FFT of length ``n``.

    Returns (m, chirp, bq) where m is the 5-smooth convolution length
    >= 2n-1 (the next fast size by default; callers may pass a larger
    valid m), chirp[j] =
    exp(-1j*pi*j^2/n) (length n), and bq is the length-m forward
    *unscaled* DFT of the circular chirp-conjugate kernel
    b[j] = exp(+1j*pi*((j mod m mapped) ^2)/n).
    """
    if m is None:
        m = fft_next_fast_size(2 * n - 1)
    elif m < 2 * n - 1 or not is_smooth(m):
        raise ValueError(f"bluestein pad m={m} must be a 5-smooth "
                         f"size >= 2n-1 = {2 * n - 1}")
    # exponent j^2 mod 2n keeps the angle exact for large n
    jsq = (np.arange(n, dtype=np.int64) ** 2) % (2 * n)
    chirp = np.exp((-1j * np.pi / n) * jsq)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(chirp)
    b[m - n + 1:] = np.conj(chirp[1:][::-1])
    bq = host_fft(b)  # host-side planning only (float64, computed once)
    return m, chirp, bq
