"""Double-float ("df64") arithmetic: ~2x-f32 precision from f32 pairs.

This module implements the classic error-free-transformation arithmetic (Dekker
1971; Knuth TwoSum; Hida/Li/Bailey double-double) on (hi, lo) pairs of
f32 arrays, giving ~1e-14 relative accuracy from pure f32 adds and
multiplies — executable wherever f32 is.

No reference analog: cfftpack gets f64 from the C `double` type
(fftpack.h:59-64 ``fft_real_t``); this is an f32-only route to that
capability, kept beside native f64 until ROADMAP D2 decides on
measured numbers.

Correctness notes:
* TwoSum/TwoProd rely on IEEE f32 rounding of each individual op.  XLA
  preserves per-op float semantics by default (no fast-math
  reassociation), so the compensation terms survive jit — asserted by
  tests/test_df64.py against f64 oracles.
* TwoProd uses Dekker splitting (no FMA dependence): exact for
  |x| < 2^115, far beyond transform magnitudes.
* Only +, -, * are needed by the FFT path; no division.
"""
from __future__ import annotations

import numpy as np

_SPLIT = np.float32((1 << 12) + 1)     # Dekker splitter for f32 (p=24)

__all__ = ["df_split_host", "df_merge_host", "df_add", "df_add_accurate",
           "df_sub", "df_mul", "df_neg"]


def df_split_host(x) -> tuple[np.ndarray, np.ndarray]:
    """Host f64 array -> (hi, lo) f32 pair (hi = round(x),
    lo = round(x - hi)).  Keeps ~48 of f64's 53 mantissa bits:
    relative representation error < 2^-45."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_merge_host(hi, lo) -> np.ndarray:
    """(hi, lo) f32 pair -> host f64 array."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo,
                                                         dtype=np.float64)


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Fast TwoSum, requires |a| >= |b|: s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (FMA-free split form)."""
    p = a * b
    aa = _SPLIT * a
    ahi = aa - (aa - a)
    alo = a - ahi
    bb = _SPLIT * b
    bhi = bb - (bb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def df_add_accurate(ahi, alo, bhi, blo):
    """(a + b) in double-float (Hida et al. accurate add, 20 flops).

    Guarantees ~2 ulp_dd error even under catastrophic cancellation of
    the low parts.  Kept for reference/A-B; the engine default is the
    11-flop df_add below — measured indistinguishable (~5e-15 rel) on
    every transform family incl. pure-cancellation inputs."""
    s, e = _two_sum(ahi, bhi)
    t, f = _two_sum(alo, blo)
    e = e + t
    s, e = _quick_two_sum(s, e)
    e = e + f
    return _quick_two_sum(s, e)


def df_add(ahi, alo, bhi, blo):
    """(a + b) in double-float (Bailey/QD "sloppy" add, 11 flops).

    The hi-part TwoSum is exact; only the low-part sum rounds once
    before renormalization, so the error stays ~2^-48 relative to the
    OPERAND magnitude (the accurate variant also bounds it relative to
    a catastrophically-cancelled RESULT, which no transform-parity
    tolerance here measures — all bars are scale-relative)."""
    s, e = _two_sum(ahi, bhi)
    e = e + (alo + blo)
    return _quick_two_sum(s, e)


def df_sub(ahi, alo, bhi, blo):
    return df_add(ahi, alo, -bhi, -blo)


def df_neg(ahi, alo):
    return -ahi, -alo


def df_mul(ahi, alo, bhi, blo):
    """(a * b) in double-float (Dekker product + cross terms)."""
    p, e = _two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return _quick_two_sum(p, e)
