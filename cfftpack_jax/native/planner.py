"""ctypes loader for the native C++ planner (libplancore.so).

Build with ``python -m cfftpack_jax.native.build``.  All entry points
have pure-Python fallbacks in cfftpack_jax.plan; this module reports
availability and wraps the C ABI.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(__file__), "libplancore.so")
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            lib.cft_factor.restype = ctypes.c_int
            lib.cft_factor.argtypes = [ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_long),
                                       ctypes.c_int]
            for name in ("cft_next_fast_size", "cft_next_fast_even_size",
                         "cft_next_fast_size_2nm1", "cft_next_fast_size_2np1",
                         "cft_max_prime_factor"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_long
                fn.argtypes = [ctypes.c_long]
            lib.cft_stage_twiddles.restype = ctypes.c_long
            lib.cft_stage_twiddles.argtypes = [
                ctypes.c_long, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_long]
            lib.cft_bluestein_chirp.restype = ctypes.c_long
            lib.cft_bluestein_chirp.argtypes = [
                ctypes.c_long, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double)]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def factor(n: int) -> list[int]:
    lib = _load()
    buf = (ctypes.c_long * 64)()
    cnt = lib.cft_factor(n, buf, 64)
    if cnt < 0:
        raise ValueError(f"native factor failed for n={n}")
    return [buf[i] for i in range(cnt)]


def next_fast_size(n: int) -> int:
    return int(_load().cft_next_fast_size(n))


def next_fast_even_size(n: int) -> int:
    return int(_load().cft_next_fast_even_size(n))


def next_fast_size_2nm1(n: int) -> int:
    return int(_load().cft_next_fast_size_2nm1(n))


def next_fast_size_2np1(n: int) -> int:
    return int(_load().cft_next_fast_size_2np1(n))


def max_prime_factor(n: int) -> int:
    return int(_load().cft_max_prime_factor(n))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def stage_twiddles_flat(n: int) -> np.ndarray:
    """All-stage twiddles as one complex128 array (stage-concatenated,
    each stage p*(m/p) == sub-length elements)."""
    lib = _load()
    nf = len(factor(n))
    cap = n * max(nf, 1)
    re = np.empty(cap)
    im = np.empty(cap)
    w = lib.cft_stage_twiddles(n, _dptr(re), _dptr(im), cap)
    if w < 0:
        raise ValueError(f"native twiddle fill failed for n={n}")
    return re[:w] + 1j * im[:w]


def bluestein_chirp(n: int) -> np.ndarray:
    lib = _load()
    re = np.empty(n)
    im = np.empty(n)
    if lib.cft_bluestein_chirp(n, _dptr(re), _dptr(im)) < 0:
        raise ValueError(f"native chirp fill failed for n={n}")
    return re + 1j * im
